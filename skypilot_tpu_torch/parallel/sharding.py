"""The ambient sequence-parallel context: the port's stand-in for the
reference's `use_mesh` (skypilot_tpu/parallel/sharding.py) on the `sp`
axis, where the batch's 'seq' dimension maps to 'sp' (`:22`).

`flash_attention(impl='ring')` reads it the way the reference's
`ring_attention_ambient` reads the ambient mesh, and raises without it,
as the reference does without an `sp` mesh. Two forms:
- `use_sequence_parallel(sp=N)`: one process holds the whole sequence and
  runs the N ring positions in turn (ops/ring_attention
  `ring_attention_sharded`);
- `use_sequence_parallel(group=g)`: each process of the torch.distributed
  group `g` holds one chunk (ops/ring_attention `ring_attention`).

The context is process-wide, not per thread: autograd runs a CUDA
backward on its own device thread, and that is where checkpointed (remat)
layers run their forward again.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class SequenceParallel:
    """sp ring positions; `group` set: one per process of that group."""
    sp: int
    group: Any = None

    @property
    def rank(self) -> int:
        """This process's ring position (0 in the one-process form)."""
        return dist.get_rank(self.group) if self.group is not None else 0


def sequence_parallel(sp: Optional[int] = None, *,
                      group=None) -> SequenceParallel:
    """A validated context: exactly one of `sp` (one process) or `group`
    (one rank per process; sp is the group's size)."""
    if (sp is None) == (group is None):
        raise ValueError('give exactly one of sp (one process) or group '
                         '(one rank per process)')
    if group is not None:
        if not dist.is_initialized():
            raise RuntimeError('a sequence-parallel group needs '
                               'torch.distributed to be initialized')
        return SequenceParallel(dist.get_world_size(group), group)
    if sp < 1:
        raise ValueError(f'sp must be >= 1, got {sp}')
    return SequenceParallel(sp)


_ACTIVE: Optional[SequenceParallel] = None


@contextlib.contextmanager
def use_sequence_parallel(sp: Optional[int] = None, *,
                          group=None) -> Iterator[SequenceParallel]:
    """Enter the sp context for the block; the one before it comes back
    on exit."""
    global _ACTIVE
    ctx = sequence_parallel(sp, group=group)
    outer, _ACTIVE = _ACTIVE, ctx
    try:
        yield ctx
    finally:
        _ACTIVE = outer


def current_sequence_parallel() -> Optional[SequenceParallel]:
    """The active context, or None."""
    return _ACTIVE
