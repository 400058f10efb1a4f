"""Sharding rules of the port: the ambient sequence-parallel context, the
tensor-parallel rules over the model's parameters and ZeRO-1's split of
the optimizer state over `dp`.

The ambient sequence-parallel context is the port's stand-in for the
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
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
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


# ---------------- tensor parallelism ----------------
#
# The reference's logical-axis rules (skypilot_tpu/parallel/sharding.py
# :18-36) put the attention heads, the KV heads, the MLP hidden dimension
# and the vocabulary on `tp`; every other axis (embed, the norms, the
# learned position table, a MoE block's experts and its router) is
# replicated. The port names its parameters itself, so the rules are a
# table over those names: each weight's axes, by logical name, in its
# (in, out) (or (vocab, embed), or (expert, in, out)) orientation. The
# port fuses projections, so two axes are fused segments: `qkv` is
# [heads | kv_heads | kv_heads] (models/transformer.py's qkv_proj) and
# `gate_up` is [mlp | mlp] (SwiGLU's gate_up_proj). A rank's shard of a
# fused axis is its slice of EACH segment, by heads, never one
# contiguous column range. A `<name>_bias` or `<name>_scale` (int8
# weights' per-column scales) runs along its weight's output axis: a
# column-parallel projection's follows its columns, a row-parallel one's
# (o, down) is replicated and applied once, after the all-reduce.
#
# A multi-LoRA adapter stack of projection p (models/transformer
# LoRAStack: A (slots, in, r), B (slots, r, out)) follows p's weight: on
# a column-parallel projection (q, k, v, gate, up) A is replicated and B
# is cut with p's output segment, on a row-parallel one (o, down) A is
# cut with p's input rows and B is replicated, so the row-parallel delta
# (x_r·A_r)·B lands in the partial sum before the all-reduce.

# What tensor-parallel serving refuses (training), and where ROADMAP.md
# has it.
TP_TRAINING_NEXT = ('ROADMAP.md §1 item 6: the rest of training '
                    '(ZeRO-1, elastic, pipeline)')

TP_AXIS_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ('heads', 'tp'),
    ('kv_heads', 'tp'),
    ('mlp', 'tp'),
    ('vocab', 'tp'),
    ('embed', None),
    ('expert', None),
    ('slot', None),
    ('rank', None),
)

TP_PARAM_AXES: Dict[str, Tuple[str, ...]] = {
    'embed': ('vocab', 'embed'),
    'lm_head': ('embed', 'vocab'),
    'attn.qkv_proj': ('embed', 'qkv'),
    'attn.o_proj': ('heads', 'embed'),
    'mlp.gate_up_proj': ('embed', 'gate_up'),
    'mlp.up_proj': ('embed', 'mlp'),
    'mlp.down_proj': ('mlp', 'embed'),
    # The reference's MoEBlock (skypilot_tpu/models/moe.py:44-60):
    # ('expert', 'embed', 'mlp') / ('expert', 'mlp', 'embed'), `expert`
    # unmapped under decode_mesh; the router is replicated.
    'moe.w_gate': ('expert', 'embed', 'mlp'),
    'moe.w_up': ('expert', 'embed', 'mlp'),
    'moe.w_down': ('expert', 'mlp', 'embed'),
}

# (in, out) axes of each projection an adapter targets, by the
# reference's module name (models/transformer.projection_shapes).
TP_PROJECTION_AXES: Dict[str, Tuple[str, str]] = {
    'q_proj': ('embed', 'heads'),
    'k_proj': ('embed', 'kv_heads'),
    'v_proj': ('embed', 'kv_heads'),
    'o_proj': ('heads', 'embed'),
    'gate_proj': ('embed', 'mlp'),
    'up_proj': ('embed', 'mlp'),
    'down_proj': ('mlp', 'embed'),
}


def _segments(axis: str, cfg) -> Tuple[Tuple[str, int], ...]:
    """The (logical axis, width) segments of one dimension, in order."""
    d = cfg.head_dim
    if axis == 'qkv':
        return (('heads', cfg.num_heads * d), ('kv_heads',
                                               cfg.num_kv_heads * d),
                ('kv_heads', cfg.num_kv_heads * d))
    if axis == 'gate_up':
        return (('mlp', cfg.d_mlp), ('mlp', cfg.d_mlp))
    width = {'heads': cfg.num_heads * d, 'kv_heads': cfg.num_kv_heads * d,
             'mlp': cfg.d_mlp, 'vocab': cfg.vocab_size}[axis]
    return ((axis, width),)


def _on_tp(axis: str) -> bool:
    return dict(TP_AXIS_RULES).get(axis) == 'tp'


def _cut(axis: str) -> bool:
    """Whether a dimension of logical axis `axis` (or fused segments)
    is cut on tp."""
    return axis in ('qkv', 'gate_up') or _on_tp(axis)


def param_axes(name: str) -> Optional[Tuple[str, ...]]:
    """The logical axes of parameter `name` of the port's Transformer
    (a layer's `layers.{i}.` prefix ignored), None when it is replicated
    whole (norms, position table, a MoE router)."""
    key = name.split('.', 2)[2] if name.startswith('layers.') else name
    for suffix in ('_bias', '_scale'):
        base = key[:-len(suffix)] if key.endswith(suffix) else None
        if base in TP_PARAM_AXES:
            return TP_PARAM_AXES[base][-1:]
    return TP_PARAM_AXES.get(key)


def adapter_axes(proj: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The logical axes of projection `proj`'s adapter stacks: A
    (slot, in, rank) and B (slot, rank, out)."""
    d_in, d_out = TP_PROJECTION_AXES[proj]
    return ('slot', d_in, 'rank'), ('slot', 'rank', d_out)


def _shard(name: str, value: torch.Tensor, axes, cfg, tp: int,
           rank: int) -> torch.Tensor:
    """Rank `rank`'s shard of `value` along its first dimension whose
    axes reach tp (a contiguous tensor of its own; `value` itself when no
    dimension does)."""
    dim = next((i for i, axis in enumerate(axes) if _cut(axis)), None)
    if dim is None:
        return value
    pieces, start = [], 0
    for axis, width in _segments(axes[dim], cfg):
        if not _on_tp(axis):
            pieces.append(value.narrow(dim, start, width))
        else:
            part = width // tp
            pieces.append(value.narrow(dim, start + rank * part, part))
        start += width
    if start != value.shape[dim]:
        raise ValueError(f'{name}: dimension {dim} is {value.shape[dim]} '
                         f'wide, its segments {start}')
    if len(pieces) == 1:
        return pieces[0].clone(memory_format=torch.contiguous_format)
    return torch.cat(pieces, dim=dim)


def shard_tensor(name: str, value: torch.Tensor, cfg, tp: int,
                 rank: int) -> torch.Tensor:
    """Rank `rank`'s shard of the full parameter `name` (a contiguous
    tensor of its own; `value` itself when replicated)."""
    axes = param_axes(name)
    if tp == 1 or axes is None:
        return value
    return _shard(name, value, axes, cfg, tp, rank)


def shard_adapter(proj: str, a: torch.Tensor, b: torch.Tensor, cfg,
                  tp: int, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank `rank`'s shards of projection `proj`'s adapter matrices:
    (in, r) A and (r, out) B, or their (slots, ...) stacks."""
    if tp == 1:
        return a, b
    axes = adapter_axes(proj)
    return tuple(_shard(f'{proj} adapter', t, ax[-t.dim():], cfg, tp, rank)
                 for t, ax in ((a, axes[0]), (b, axes[1])))


def adapter_is_sharded(proj: str) -> Tuple[bool, bool]:
    """Whether projection `proj`'s adapter A and B are cut on tp."""
    return tuple(any(_cut(a) for a in ax) for ax in adapter_axes(proj))


def is_sharded(name: str) -> bool:
    """Whether parameter `name` is cut on tp (else replicated)."""
    axes = param_axes(name)
    return axes is not None and any(_cut(a) for a in axes)


def shard_params(params, cfg, tp: int,
                 rank: int) -> Dict[str, torch.Tensor]:
    """Slice full parameters (a dict, or (name, tensor) pairs, taken one
    at a time) into rank `rank`'s shard."""
    items = params.items() if isinstance(params, dict) else params
    return {name: shard_tensor(name, value, cfg, tp, rank)
            for name, value in items}


# ---------------- ZeRO-1 ----------------


def zero_update_dim(shape: Sequence[int], dp: int) -> Optional[int]:
    """The dimension along which a rank holds 1/dp of a leaf's optimizer
    state under ZeRO-1: the counterpart of the reference's
    `zero_update_shardings` (skypilot_tpu/parallel/sharding.py:156-213)
    on a pure-dp mesh, where no other axis shards the leaf: the first
    dimension that dp divides. None (the leaf's state stays whole on
    every rank) for a scalar, a leaf no dimension fits, or dp = 1."""
    if dp <= 1:
        return None
    return next((i for i, size in enumerate(shape) if size % dp == 0), None)


def zero_shard(value: torch.Tensor, dim: int, dp: int,
               rank: int) -> torch.Tensor:
    """Rank `rank`'s 1/dp slice of `value` along `dim` (a view)."""
    part = value.shape[dim] // dp
    return value.narrow(dim, rank * part, part)
