"""Sharding rules of the port: the ambient sequence-parallel context, the
tensor-parallel rules over the model's parameters, the fsdp rules (which
dimension of each parameter fsdp cuts) and ZeRO-1's split of the
optimizer state over `dp`.

The ambient sequence-parallel context is the port's stand-in for the
reference's `use_mesh` (skypilot_tpu/parallel/sharding.py) on the `sp`
axis, where the batch's 'seq' dimension maps to 'sp' (`:22`).

`flash_attention(impl='ring')` reads it the way the reference's
`ring_attention_ambient` reads the ambient mesh, and raises without it,
as the reference does without an `sp` mesh. Two forms:
- `use_sequence_parallel(sp=N)`: one process holds the whole sequence and
  runs the N ring positions in turn (ops/ring_attention
  `ring_attention_sharded`);
- `use_sequence_parallel(group=g)`: each process of the group `g` holds
  one chunk (ops/ring_attention `ring_attention`); `g` is a training
  group's `ring` (parallel/mesh.TrainGroup with sp > 1: its hops count
  into the group's).

The context is process-wide, not per thread: autograd runs a CUDA
backward on its own device thread, and that is where checkpointed (remat)
layers run their forward again.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SequenceParallel:
    """sp ring positions; `group` set: one per process of that group."""
    sp: int
    group: Any = None

    @property
    def rank(self) -> int:
        """This process's ring position (0 in the one-process form)."""
        return self.group.rank if self.group is not None else 0


def sequence_parallel(sp: Optional[int] = None, *,
                      group=None) -> SequenceParallel:
    """A validated context: exactly one of `sp` (one process) or `group`
    (one rank per process, a training group's `ring`; sp is its size)."""
    if (sp is None) == (group is None):
        raise ValueError('give exactly one of sp (one process) or group '
                         '(one rank per process)')
    if group is not None:
        check_ring(group)
        return SequenceParallel(group.size, group)
    if sp < 1:
        raise ValueError(f'sp must be >= 1, got {sp}')
    return SequenceParallel(sp)


def check_ring(group) -> None:
    """Refuse anything but a group of the port (parallel/mesh.Group, a
    training group's `ring`) as the per-rank ring: its hops are counted
    collectives of that group."""
    from skypilot_tpu_torch.parallel.mesh import Group
    if not isinstance(group, Group):
        raise RuntimeError(
            'the per-rank ring runs over a torch.distributed training '
            "group's ring: parallel.mesh.train_group(dp, sp=N).ring (or "
            'TrainGroup.split(dp, fsdp, sp).ring), not '
            f'{type(group).__name__}')


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
TP_TRAINING_NEXT = 'ROADMAP.md §1 item 6c: --tp training'


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


# ---------------- fsdp ----------------
#
# The reference's rule ('embed', 'fsdp') (skypilot_tpu/parallel/
# sharding.py:26) shards every weight on its logical `embed` dimension;
# every other logical axis stays whole under fsdp. The port names its
# parameters itself, so the rule is a table over those names: the
# dimension of each leaf (a layer's `layers.{i}.` prefix dropped) that
# carries `embed`, None where no dimension does (the leaf is whole on
# every rank), following the reference's declarations:
# - q/k/v ('embed', 'heads'|'kv_heads', 'qkv_dim') (transformer.py
#   :528-534): the fused qkv_proj's input rows, which are contiguous (no
#   segment rule: its fused axis is its output); its bias (heads, ...)
#   is whole;
# - o_proj ('heads', 'qkv_dim', 'embed') (:573): its columns, and its
#   bias ('embed',);
# - gate/up ('embed', 'mlp') and down ('mlp', 'embed') (:871-881): the
#   fused gate_up_proj's input rows and down_proj's columns; the up
#   biases (mlp) whole, the down bias ('embed',);
# - embed ('vocab', 'embed') (:958-961) and the learned position table
#   (None, 'embed') (:975-977): their columns;
# - lm_head ('embed', 'vocab') (:1023): its rows; its bias (vocab) whole;
# - every norm's scale and bias ('embed',) (:371, :385-386);
# - the MoE router ('embed', 'expert') and the experts ('expert',
#   'embed', 'mlp') / ('expert', 'mlp', 'embed') (moe.py:44-60);
# - a LoRA adapter (transformer.py:138-147): A carries its projection's
#   input axes, B its output axes, so A is cut where the projection's
#   input is embed (q, k, v, gate, up) and B where its output is (o,
#   down).
FSDP_EMBED_DIM: Dict[str, Optional[int]] = {
    'embed': 1,
    'pos_embed': 1,
    'lm_head': 0,
    'lm_head_bias': None,
    'final_norm.weight': 0,
    'final_norm.bias': 0,
    'attn_norm.weight': 0,
    'attn_norm.bias': 0,
    'mlp_norm.weight': 0,
    'mlp_norm.bias': 0,
    'attn.qkv_proj': 0,
    'attn.qkv_proj_bias': None,
    'attn.o_proj': 1,
    'attn.o_proj_bias': 0,
    'mlp.gate_up_proj': 0,
    'mlp.gate_up_proj_bias': None,
    'mlp.up_proj': 0,
    'mlp.up_proj_bias': None,
    'mlp.down_proj': 1,
    'mlp.down_proj_bias': 0,
    'moe.router': 0,
    'moe.w_gate': 1,
    'moe.w_up': 1,
    'moe.w_down': 2,
}


def fsdp_dim(name: str) -> Optional[int]:
    """The dimension of parameter `name` of the port's Transformer that
    fsdp cuts (the one carrying the reference's `embed` axis), or None
    when the leaf stays whole. Unknown names raise KeyError: a new
    parameter needs its rule."""
    key = name.split('.', 2)[2] if name.startswith('layers.') else name
    for end, side in (('_lora_a', 0), ('_lora_b', 1)):
        if key.endswith(end):
            proj = key[:-len(end)].rsplit('.', 1)[-1]
            return side if TP_PROJECTION_AXES[proj][side] == 'embed' \
                else None
    return FSDP_EMBED_DIM[key]


def fsdp_shard(name: str, value: torch.Tensor, fsdp: int,
               rank: int) -> torch.Tensor:
    """Rank `rank`'s 1/fsdp slice of the full parameter `name` along
    `fsdp_dim` (a view; `value` itself when the leaf stays whole). A
    dimension fsdp does not divide is refused, as the reference's layout
    check refuses it, not replicated."""
    dim = fsdp_dim(name)
    if dim is None or fsdp == 1:
        return value
    size = value.shape[dim]
    if size % fsdp:
        raise ValueError(
            f'{name} {tuple(value.shape)}: the global size of its '
            f'dimension {dim} (embed) should be divisible by fsdp={fsdp}, '
            f'but it is equal to {size}')
    part = size // fsdp
    return value.narrow(dim, rank * part, part)


def fsdp_shape(name: str, shape: Sequence[int], fsdp: int) -> tuple:
    """The shape of one rank's slice of parameter `name` (full `shape`),
    with fsdp_shard's refusal."""
    return tuple(fsdp_shard(name, torch.empty(shape, device='meta'), fsdp,
                            0).shape)


# ---------------- ZeRO-1 ----------------


def zero_update_dim(shape: Sequence[int], dp: int) -> Optional[int]:
    """The dimension along which a rank holds 1/dp of a leaf's optimizer
    state under ZeRO-1: the counterpart of the reference's
    `zero_update_shardings` (skypilot_tpu/parallel/sharding.py:156-213):
    the first dimension that dp divides. None (the leaf's state stays
    whole on every rank) for a scalar, a leaf no dimension fits, or dp =
    1. Under fsdp `shape` is the rank's fsdp slice: the reference adds dp
    to the first dimension whose size stays divisible by the extent of
    the axes already on it times dp, which on the slice is the first
    that dp divides, and its part d of the fsdp-cut dimension is then
    part d of this rank's slice."""
    if dp <= 1:
        return None
    return next((i for i, size in enumerate(shape) if size % dp == 0), None)


def zero_shard(value: torch.Tensor, dim: int, dp: int,
               rank: int) -> torch.Tensor:
    """Rank `rank`'s 1/dp slice of `value` along `dim` (a view)."""
    part = value.shape[dim] // dp
    return value.narrow(dim, rank * part, part)
