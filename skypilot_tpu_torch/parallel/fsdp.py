"""Fully sharded data parallelism (fsdp) on the port: the reference's
ZeRO-3 style `('embed', 'fsdp')` layout (skypilot_tpu/parallel/
sharding.py:26) for a training Transformer.

Each rank of an fsdp group (parallel/mesh.TrainGroup's `column`) holds
only its slice of every parameter, cut on the dimension that carries
the reference's `embed` axis (sharding.fsdp_dim; a leaf with no such
dimension stays whole on every rank). The slices are the model's
registered parameters (`model.named_parameters()` and `state_dict()`
name them as the plain model does, at the slice's shape). A forward runs
the model in units:
- `embed`: the token embedding and the learned position table;
- `layers.{i}`: one decoder layer;
- `head`: the final norm and lm_head (the embedding again when tied).
A unit's leaves are all-gathered (one collective of its slices' bytes)
just before the unit runs and swapped into its modules for that call
only, so the whole model is never gathered at once: one unit at a time,
plus the head's weights from the end of the forward into the start of
the backward (the unembedding's product keeps its weight for the first
backward node, as it would without fsdp).

A layer's weights are needed again by its backward. Under remat the
layer runs inside torch.utils.checkpoint and its recompute gathers them
again. Without remat, autograd's saved-tensor hooks store a gathered
weight (a view of it, or its cast to another dtype) as a handle while
the layer runs forward, and the first backward node that reads one
gathers the layer again (at most one layer's re-gathered weights live:
gathering one drops the others').

The backward of a unit's gather reduce-scatters its gradients to the
owners once the unit's backward is done: the fp32 sum over the fsdp
group of every rank's gradients, each rank receiving its slice's,
accumulated in fp32 into `grads` (a side channel: the slices are never
autograd leaves, so no whole gradient is kept). A leaf that stays whole
adds its local gradient there; the trainer sums those over every rank.
Gradients therefore sit where the params sit, as the reference pins
them (skypilot_tpu/train/trainer.py:319-331).

Frozen leaves (LoRA's base) are gathered like the rest but carry no
gradient: their gathered copies are outside autograd, so autograd
computes no base dW, as without fsdp.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

from skypilot_tpu_torch.parallel import sharding


@dataclasses.dataclass
class Leaf:
    """One parameter of a unit: its owner module and attribute, its
    state-dict name, the dimension fsdp cuts (None: whole) and its full
    shape."""
    module: nn.Module
    attr: str
    name: str
    dim: Optional[int]
    shape: torch.Size

    @property
    def param(self) -> nn.Parameter:
        return self.module._parameters[self.attr]  # pylint: disable=protected-access

    def put(self, value: torch.Tensor) -> None:
        """Make `value` what the owner module reads under the leaf's name
        (the slice, or for one call the whole tensor)."""
        self.module._parameters[self.attr] = value  # pylint: disable=protected-access


@dataclasses.dataclass
class Unit:
    """The leaves gathered together, and the state of their backward
    re-gather (no remat): the gathered tensors of the current gather,
    by leaf index, and their casts."""
    name: str
    leaves: List[Leaf]
    regathered: Optional[List[torch.Tensor]] = None
    casts: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    @property
    def trainable(self) -> bool:
        return any(leaf.param.requires_grad for leaf in self.leaves)


def unit_of(name: str) -> str:
    """The unit that parameter `name` belongs to."""
    if name.startswith('layers.'):
        return '.'.join(name.split('.', 2)[:2])
    return 'embed' if name in ('embed', 'pos_embed') else 'head'


class _Gather(torch.autograd.Function):
    """A unit's whole leaves from the fsdp group's slices; its backward
    reduce-scatters their gradients into `FullyShard.grads`. `anchor`
    (a 0-d tensor) makes the outputs of a unit with trainable leaves
    require grad; frozen leaves' outputs are non-differentiable."""

    @staticmethod
    def forward(ctx, shard, unit, anchor):  # pylint: disable=arguments-differ
        del anchor
        ctx.shard, ctx.unit = shard, unit
        fulls = shard.gather(unit)
        ctx.mark_non_differentiable(*[
            full for full, leaf in zip(fulls, unit.leaves)
            if not leaf.param.requires_grad])
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        ctx.shard.scatter_grads(ctx.unit, grads)
        ctx.shard.release(ctx.unit)
        return None, None, None


@dataclasses.dataclass
class _Handle:
    """A saved tensor that is a gathered weight (or its view or cast):
    re-made from the unit's re-gather when backward reads it."""
    unit: Unit
    index: int
    dtype: torch.dtype
    shape: torch.Size
    stride: tuple
    offset: int


# The casts whose result stands for a gathered weight in the saved
# tensors (the model casts a weight to the compute dtype at its product).
_CASTS = (torch.Tensor.to, torch.Tensor.float, torch.Tensor.bfloat16,
          torch.Tensor.half, torch.Tensor.type_as)


class _Casts(TorchFunctionMode):
    """While a unit runs forward without remat: records the storage of
    each whole-tensor cast of a gathered weight, so that the saved-tensor
    hook stores the cast as a handle too. The casts are kept alive until
    the unit's forward ends: a freed cast's address could otherwise come
    back as another tensor's and be taken for it."""

    def __init__(self, registry: Dict[int, tuple], fulls) -> None:
        super().__init__()
        self.registry, self.fulls = registry, fulls
        self.kept: List[torch.Tensor] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _CASTS and isinstance(out, torch.Tensor) and args:
            src = args[0]
            entry = self.registry.get(_ptr(src))
            if (entry is not None and entry[1] is None and
                    src is self.fulls[entry[0]] and
                    _ptr(out) not in self.registry):
                self.registry[_ptr(out)] = (entry[0], out.dtype)
                self.kept.append(out)
        return out


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class FullyShard:
    """The fsdp state of one rank's Transformer (module docstring):
    `units` by name, `group` the fsdp group of two or more ranks (a
    parallel/mesh.Group: `all_gather`, `reduce_scatter`), `grads` the
    fp32 gradient slices by parameter name (`zero_grads` resets them)."""

    def __init__(self, model: nn.Module, group, device) -> None:
        self.group = group
        self.fsdp, self.rank = group.size, group.rank
        self.units: Dict[str, Unit] = {}
        self.leaves: Dict[str, Leaf] = {}
        for name, meta in list(model.named_parameters()):
            owner, _, attr = name.rpartition('.')
            module = model.get_submodule(owner) if owner else model
            leaf = Leaf(module, attr, name, sharding.fsdp_dim(name),
                        meta.shape)
            leaf.put(nn.Parameter(torch.empty(
                sharding.fsdp_shape(name, meta.shape, self.fsdp),
                dtype=meta.dtype, device=device),
                requires_grad=meta.requires_grad))
            self.leaves[name] = leaf
            self.units.setdefault(unit_of(name),
                                  Unit(unit_of(name), [])).leaves.append(leaf)
        if getattr(model.cfg, 'tie_embeddings', False):
            # The tied unembedding reads the embedding in the head.
            self.units['head'].leaves.append(self.leaves['embed'])
        self.anchor = torch.zeros((), device=device, requires_grad=True)
        self.grads: Dict[str, torch.Tensor] = {}
        # Bytes of gathered (and re-gathered) weights alive now, the most
        # at once, and how many casts of gathered weights autograd saved
        # as handles (without remat, under mixed precision).
        self.gathered_bytes = 0
        self.peak_gathered = 0
        self.cast_handles = 0

    # ---------------- slices ----------------

    def slice_of(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full parameter `name` (a view)."""
        return sharding.fsdp_shard(name, value, self.fsdp, self.rank)

    @torch.no_grad()
    def load_full(self, items) -> None:
        """Copy full tensors ((name, tensor) pairs, taken one at a time)
        into this rank's slices."""
        for name, value in items:
            param = self.leaves[name].param
            param.copy_(self.slice_of(name, value.to(param.device)))

    @torch.no_grad()
    def full(self, name: str) -> torch.Tensor:
        """The whole parameter `name` on every rank of the group (one
        all-gather; every rank calls it at the same point)."""
        return self._whole([self.leaves[name]])[0]

    # ---------------- gathers ----------------

    def _whole(self, leaves: List[Leaf]) -> List[torch.Tensor]:
        """The whole tensors of `leaves`: one all-gather of the slices'
        bytes for the cut ones (a whole leaf is this rank's, detached)."""
        cut = [leaf for leaf in leaves if leaf.dim is not None]
        out = {}
        if cut:
            flat = torch.cat([leaf.param.detach().reshape(-1).view(
                torch.uint8) for leaf in cut])
            every = self.group.all_gather(flat)
            del flat
            start = 0
            for leaf in cut:
                p = leaf.param
                size = p.numel() * p.element_size()
                parts = every[:, start:start + size].view(p.dtype).reshape(
                    (self.fsdp,) + tuple(p.shape))
                # A tensor of its own (the saved-tensor hook tells the
                # gathered weights apart by their storage).
                out[leaf.name] = torch.cat(parts.unbind(0), dim=leaf.dim)
                start += size
        return [out.get(leaf.name, leaf.param.detach()) for leaf in leaves]

    def gather(self, unit: Unit) -> List[torch.Tensor]:
        """The unit's whole leaves (counted in `gathered_bytes` while
        they live)."""
        fulls = self._whole(unit.leaves)
        for full, leaf in zip(fulls, unit.leaves):
            if leaf.dim is not None:
                self._track(full)
        return fulls

    def _track(self, t: torch.Tensor) -> None:
        size = t.numel() * t.element_size()
        self.gathered_bytes += size
        self.peak_gathered = max(self.peak_gathered, self.gathered_bytes)
        weakref.finalize(t, self._untrack, size)

    def _untrack(self, size: int) -> None:
        self.gathered_bytes -= size

    def release(self, unit: Unit) -> None:
        """Drop a unit's backward re-gather."""
        unit.regathered = None
        unit.casts = {}

    def _materialize(self, unit: Unit, index: int,
                     dtype: torch.dtype) -> torch.Tensor:
        """Leaf `index` of the unit's backward re-gather in `dtype`,
        gathered at the first read (dropping every other unit's)."""
        if unit.regathered is None:
            for other in self.units.values():
                if other is not unit:
                    self.release(other)
            with torch.no_grad():
                unit.regathered = self.gather(unit)
        full = unit.regathered[index]
        if full.dtype == dtype:
            return full
        key = (index, dtype)
        if key not in unit.casts:
            unit.casts[key] = full.to(dtype)
        return unit.casts[key]

    # ---------------- gradients ----------------

    def zero_grads(self) -> None:
        self.grads = {}

    def _accumulate(self, name: str, grad: torch.Tensor) -> None:
        if name in self.grads:
            self.grads[name].add_(grad)
        else:
            self.grads[name] = grad.float().clone()

    def scatter_grads(self, unit: Unit, grads) -> None:
        """A unit's backward is done: reduce-scatter its cut trainable
        leaves' gradients (fp32; one collective) into this rank's slices
        and add them, and each whole trainable leaf's local gradient,
        into `grads`."""
        cut = []
        for leaf, grad in zip(unit.leaves, grads):
            if not leaf.param.requires_grad:
                continue
            grad = (torch.zeros(leaf.shape, dtype=torch.float32,
                                device=leaf.param.device)
                    if grad is None else grad.float())
            if leaf.dim is None:
                self._accumulate(leaf.name, grad)
            else:
                cut.append((leaf, grad.unflatten(
                    leaf.dim, (self.fsdp, -1)).movedim(leaf.dim, 0).reshape(
                        self.fsdp, -1)))
        if not cut:
            return
        rows = torch.cat([rows for _, rows in cut], dim=1)
        mine = self.group.reduce_scatter(rows)
        del rows
        start = 0
        for leaf, rows in cut:
            size = rows.shape[1]
            self._accumulate(leaf.name,
                             mine[start:start + size].view(leaf.param.shape))
            start += size

    # ---------------- running a unit ----------------

    @contextlib.contextmanager
    def running(self, name: str, save_handles: bool):
        """Run the body with unit `name`'s whole leaves in its modules;
        `save_handles` (a layer without remat): autograd saves its
        gathered weights as handles (module docstring)."""
        unit = self.units[name]
        anchor = self.anchor if (unit.trainable and
                                 torch.is_grad_enabled()) else \
            self.anchor.detach()
        shards = [leaf.param for leaf in unit.leaves]
        fulls = _Gather.apply(self, unit, anchor)
        for leaf, full in zip(unit.leaves, fulls):
            leaf.put(full)
        try:
            if not save_handles:
                yield
                return
            registry = {_ptr(full): (i, None) for i, full in
                        enumerate(fulls)
                        if unit.leaves[i].dim is not None}

            def pack(t):
                entry = registry.get(_ptr(t)) if t.numel() else None
                if entry is None:
                    return t
                self.cast_handles += entry[1] is not None
                return _Handle(unit, entry[0], entry[1] or t.dtype,
                               t.shape, t.stride(), t.storage_offset())

            def unpack(saved):
                if not isinstance(saved, _Handle):
                    return saved
                base = self._materialize(saved.unit, saved.index,
                                         saved.dtype)
                return base.as_strided(saved.shape, saved.stride,
                                       saved.offset)

            with torch.autograd.graph.saved_tensors_hooks(pack, unpack), \
                    _Casts(registry, fulls):
                yield
        finally:
            for leaf, shard in zip(unit.leaves, shards):
                leaf.put(shard)

    def layer(self, index: int, layer: nn.Module, save_handles: bool):
        """Decoder layer `index` as a function of (x, step) that gathers
        its weights first (the body torch.utils.checkpoint re-runs)."""

        def run(x, step):
            with self.running(f'layers.{index}', save_handles):
                return layer(x, step)

        return run

    # ---------------- sizes ----------------

    def unit_bytes(self, name: str) -> int:
        """Bytes of unit `name`'s whole leaves."""
        return sum(torch.Size(leaf.shape).numel() *
                   leaf.param.element_size()
                   for leaf in self.units[name].leaves)
