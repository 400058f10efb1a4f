"""Training: state, optimizer and the train steps, on one card, with the
batch split over a data-parallel group (`dp`, with or without ZeRO-1, and
the extent-invariant elastic step), over a dp x fsdp group (weights,
gradients and moments sharded ZeRO-3 style, with or without ZeRO-1 on
the dp axis), with the sequence split over an `sp` ring, or over all
three at once.

Port of skypilot_tpu/train/trainer.py without the mesh's ep and pp axes
or the pipeline. A step is: forward over the whole sequence
(attention through the flash kernels, or the ring under sequence
parallelism) → masked cross-entropy → backward → optax's
clip_by_global_norm → optax's adamw with the warmup-cosine schedule.

Data parallelism (a TrainState of a parallel/mesh.TrainGroup): ranks are
symmetric processes. Every rank holds the same global batch and takes
its block of it (of each microbatch under grad_accum): rows [r B/R,
(r + 1) B/R) for its row index r of R = dp x fsdp ((dp, fsdp)
row-major), and under an sp ring columns [s S/sp, (s + 1) S/sp) for its
ring position s. So the data order is the same at any extent; the loss
is the global masked mean (each rank's Σ loss·mask over the global
Σ mask, which every rank reads off the batch), the rank's gradients are
its share of it, and the shares are summed in fp32 once per optimizer
step: one all-reduce over the whole group. ZeRO-1 and the elastic step:
TrainState and make_elastic_train_step. A MoE model routes over the
whole (per accumulation) batch in either case (models/moe.RoutingBatch:
the reference's groups, which GSPMD keeps when the batch is sharded).

fsdp (a TrainState of a group with fsdp > 1; parallel/fsdp.py): each
rank holds its slices of the params and of the AdamW moments. The
blocks are those of `--dp` at the same extent, so the forward and the
loss share are too. Each unit's backward reduce-scatters its gradients
over its column (the fsdp group that shares its dp and sp indices;
fp32, each microbatch, accumulated in fp32 on the slices); once per
optimizer step the peers that hold the same slices (dp x sp of them)
sum them, and the whole group the loss and the slices' squares (counted
once per fsdp index), whose square root is grad_norm; then the clip and
AdamW on each rank's slices (ZeRO-1 cuts them further over its dp
group).

Tensor parallelism (a group with tp > 1: parallel/tensor.py, the model
docstring): the tp ranks of one (dp, fsdp) index hold the shards of one
model and take the same block of the batch; the model's forward and
backward meet in its own all-reduces over the group's `tensor`, and the
loss is the vocab-parallel cross-entropy of each rank's vocab slice, so
every tp rank holds the same loss and the gradients of its own shards.
The step then sums the loss and the gradients over the ranks that hold
the same shard (the group's `data`: dp x fsdp x sp of them), never over
tp; sums the local gradients of the adapters' whole factors
(sharding.tp_partial_grad) over `tensor`; and reads grad_norm from one
all-reduce over the whole group of each rank's sum of squares, a leaf's
counted on one rank of those that hold the same part of it (its tp shard
on every tp rank, a leaf whole on tp on tp rank 0). So the clip and
AdamW give every rank the update of one device, and the leaves whole on
tp stay equal on every tp rank.

Sequence parallelism comes in the two forms of ops/ring_attention.py.
In one process (`make_train_step(sp=N)`) the model sees the whole
sequence and only attention is split (the reference's sp mesh on one
host): the step is the plain step inside the sp context. Per rank (a
group with sp > 1: one process per ring position of each (dp, fsdp)
index) the model reads the rank's columns with its positions, attends
over the group's `ring`, and the step is the group's step above: the
loss share, the one fp32 sum (fsdp: the column, the peers, the whole
group), so clipping sees the global norm and every rank applies the
same update (the reference's replicated-over-sp parameters under jit).

The optimizer must compute what the reference's optax chain computes.
torch.optim.AdamW (fused) does the adamw part once it is driven as optax
drives it; each point is checked here:
- the schedule is read at the update count BEFORE it is incremented, so
  the first update has lr = 0 (params stay, moments move); after the
  warmup the cosine runs over decay_steps - warmup_steps down to 0.1 lr.
  `learning_rate_at` is optax's schedule; the step sets it as the
  group's lr before each update;
- clip_by_global_norm leaves grads alone when norm < max_norm and else
  scales them by max_norm / norm (torch's clip_grad_norm_ adds 1e-6, so
  it is not used); the reported grad_norm is of the unclipped grads;
- adamw: eps 1e-8 and eps_root 0 (torch adds eps outside the sqrt, as
  optax does), bias correction with t = count + 1 (torch increments its
  step first), and weight decay on EVERY parameter (one param group, no
  mask: norms and embeddings decay too). torch's decoupled decay
  p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps) is optax's
  p - lr (m_hat / (sqrt(v_hat) + eps) + wd p);
- the moments live in the param dtype (torch keeps its state like the
  param; optax's mu_dtype=None); the update runs in fp32.
What differs is rounding only (e.g. sqrt(v) / sqrt(bc2) for
sqrt(v / bc2)): within the CPU tests' 2e-5 of the JAX train step.

LoRA (cfg.lora_rank > 0): the reference's make_optimizer(lora_only=True),
a multi_transform of the chain over the lora_a/lora_b leaves against
set_to_zero for the rest. Here the base parameters do not require grad
(models/transformer), and `TrainState.params` is the trainable
parameters only, so autograd computes no base gradient, AdamW holds
moments for the adapters alone, the clip and the reported grad_norm see
adapter gradients only (the reference zeroes the frozen gradients before
its global_norm), weight decay applies to the adapters, the schedule
counts as before, and a grad_accum accumulator holds adapter leaves only
(the reference's `_is_trained`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.ops import limits
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.tensor import vocab_parallel_cross_entropy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95


def learning_rate_at(tc: TrainConfig, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps, decay_steps=max(total_steps, warmup_steps + 1),
    end_value=0.1 lr) at update count `count`."""
    peak = tc.learning_rate
    warmup = tc.warmup_steps
    decay_steps = max(tc.total_steps, warmup + 1)
    if count < warmup:                       # linear 0 → peak
        return peak * count / warmup
    span = decay_steps - warmup
    t = min(count - warmup, span)
    alpha = 0.1
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
    return peak * ((1.0 - alpha) * cosine + alpha)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm in fp32: sqrt of the sum of every tensor's sum of
    squares. (torch.linalg.vector_norm on the CPU sums fp32 less
    accurately: 3e-5 relative off on a 2M-element tensor.)"""
    return torch.sqrt(torch.stack(
        [t.float().square().sum() for t in tensors]).sum())


class TrainState:
    """The model plus the optimizer (AdamW state: moments in the param
    dtype, update count) over the trainable parameters (`params`, named
    `names`: every parameter, or under LoRA the adapters). Params and
    moments update in place.

    `group` (parallel/mesh.TrainGroup) makes the state one rank's of a
    data-parallel run: the params are replicated, and the train steps of
    this module take the rank's rows of the global batch. `zero1` with
    dp > 1 is ZeRO-1 (the reference's create_sharded_state(
    zero_sharding=True)): for each leaf that sharding.zero_update_dim
    gives a dimension, AdamW updates this rank's 1/dp slice of it, so its
    moments are born sharded at the first update and no rank ever holds
    a whole one; the updated slices are then all-gathered into every
    rank's params. The slice is a view of the leaf where it is contiguous
    (a dim-0 slice: the update lands in the param), else a tensor of its
    own, refreshed from the leaf before each update. Leaves with no such
    dimension are updated whole on every rank.

    The norm and the clip read the whole summed gradients, as without
    ZeRO-1, and AdamW is elementwise, so loss, grad_norm and params are
    the plain step's bits. That is why the gradient sum stays one
    all-reduce (counted as 'partition_scatter', the reference's CPU
    spelling) on any backend, NCCL included: a native reduce-scatter
    leaves each rank 1/dp of each leaf, and the whole-leaf norm would
    then be assembled from per-shard partial sums (other bits) or need
    the gradients gathered back, which moves what the all-reduce moves."""

    def __init__(self, model: Transformer, tc: TrainConfig, group=None,
                 zero1: bool = False) -> None:
        self.model = model
        self.tc = tc
        trained = [(n, p) for n, p in model.named_parameters()
                   if p.requires_grad]
        if not trained:
            raise ValueError(f'{model.cfg.name}: no trainable parameters')
        self.names = [n for n, _ in trained]
        self.params = [p for _, p in trained]
        self.group = group
        self.dp = group.dp if group is not None else 1
        self.tp = group.tp if group is not None else 1
        # fsdp: the model's FullyShard. ZeRO-1's dp collectives run on the
        # group's row (its dp group) when it has subgroups, else on the
        # group itself.
        self.fsdp = model.fsdp
        if self.fsdp is not None and group is None:
            raise ValueError('an fsdp model trains in its TrainGroup')
        self.dp_group = (group.row if group is not None and
                         group.row is not None else group)
        # The group whose ranks save, restore and agree together.
        self.ranks = group if group is not None and group.size > 1 \
            else None
        self.zero1 = zero1 and self.dp > 1
        self.zero_dims = [
            sharding.zero_update_dim(p.shape, self.dp) if self.zero1
            else None for p in self.params]
        # How many ranks' moments make one leaf's whole moments.
        self.moment_copies = [
            (self.fsdp.fsdp if self.fsdp is not None and
             self.fsdp.leaves[n].dim is not None else 1) *
            (self.dp if d is not None else 1) *
            (self.tp if self.tp > 1 and sharding.is_sharded(n) else 1)
            for n, d in zip(self.names, self.zero_dims)]
        # What AdamW updates: each leaf, or under ZeRO-1 this rank's slice.
        self.updated = [p if d is None else self._own_slice(p, d)
                        for p, d in zip(self.params, self.zero_dims)]
        self.optimizer = torch.optim.AdamW(
            self.updated, lr=0.0, betas=(tc.b1, tc.b2), eps=1e-8,
            weight_decay=tc.weight_decay, fused=True)
        self.count = 0

    def _slice(self, value: torch.Tensor, dim: int,
               rank: Optional[int] = None) -> torch.Tensor:
        return sharding.zero_shard(value, dim, self.dp, self.dp_group.rank
                                   if rank is None else rank)

    def _own_slice(self, p: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of leaf `p` for AdamW: a view of its storage
        where the slice is contiguous, else a copy."""
        part = self._slice(p.detach(), dim)
        return part if part.is_contiguous() else part.clone()

    @staticmethod
    def _is_view(u: torch.Tensor, p: torch.Tensor) -> bool:
        return u.untyped_storage().data_ptr() == \
            p.untyped_storage().data_ptr()

    @torch.no_grad()
    def apply_gradients(self, grads: List[torch.Tensor],
                        norm: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """clip_by_global_norm then adamw, in place. Returns the global
        norm of the UNCLIPPED grads (the reference's metric); `norm`
        when the caller computed it (fsdp: over every rank's slices)."""
        tc = self.tc
        if norm is None:
            norm = global_norm(grads)
        # optax: where(norm < max_norm, g, g / norm * max_norm), decided
        # on the device (no host sync).
        scale = torch.where(norm < tc.grad_clip_norm, torch.ones_like(norm),
                            tc.grad_clip_norm / norm)
        torch._foreach_mul_(grads, scale)  # pylint: disable=protected-access
        for p, u, g, d in zip(self.params, self.updated, grads,
                              self.zero_dims):
            if d is None:
                u.grad = g
            else:
                if not self._is_view(u, p):
                    u.copy_(self._slice(p, d))
                u.grad = self._slice(g, d).contiguous()
        self.optimizer.param_groups[0]['lr'] = learning_rate_at(tc,
                                                                self.count)
        self.optimizer.step()
        for u in self.updated:
            u.grad = None
        if self.zero1:
            self._gather_params()
        self.count += 1
        return norm

    def _gather_params(self) -> None:
        """Every rank's updated slices into every rank's params: one
        all-gather of this rank's slices, as bytes, copied from its buffer
        straight into each leaf's storage (this rank's own slice is
        already there where it is a view)."""
        sliced = [(p, u, d) for p, u, d in zip(self.params, self.updated,
                                                self.zero_dims)
                  if d is not None]
        if not sliced:
            return
        flat = torch.cat([u.reshape(-1).view(torch.uint8)
                          for _, u, _ in sliced])
        gathered = self.dp_group.all_gather(flat)
        del flat
        start = 0
        for p, u, d in sliced:
            size = u.numel() * u.element_size()
            view = self._is_view(u, p)
            for rank in range(self.dp):
                if view and rank == self.dp_group.rank:
                    continue
                dst = self._slice(p, d, rank)
                src = gathered[rank, start:start + size]
                if dst.is_contiguous():
                    dst.view(-1).view(torch.uint8).copy_(src)
                else:
                    dst.copy_(src.clone().view(u.dtype).view(u.shape))
            start += size

    def moments(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """This rank's AdamW state by parameter name: each leaf's moments
        and step counter, under ZeRO-1 its slice's."""
        return {name: dict(self.optimizer.state[u])
                for name, u in zip(self.names, self.updated)
                if u in self.optimizer.state}

    def own_moments(self, name: str, whole: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Leaf `name`'s whole AdamW state cut to this rank's layout: under
        ZeRO-1 its slice of each moment (copies), else `whole`."""
        dim = self.zero_dims[self.names.index(name)]
        if dim is None:
            return whole
        return {key: value if value.dim() == 0 else
                self._slice(value, dim).clone()
                for key, value in whole.items()}

    @torch.no_grad()
    def load_moments(self, moments) -> None:
        """Set the AdamW state from (name, moments) pairs in this rank's
        layout (`own_moments`)."""
        index = {name: i for i, name in enumerate(self.names)}
        for name, own in moments:
            u = self.updated[index[name]]
            self.optimizer.state[u] = {key: value.to(u.device)
                                       for key, value in own.items()}

    def state_dict(self) -> Dict:
        return {'model': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict(),
                'count': self.count}


def create_train_state(cfg: ModelConfig, train_config: Optional[TrainConfig]
                       = None, device='cuda', seed: int = 0, group=None,
                       zero1: bool = False) -> TrainState:
    """A TrainState with seeded random weights (models/transformer
    init_random_, the reference's distributions; every rank of a group
    draws the same, each keeping its part) on `device`, `group` and
    `zero1` as TrainState's. On CUDA a model whose attention the kernels
    cannot take is refused here (ops/limits.py), before any step, and so
    is a group whose tp runs beside an sp ring (sharding.TP_NEXT)."""
    if cfg.decode:
        raise ValueError('training runs the full-sequence path; '
                         'cfg.decode must be False')
    impl = cfg.attention_impl
    if torch.device(device).type == 'cuda' and impl in (
            'auto', 'pallas', 'ring') and not (
                impl == 'auto' and cfg.attn_logit_softcap):
        # Attention goes through the flash (and ring) kernels on the card.
        limits.check_kernel_shapes(cfg.head_dim)
    fsdp = group.column if group is not None and group.fsdp > 1 else None
    tensor = group.tensor if group is not None and group.tp > 1 else None
    if tensor is not None and group.sp > 1:
        raise NotImplementedError(
            f'tp={group.tp} beside sp={group.sp} does not train yet '
            f'({sharding.TP_NEXT})')
    model = Transformer(cfg, device=device, group=tensor,
                        fsdp=fsdp).init_random_(seed)
    return TrainState(model, train_config or TrainConfig(), group, zero1)


def _token_losses(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> tuple:
    """(per-token loss, fp32 mask): logits in fp32 for a stable softmax,
    logsumexp(logits) - logits[target] (optax's
    softmax_cross_entropy_with_integer_labels); ones without a mask."""
    logits = logits.float()
    losses = (torch.logsumexp(logits, dim=-1) -
              logits.gather(-1, targets.long()[..., None])[..., 0])
    return losses, (torch.ones_like(losses) if mask is None
                    else mask.float())


def _masked_mean(losses: torch.Tensor, maskf: torch.Tensor,
                 masked: bool) -> torch.Tensor:
    if masked:
        return torch.sum(losses * maskf) / torch.clamp(torch.sum(maskf),
                                                        min=1.0)
    return torch.mean(losses)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token loss (`_token_losses`), masked mean
    sum(loss * mask) / max(sum(mask), 1)."""
    return _masked_mean(*_token_losses(logits, targets, mask),
                        mask is not None)


def _model_losses(model: Transformer, logits: torch.Tensor,
                  targets: torch.Tensor, mask: Optional[torch.Tensor]
                  ) -> tuple:
    """`_token_losses` of the model's logits: a tp training rank's are its
    vocab slice, which the vocab-parallel cross-entropy reads
    (parallel/tensor.py)."""
    if not model.tp_train:
        return _token_losses(logits, targets, mask)
    losses = vocab_parallel_cross_entropy(logits, targets, model.group)
    return losses, (torch.ones_like(losses) if mask is None
                    else mask.float())


def _loss(model: Transformer, batch: Dict[str, torch.Tensor]
          ) -> torch.Tensor:
    logits = model(batch['inputs'])
    # Named ranges (here and around the optimizer) let a torch.profiler
    # trace attribute device time to them; free when not profiling.
    with torch.profiler.record_function('cross_entropy'):
        mask = batch.get('mask')
        return _masked_mean(*_model_losses(model, logits, batch['targets'],
                                           mask), mask is not None)


def _origins(group, batch: Dict[str, torch.Tensor]) -> tuple:
    """((rows, columns) of a block, each rank's block origin in rank
    order) of `batch` under `group` (module docstring): rows over dp x
    fsdp, columns over the sp ring, the same block on every tp rank."""
    rows, seq = batch['inputs'].shape
    extent = group.dp * group.fsdp
    if rows % extent:
        raise ValueError(f'batch {rows} is not divisible by dp*fsdp = '
                         f'{extent}')
    if seq % group.sp:
        raise ValueError(f'sequence {seq} is not divisible by '
                         f'sp={group.sp}')
    part, chunk = rows // extent, seq // group.sp
    return (part, chunk), [((r // group.tp // group.sp) * part,
                            (r // group.tp % group.sp) * chunk)
                           for r in range(group.size)]


def _routing(state: TrainState, batch: Dict[str, torch.Tensor]):
    """The MoE routing batch of a group's step: the whole (per
    accumulation) batch, this rank holding its block
    (models/moe.RoutingBatch); nothing to route otherwise."""
    group = state.group
    if not state.model.cfg.is_moe or group is None or group.size == 1:
        return contextlib.nullcontext()
    _, origins = _origins(group, batch)
    return moe.use_routing_batch(moe.RoutingBatch(
        *batch['inputs'].shape, *origins[group.rank], group, tuple(origins)))


def _share_loss(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """This rank's share of the global masked-mean loss under its group:
    its block's Σ loss·mask over the global batch's Σ mask (every rank
    holds the global batch, so the denominator needs no collective). A
    per-rank ring's model reads the rank's columns (its positions start
    at its chunk)."""
    (part, chunk), origins = _origins(state.group, batch)
    row0, col0 = origins[state.group.rank]
    rows, cols = slice(row0, row0 + part), slice(col0, col0 + chunk)
    mask = batch.get('mask')
    count = (mask.float().sum() if mask is not None else torch.tensor(
        float(batch['targets'].numel()), device=batch['inputs'].device))
    logits = state.model(batch['inputs'][rows, cols])
    with torch.profiler.record_function('cross_entropy'):
        losses, maskf = _model_losses(
            state.model, logits, batch['targets'][rows, cols],
            None if mask is None else mask[rows, cols])
        return torch.sum(losses * maskf) / torch.clamp(count, min=1.0)


def _sum_over_ranks(loss: torch.Tensor, grads: List[torch.Tensor],
                    reduce: Callable[[torch.Tensor], torch.Tensor]) -> tuple:
    """The global loss and gradients from each rank's share: one fp32
    sum over the group (`reduce`, in place) of the loss and every
    gradient, flattened."""
    flat = torch.cat([loss.detach().float().reshape(1)] +
                     [g.float().reshape(-1) for g in grads])
    reduce(flat)
    out, start = [], 1
    for g in grads:
        out.append(flat[start:start + g.numel()].view(g.shape))
        start += g.numel()
    return flat[0], out


def _tp_partial_sum(state: TrainState, grads: Dict[str, torch.Tensor]
                    ) -> None:
    """Under tp: replace each adapter whole factor's local gradient in
    `grads` (by name) with its fp32 sum over the group's `tensor` (one
    all-reduce; sharding.tp_partial_grad)."""
    names = [n for n in state.names if sharding.tp_partial_grad(n)]
    if state.tp == 1 or not names:
        return
    flat = torch.cat([grads[n].float().reshape(-1) for n in names])
    state.group.tensor.all_reduce(flat)
    start = 0
    for n in names:
        grads[n] = flat[start:start + grads[n].numel()].view(grads[n].shape)
        start += grads[n].numel()


def _tp_norm(state: TrainState, grads: Dict[str, torch.Tensor]
             ) -> Optional[torch.Tensor]:
    """grad_norm of a tp group's summed gradients (by name): each rank's
    sum of squares of the leaves it counts, one fp32 all-reduce over the
    whole group, the root. A rank counts a leaf when it is the first of
    the ranks that hold the same part of it: dp and sp index 0, fsdp
    index 0 unless fsdp cuts the leaf, tp index 0 unless tp does. None
    without tp (apply_gradients takes the norm itself)."""
    if state.tp == 1:
        return None
    group, fs = state.group, state.fsdp
    first = group.dp_rank == 0 and group.sp_rank == 0
    parts = [grads[n].float().square().sum() for n in state.names
             if first and (group.fsdp_rank == 0 or (
                 fs is not None and fs.leaves[n].dim is not None)) and (
                     group.tp_rank == 0 or sharding.is_sharded(n))]
    dev = next(iter(grads.values())).device
    local = (torch.stack(parts).sum().reshape(1) if parts else
             torch.zeros(1, dtype=torch.float32, device=dev))
    return torch.sqrt(group.all_reduce(local)[0])


def _ring_scope(state: TrainState, sp: Optional[int]):
    """The sequence-parallel context of a step: the one-process ring of
    `sp` positions, or the per-rank ring of the state's group."""
    group = state.group
    ring = group.ring if group is not None and group.sp > 1 else None
    if ring is not None and sp is not None:
        raise ValueError(f'this state runs its ring per rank (sp='
                         f'{group.sp}); make the step without sp')
    if sp is not None:
        return sharding.use_sequence_parallel(sp)
    if ring is not None:
        return sharding.use_sequence_parallel(group=ring)
    return contextlib.nullcontext()


def make_train_step(grad_accum: int = 1, *, sp: Optional[int] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """The train step: loss → grads → clip → adamw, updating `state` in
    place; returns {'loss', 'grad_norm', 'step'} (device tensors; the
    caller decides when to sync).

    `grad_accum` A > 1 splits the batch's leading dim into A sequential
    microbatches: grads sum in fp32 and ONE optimizer update applies with
    the mean loss and mean grads (the reference's lax.scan accumulation:
    per-microbatch means weighted equally).

    `sp` N runs the step inside use_sequence_parallel(sp=N) (one process,
    the model's attention_impl 'ring').

    A state of a group (TrainState's `group` of more than one rank) runs
    the step on the rank's block of each microbatch (its rows, and under
    an sp ring its columns, the ring per rank over the group's `ring`)
    and sums the shares once per optimizer step: one all-reduce over the
    ranks that hold the same shards (the whole group without tp), which
    ZeRO-1 counts as its partition scatter (TrainState); under tp then
    the adapters' whole factors over `tensor` and the norm (module
    docstring); fsdp: `_fsdp_step`. Either way the caller passes the
    global batch."""
    if sp is not None:
        sharding.sequence_parallel(sp)                    # validate now

    def loss_and_grads(state: TrainState, batch):
        with _routing(state, batch):
            if state.group is not None and state.group.size > 1:
                loss = _share_loss(state, batch)
            else:
                loss = _loss(state.model, batch)
            return loss, torch.autograd.grad(loss, state.params)

    def grads_of(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if grad_accum <= 1:
            loss, grads = loss_and_grads(state, batch)
            return loss, list(grads)
        rows = batch['inputs'].shape[0]
        if rows % grad_accum:
            raise ValueError(f'batch {rows} not divisible by '
                             f'grad_accum={grad_accum}')
        micro = rows // grad_accum
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch['inputs'].device)
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        for i in range(grad_accum):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            loss_i, grads_i = loss_and_grads(state, mb)
            for a, g in zip(acc, grads_i):
                a.add_(g.float())
            loss = loss + loss_i.detach()
        return loss / grad_accum, [a / grad_accum for a in acc]

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        group = state.group
        with _ring_scope(state, sp):
            if state.fsdp is not None:
                return _fsdp_step(state, batch, grad_accum)
            loss, grads = grads_of(state, batch)
            data = group.replicas if group is not None else None
            if data is not None and data.size > 1:
                kind = 'partition_scatter' if state.zero1 else 'all_reduce'
                loss, grads = _sum_over_ranks(
                    loss, grads, lambda x: data.all_reduce(x, kind))
        named = dict(zip(state.names, grads))
        _tp_partial_sum(state, named)
        grads = [named[n].to(p.dtype) for n, p in zip(state.names,
                                                      state.params)]
        norm = _tp_norm(state, dict(zip(state.names, grads)))
        with torch.profiler.record_function('optimizer'):
            grad_norm = state.apply_gradients(grads, norm)
        return {'loss': loss.detach(), 'grad_norm': grad_norm,
                'step': state.count}

    return step


def _fsdp_step(state: TrainState, batch: Dict[str, torch.Tensor],
               grad_accum: int) -> Dict[str, torch.Tensor]:
    """One optimizer step of an fsdp state (module docstring): per
    microbatch the forward and backward of the rank's block, whose units
    reduce-scatter their gradients over the column into the slices
    (fp32); then one all-reduce of the slices over the peers that hold
    them (dp x sp > 1), one over the whole group (the loss, the slices'
    sum of squares and the whole leaves' gradients), the clip and
    AdamW. Under tp the loss and the whole leaves are summed over the
    group's `data` instead, the adapters' whole factors over `tensor`,
    and the norm is `_tp_norm`'s."""
    fs, group = state.fsdp, state.group
    rows = batch['inputs'].shape[0]
    if rows % grad_accum:
        raise ValueError(f'batch {rows} not divisible by '
                         f'grad_accum={grad_accum}')
    micro, extent = rows // grad_accum, group.dp * group.fsdp
    if micro % extent:
        raise ValueError(
            f'per-accumulation batch {micro} (batch {rows} / grad_accum '
            f'{grad_accum}) must be divisible by dp*fsdp = {extent}')
    fs.zero_grads()
    loss = None
    for i in range(grad_accum):
        mb = ({k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
              if grad_accum > 1 else batch)
        with _routing(state, mb):
            loss_i = _share_loss(state, mb)
            torch.autograd.backward(loss_i)
        loss = loss_i.detach() if loss is None else loss + loss_i.detach()
        del loss_i
    if grad_accum > 1:
        loss = loss / grad_accum
    loss = loss.float().reshape(1)
    cut = [n for n in state.names if fs.leaves[n].dim is not None]
    whole = [n for n in state.names if fs.leaves[n].dim is None]
    acc = {n: fs.grads[n] for n in state.names}
    fs.zero_grads()

    def summed(parts, reduce):
        """Sum the flattened `parts` in one collective; views back."""
        flat = torch.cat([p.reshape(-1) for p in parts])
        reduce(flat)
        out, start = [], 0
        for p in parts:
            out.append(flat[start:start + p.numel()].view(p.shape))
            start += p.numel()
        return out

    if group.peers.size > 1 and cut:
        kind = 'partition_scatter' if state.zero1 else 'all_reduce'
        acc.update(zip(cut, summed(
            [acc[n] for n in cut],
            lambda x: group.peers.all_reduce(x, kind))))
    _tp_partial_sum(state, acc)
    dtypes = dict(zip(state.names, (p.dtype for p in state.params)))
    final = {n: (acc[n] / grad_accum if grad_accum > 1 else acc[n]).to(
        dtypes[n]) for n in cut}
    if state.tp > 1:
        loss, *rest = summed([loss] + [acc[n] for n in whole],
                             group.replicas.all_reduce)
        for n, g in zip(whole, rest):
            final[n] = (g / grad_accum if grad_accum > 1 else g).to(dtypes[n])
        grads = [final[n] for n in state.names]
        with torch.profiler.record_function('optimizer'):
            grad_norm = state.apply_gradients(grads, norm=_tp_norm(
                state, final))
        return {'loss': loss[0], 'grad_norm': grad_norm,
                'step': state.count}
    # The slices' squares once per fsdp index (its peers hold the same
    # slices now: the others add zeros), the loss shares and the whole
    # leaves' local gradients summed over every rank in one all-reduce:
    # the loss is then summed as --dp sums it at this extent.
    first = group.dp_rank == 0 and group.sp_rank == 0
    squares = (torch.stack([final[n].float().square().sum() for n in cut])
               .sum().reshape(1) if cut and first
               else torch.zeros_like(loss))
    loss, squares, *rest = summed([loss, squares] + [acc[n] for n in whole],
                                  group.all_reduce)
    for n, g in zip(whole, rest):
        final[n] = (g / grad_accum if grad_accum > 1 else g).to(dtypes[n])
    total = squares[0] + sum((final[n].float().square().sum()
                              for n in whole), torch.zeros_like(squares[0]))
    grads = [final[n] for n in state.names]
    with torch.profiler.record_function('optimizer'):
        grad_norm = state.apply_gradients(grads, norm=torch.sqrt(total))
    return {'loss': loss[0], 'grad_norm': grad_norm, 'step': state.count}


# The elastic step's combine moves this many values a collective.
COMBINE_CHUNK = 1 << 26


def _fixed_combine(mine: torch.Tensor, state: TrainState,
                   canonical_dp: int) -> torch.Tensor:
    """Σ in fp32 over the canonical groups of each group's row of `mine`
    (this rank's groups, (rounds, N), in any dtype), in group order, by a
    fixed left-to-right chain of adds: every rank's rows gathered as they
    are (pure data movement, COMBINE_CHUNK values at a time), each cast
    to fp32 and added one group after another, so the sum's association
    does not depend on the extent."""
    total = torch.empty(mine.shape[1], dtype=torch.float32,
                        device=mine.device)
    for start in range(0, mine.shape[1], COMBINE_CHUNK):
        part = mine[:, start:start + COMBINE_CHUNK]
        every = (state.group.all_gather(part) if state.dp > 1
                 else part[None]).reshape(canonical_dp, -1)
        acc = every[0].float()
        for g in range(1, canonical_dp):
            acc.add_(every[g].float())
        total[start:start + part.shape[1]] = acc
    return total


def make_elastic_train_step(canonical_dp: int
                            ) -> Callable[[TrainState,
                                           Dict[str, torch.Tensor]],
                                          Dict[str, torch.Tensor]]:
    """The dp-extent-invariant train step of elastic (preemption-native)
    training, the counterpart of the reference's make_elastic_train_step
    (skypilot_tpu/train/trainer.py:350-494): loss, gradients and the
    update are bit-identical whether the state's group runs dp =
    canonical_dp or any divisor of it.

    1. CANONICAL GROUPS: the global batch is split into `canonical_dp`
       device-major groups of B/canonical_dp rows; rank r runs groups
       r·rounds … (r + 1)·rounds - 1 in turn (rounds = canonical_dp/dp),
       each at the same shapes whatever the extent, so the per-group
       kernels cannot differ.
    2. FIXED COMBINE: per group the loss sum, the mask sum and the
       gradients of the loss sum; every group's are gathered into group
       order (a leaf at a time, in the param dtype) and added in fp32 by a
       fixed left-to-right chain (`_fixed_combine`), then divided by the
       total mask.
    3. The norm, the clip and AdamW then read the same bits at every
       extent; ZeRO-1 rides along (its update is elementwise).

    The loss is sum-of-group-sums / sum-of-group-masks: the same mean as
    make_train_step's, not its bits. A live dp that does not divide
    canonical_dp is refused with the reference's message, and a state of
    fsdp, sp or tp (the reference's elastic mesh is pure dp)."""
    if canonical_dp < 1:
        raise ValueError(f'canonical_dp must be >= 1, got {canonical_dp}')

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if state.fsdp is not None or (state.group is not None and
                                      state.group.sp * state.group.tp > 1):
            raise ValueError('the elastic step runs a pure-dp mesh, as the '
                             "reference's does; this state is fsdp, sp or "
                             'tp')
        dp = state.dp
        if canonical_dp % dp:
            raise ValueError(
                f'elastic step: live dp={dp} must divide the canonical '
                f'extent {canonical_dp} — resize to a divisor (e.g. '
                f'{canonical_dp}→{canonical_dp // 2}) so the canonical '
                f'groups tile the surviving devices')
        rows = batch['inputs'].shape[0]
        if rows % canonical_dp:
            raise ValueError(f'batch {rows} not divisible by '
                             f'canonical_dp={canonical_dp}')
        rounds, part = canonical_dp // dp, rows // canonical_dp
        rank = state.group.rank if dp > 1 else 0
        device = batch['inputs'].device
        sums = torch.empty((rounds, 2), dtype=torch.float32, device=device)
        mine = [torch.empty((rounds,) + tuple(p.shape), dtype=p.dtype,
                            device=device) for p in state.params]
        for r in range(rounds):
            rows_g = slice((rank * rounds + r) * part,
                           (rank * rounds + r + 1) * part)
            logits = state.model(batch['inputs'][rows_g])
            with torch.profiler.record_function('cross_entropy'):
                mask = batch.get('mask')
                losses, maskf = _token_losses(
                    logits, batch['targets'][rows_g],
                    None if mask is None else mask[rows_g])
                loss_sum = torch.sum(losses * maskf)
            grads = torch.autograd.grad(loss_sum, state.params)
            sums[r, 0] = loss_sum.detach()
            sums[r, 1] = torch.sum(maskf)
            for m, g in zip(mine, grads):
                m[r] = g
            del grads, logits, losses
        # The groups' gradients move in the param dtype (the reference
        # gathers its grads tree and casts to fp32 in the combine).
        total = _fixed_combine(sums, state, canonical_dp)
        total_mask = total[1]
        grads = []
        for m, p in zip(mine, state.params):
            summed = _fixed_combine(m.reshape(rounds, -1), state,
                                    canonical_dp)
            grads.append((summed / total_mask).view(p.shape).to(p.dtype))
        del mine
        with torch.profiler.record_function('optimizer'):
            grad_norm = state.apply_gradients(grads)
        return {'loss': total[0] / total_mask, 'grad_norm': grad_norm,
                'step': state.count}

    return step


def step_collectives(step_fn, state: TrainState,
                     batch: Dict[str, torch.Tensor]) -> tuple:
    """(metrics, collective counts) of one train step: the counterpart of
    the reference's compiled_step_collectives (skypilot_tpu/train/
    trainer.py:497-521) under its keys: all_reduce, all_gather,
    reduce_scatter, partition_scatter, collective_permute (a ring hop;
    0 off the ring) and reduce_scatter_effective (native + partition).
    The port has no HLO to parse, so it counts the collectives this step
    made through the state's group; callers probe the loop's first step,
    so no batch is skipped or trained twice. The host agreement between
    steps (TrainGroup.any) is not a step collective and is not
    counted. Under tp, `tensor_all_reduce` is the share of all_reduce
    made over the group's `tensor`."""
    from skypilot_tpu_torch.parallel.mesh import STEP_COLLECTIVES
    counts = (state.group.counts if state.group is not None
              else lambda: dict.fromkeys(STEP_COLLECTIVES, 0))
    tensor = state.group.tensor if state.group is not None else None
    before = counts()
    tensor_before = tensor.own['all_reduce'] if tensor is not None else 0
    metrics = step_fn(state, batch)
    after = counts()
    stats = {k: int(after[k] - before[k]) for k in STEP_COLLECTIVES}
    stats['reduce_scatter_effective'] = (stats['reduce_scatter'] +
                                         stats['partition_scatter'])
    if tensor is not None:
        stats['tensor_all_reduce'] = int(tensor.own['all_reduce'] -
                                         tensor_before)
    return metrics, stats


def make_eval_step(sp: Optional[int] = None
                   ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                 torch.Tensor]:
    """Forward-only loss (no grads, no state mutation) of the whole
    batch; `sp` N runs a ring model's attention in one process
    (use_sequence_parallel(sp=N)), as a per-rank run's ranks score a
    whole batch each."""

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with (sharding.use_sequence_parallel(sp) if sp
              else contextlib.nullcontext()):
            return _loss(state.model, batch)

    return step


def synthetic_batch(gen: torch.Generator, batch_size: int, seq_len: int,
                    vocab_size: int) -> Dict[str, torch.Tensor]:
    """Deterministic synthetic LM batch on the generator's device."""
    tokens = torch.randint(0, vocab_size, (batch_size, seq_len + 1),
                           generator=gen, device=gen.device,
                           dtype=torch.int64)
    return {
        'inputs': tokens[:, :-1],
        'targets': tokens[:, 1:],
        'mask': torch.ones((batch_size, seq_len), dtype=torch.int32,
                           device=gen.device),
    }
