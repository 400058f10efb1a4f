"""Training: state, optimizer and the train steps, on one card, with the
batch split over a data-parallel group (`dp`, with or without ZeRO-1, and
the extent-invariant elastic step) or with the sequence split over an
`sp` ring.

Port of skypilot_tpu/train/trainer.py without the mesh's fsdp, tp, ep
and pp axes or the pipeline. A step is: forward over the whole sequence
(attention through the flash kernels, or the ring under sequence
parallelism) → masked cross-entropy → backward → optax's
clip_by_global_norm → optax's adamw with the warmup-cosine schedule.

Data parallelism (a TrainState of a parallel/mesh.TrainGroup): ranks are
symmetric processes. Every rank holds the same global batch and takes
rows [r B/dp, (r + 1) B/dp) of it (of each microbatch under grad_accum),
so the data order is the same at any extent; the loss is the global
masked mean (each rank's Σ loss·mask over the global Σ mask, which every
rank reads off the batch), the rank's gradients are its share of it, and
the shares are summed in fp32 once per optimizer step. ZeRO-1 and the
elastic step: TrainState and make_elastic_train_step.

Sequence parallelism (`make_train_step(sp=N)` or `(group=g)`) comes in
the two forms of ops/ring_attention.py. In one process the model sees
the whole sequence and only attention is split (the reference's sp mesh
on one host): the step is the plain step inside the sp context. Per rank
(one process per ring position of the group) each process takes columns
[r S/sp, (r + 1) S/sp) of inputs, targets and mask; the loss is the
global masked mean (Σ loss·mask and Σ mask all-reduced over the group);
each rank's gradients are its share of that mean, and they are summed
over the group in fp32 before the update, so clipping sees the global
norm and every rank applies the same update (the reference's
replicated-over-sp parameters under jit).

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
import torch.distributed as dist

from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.ops import limits
from skypilot_tpu_torch.parallel import sharding


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
        self.zero1 = zero1 and self.dp > 1
        self.zero_dims = [
            sharding.zero_update_dim(p.shape, self.dp) if self.zero1
            else None for p in self.params]
        # What AdamW updates: each leaf, or under ZeRO-1 this rank's slice.
        self.updated = [p if d is None else self._own_slice(p, d)
                        for p, d in zip(self.params, self.zero_dims)]
        self.optimizer = torch.optim.AdamW(
            self.updated, lr=0.0, betas=(tc.b1, tc.b2), eps=1e-8,
            weight_decay=tc.weight_decay, fused=True)
        self.count = 0

    def _slice(self, value: torch.Tensor, dim: int,
               rank: Optional[int] = None) -> torch.Tensor:
        return sharding.zero_shard(value, dim, self.dp, self.group.rank
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
    def apply_gradients(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """clip_by_global_norm then adamw, in place. Returns the global
        norm of the UNCLIPPED grads (the reference's metric)."""
        tc = self.tc
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
        gathered = self.group.all_gather(flat)
        del flat
        start = 0
        for p, u, d in sliced:
            size = u.numel() * u.element_size()
            view = self._is_view(u, p)
            for rank in range(self.dp):
                if view and rank == self.group.rank:
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

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state['model'])
        self.optimizer.load_state_dict(state['optimizer'])
        self.count = int(state['count'])


def create_train_state(cfg: ModelConfig, train_config: Optional[TrainConfig]
                       = None, device='cuda', seed: int = 0, group=None,
                       zero1: bool = False) -> TrainState:
    """A TrainState with seeded random weights (models/transformer
    init_random_, the reference's distributions; every rank of a group
    draws the same) on `device`, `group` and `zero1` as TrainState's. On
    CUDA a model whose attention the kernels cannot take is refused here
    (ops/limits.py), before any step."""
    if cfg.decode:
        raise ValueError('training runs the full-sequence path; '
                         'cfg.decode must be False')
    impl = cfg.attention_impl
    if torch.device(device).type == 'cuda' and impl in (
            'auto', 'pallas', 'ring') and not (
                impl == 'auto' and cfg.attn_logit_softcap):
        # Attention goes through the flash (and ring) kernels on the card.
        limits.check_kernel_shapes(cfg.head_dim)
    model = Transformer(cfg, device=device).init_random_(seed)
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


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token loss (`_token_losses`), masked mean
    sum(loss * mask) / max(sum(mask), 1)."""
    losses, maskf = _token_losses(logits, targets, mask)
    if mask is not None:
        return torch.sum(losses * maskf) / torch.clamp(torch.sum(maskf),
                                                        min=1.0)
    return torch.mean(losses)


def _loss(model: Transformer, batch: Dict[str, torch.Tensor]
          ) -> torch.Tensor:
    logits = model(batch['inputs'])
    # Named ranges (here and around the optimizer) let a torch.profiler
    # trace attribute device time to them; free when not profiling.
    with torch.profiler.record_function('cross_entropy'):
        return cross_entropy_loss(logits, batch['targets'],
                                  batch.get('mask'))


def _rank_loss(model: Transformer, batch: Dict[str, torch.Tensor],
               ctx: sharding.SequenceParallel) -> torch.Tensor:
    """This rank's share of the global masked-mean loss: its columns'
    Σ loss·mask over the group's Σ mask (the denominator all-reduced and
    held constant, as the mask is)."""
    seq = batch['inputs'].shape[1]
    if seq % ctx.sp:
        raise ValueError(f'sequence {seq} is not divisible by sp={ctx.sp}')
    chunk = seq // ctx.sp
    cols = slice(ctx.rank * chunk, (ctx.rank + 1) * chunk)
    logits = model(batch['inputs'][:, cols])
    with torch.profiler.record_function('cross_entropy'):
        mask = batch.get('mask')
        losses, mask = _token_losses(logits, batch['targets'][:, cols],
                                     None if mask is None else mask[:, cols])
        count = mask.sum().detach()
        dist.all_reduce(count, group=ctx.group)
        return torch.sum(losses * mask) / torch.clamp(count, min=1.0)


def _row_loss(state: TrainState, batch: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
    """This rank's share of the global masked-mean loss under data
    parallelism: its rows' Σ loss·mask over the global batch's Σ mask
    (every rank holds the global batch, so the denominator needs no
    collective)."""
    rows = batch['inputs'].shape[0]
    if rows % state.dp:
        raise ValueError(f'batch {rows} is not divisible by dp={state.dp}')
    part = rows // state.dp
    mine = slice(state.group.rank * part, (state.group.rank + 1) * part)
    mask = batch.get('mask')
    count = (mask.float().sum() if mask is not None else torch.tensor(
        float(batch['targets'].numel()), device=batch['inputs'].device))
    logits = state.model(batch['inputs'][mine])
    with torch.profiler.record_function('cross_entropy'):
        losses, maskf = _token_losses(logits, batch['targets'][mine],
                                      None if mask is None else mask[mine])
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


def make_train_step(grad_accum: int = 1, *, sp: Optional[int] = None,
                    group=None
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
    the model's attention_impl 'ring'); `group` g (a torch.distributed
    group) runs it per rank of g (module docstring).

    A state of a data-parallel group (TrainState's `group`, dp > 1) runs
    the step on the rank's rows of each microbatch and sums the shares
    once per optimizer step: one all-reduce, which ZeRO-1 counts as its
    partition scatter (TrainState). Either way the caller passes the
    global batch."""
    if sp is not None or group is not None:
        sharding.sequence_parallel(sp, group=group)       # validate now
    per_rank = group is not None

    def loss_and_grads(state: TrainState, batch):
        if per_rank:
            loss = _rank_loss(state.model, batch,
                              sharding.current_sequence_parallel())
        elif state.dp > 1:
            loss = _row_loss(state, batch)
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
        if state.dp > 1 and (sp is not None or per_rank):
            raise ValueError(f'dp={state.dp} under sp is not ported '
                             f'({DP_SP_NEXT})')
        scope = (sharding.use_sequence_parallel(sp, group=group)
                 if sp is not None or per_rank
                 else contextlib.nullcontext())
        with scope:
            loss, grads = grads_of(state, batch)
            if per_rank:
                loss, grads = _sum_over_ranks(
                    loss, grads, lambda x: dist.all_reduce(x, group=group))
            elif state.dp > 1:
                kind = 'partition_scatter' if state.zero1 else 'all_reduce'
                loss, grads = _sum_over_ranks(
                    loss, grads, lambda x: state.group.all_reduce(x, kind))
        grads = [g.to(p.dtype) for g, p in zip(grads, state.params)]
        with torch.profiler.record_function('optimizer'):
            grad_norm = state.apply_gradients(grads)
        return {'loss': loss.detach(), 'grad_norm': grad_norm,
                'step': state.count}

    return step


# Where ROADMAP.md has data parallelism over a sequence ring.
DP_SP_NEXT = 'ROADMAP.md §1 item 6: --dp with --sp'

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
    canonical_dp is refused with the reference's message."""
    if canonical_dp < 1:
        raise ValueError(f'canonical_dp must be >= 1, got {canonical_dp}')

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
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
    reduce_scatter, partition_scatter and reduce_scatter_effective
    (native + partition). The port has no HLO to parse, so it counts the
    collectives this step made through the state's group; callers probe
    the loop's first step, so no batch is skipped or trained twice. The
    host agreement between steps (TrainGroup.any) is not a step
    collective and is not counted."""
    from skypilot_tpu_torch.parallel.mesh import STEP_COLLECTIVES
    counts = (state.group.counts if state.group is not None
              else lambda: dict.fromkeys(STEP_COLLECTIVES, 0))
    before = counts()
    metrics = step_fn(state, batch)
    after = counts()
    stats = {k: int(after[k] - before[k]) for k in STEP_COLLECTIVES}
    stats['reduce_scatter_effective'] = (stats['reduce_scatter'] +
                                         stats['partition_scatter'])
    return metrics, stats


def make_eval_step() -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                 torch.Tensor]:
    """Forward-only loss (no grads, no state mutation)."""

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
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
