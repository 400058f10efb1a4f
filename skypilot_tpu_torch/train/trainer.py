"""Training: state, optimizer and the train step, on one card or with
the sequence split over an `sp` ring.

Port of skypilot_tpu/train/trainer.py without the mesh's other axes,
pipeline or LoRA. A step is: forward over the whole sequence (attention
through the flash kernels, or the ring under sequence parallelism) →
masked cross-entropy → backward → optax's clip_by_global_norm → optax's
adamw with the warmup-cosine schedule.

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
    dtype, update count). Params and moments update in place."""

    def __init__(self, model: Transformer, tc: TrainConfig) -> None:
        self.model = model
        self.tc = tc
        self.params = list(model.parameters())
        self.optimizer = torch.optim.AdamW(
            self.params, lr=0.0, betas=(tc.b1, tc.b2), eps=1e-8,
            weight_decay=tc.weight_decay, fused=True)
        self.count = 0

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
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.param_groups[0]['lr'] = learning_rate_at(tc,
                                                                self.count)
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return norm

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
                       = None, device='cuda', seed: int = 0) -> TrainState:
    """A TrainState with seeded random weights (models/transformer
    init_random_, the reference's distributions) on `device`. On CUDA a
    model whose attention the kernels cannot take is refused here
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
    return TrainState(model, train_config or TrainConfig())


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token loss; logits in fp32 for a stable softmax:
    logsumexp(logits) - logits[target] (optax's
    softmax_cross_entropy_with_integer_labels), masked mean
    sum(loss * mask) / max(sum(mask), 1)."""
    logits = logits.float()
    losses = (torch.logsumexp(logits, dim=-1) -
              logits.gather(-1, targets.long()[..., None])[..., 0])
    if mask is not None:
        mask = mask.float()
        return torch.sum(losses * mask) / torch.clamp(torch.sum(mask),
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
        logits = logits.float()
        targets = batch['targets'][:, cols]
        losses = (torch.logsumexp(logits, dim=-1) -
                  logits.gather(-1, targets.long()[..., None])[..., 0])
        mask = batch.get('mask')
        mask = (torch.ones_like(losses) if mask is None
                else mask[:, cols].float())
        count = mask.sum().detach()
        dist.all_reduce(count, group=ctx.group)
        return torch.sum(losses * mask) / torch.clamp(count, min=1.0)


def _sum_over_ranks(loss: torch.Tensor, grads: List[torch.Tensor],
                    group) -> tuple:
    """The global loss and gradients from each rank's share: one fp32
    all-reduce (sum) of the loss and every gradient, flattened."""
    flat = torch.cat([loss.detach().float().reshape(1)] +
                     [g.float().reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
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
    the model's attention_impl 'ring'); `group` g runs it per rank of g
    (module docstring). Either way the caller passes the global batch."""
    if sp is not None or group is not None:
        sharding.sequence_parallel(sp, group=group)       # validate now
    per_rank = group is not None

    def loss_and_grads(state: TrainState, batch):
        if per_rank:
            loss = _rank_loss(state.model, batch,
                              sharding.current_sequence_parallel())
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
        scope = (sharding.use_sequence_parallel(sp, group=group)
                 if sp is not None or group is not None
                 else contextlib.nullcontext())
        with scope:
            loss, grads = grads_of(state, batch)
            if per_rank:
                loss, grads = _sum_over_ranks(loss, grads, group)
        grads = [g.to(p.dtype) for g, p in zip(grads, state.params)]
        with torch.profiler.record_function('optimizer'):
            grad_norm = state.apply_gradients(grads)
        return {'loss': loss.detach(), 'grad_norm': grad_norm,
                'step': state.count}

    return step


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
