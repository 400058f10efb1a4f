"""The reference's Mixture-of-Experts block (Mixtral, DBRX) in PyTorch.

Port of skypilot_tpu/models/moe.py. A router picks each token's top-k
experts (fp32 logits; on equal logits the lower expert index first, as
jax.lax.top_k orders them) and a softmax over the k values weighs them.
Two formulations, by `cfg.moe_impl`:

- 'dispatch' (the default): GShard capacity dispatch. Tokens form groups
  of `group_size(B·T)`; each expert takes at most
  `capacity = int(ceil(gs·k / E) · moe_capacity_factor)` tokens a group,
  clamped to [1, gs]. Each (token, choice) gets its place in its
  expert's buffer in GShard's order, first choices before second
  choices, then token order; those at or past the capacity are dropped
  (they add nothing). Every row of one call shares the capacity, so a
  row's output depends on the other rows of the call.
- 'dense': every expert runs every token, and a one-hot combine keeps
  each token's k (exact, E/k times the expert products; the reference
  keeps it for tiny configs and as the correctness yardstick).

Where the reference builds one-hot dispatch and combine tensors and
contracts them with einsums, the port gathers: each capacity slot names
the one token that fills it (a scatter of token indices that writes and
does not add; dropped choices write to slots of their own past the
buffers), the expert buffers are a gather of the token rows, and the
combine gathers each choice's expert output back and sums the k choices
in their order. Every shape is static and no step reads a value on the
host, so the block runs inside the serving engine's CUDA graphs. The
expert products are batched over the experts (`torch.bmm`): remat
'dots' saves only unbatched products, as the reference's
dots_with_no_batch_dims_saveable does, so no expert's activations are
kept for the backward.

Numerics follow the reference: tokens enter the expert buffers in the
compute dtype, the products run in the compute dtype, and the expert
outputs are weighed by `probs * keep` in fp32 and summed there before
the cast back.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
from torch import nn

from skypilot_tpu_torch.models.configs import ModelConfig

# torch.profiler ranges over the block's steps, opened only while a
# profiler runs (entering one costs host time).
RANGES = ('moe_route', 'moe_dispatch', 'moe_experts', 'moe_combine')


def _range(name: str):
    if torch.autograd.profiler._is_profiler_enabled:  # pylint: disable=protected-access
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def route(x: torch.Tensor, router: torch.Tensor,
          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., d), router (d, E) → (top-k expert indices (..., k) int64,
    their softmax weights (..., k) fp32). The logits are fp32; a stable
    descending sort keeps the lower expert index first on equal logits."""
    with _range('moe_route'):
        logits = x.float() @ router.float()
        values, idx = torch.sort(logits, dim=-1, descending=True,
                                 stable=True)
        return idx[..., :k], torch.softmax(values[..., :k], dim=-1)


def group_size(g: int) -> int:
    """The reference's `_group_size`: the largest power of two <= 1024
    dividing g; an odd count up to 4096 is one group."""
    gs = 1
    while gs * 2 <= min(g, 1024) and g % (gs * 2) == 0:
        gs *= 2
    if gs == 1 and g <= 4096:
        return g
    return gs


def capacity(gs: int, k: int, e: int, factor: float) -> int:
    """Slots per expert per group: the reference's expression, clamped
    to [1, gs]."""
    c = int(-(-gs * k // e) * factor)
    return max(1, min(c, gs))


def positions(idx: torch.Tensor, e: int) -> torch.Tensor:
    """idx (N, gs, k) expert choices of N groups → (N, gs, k) place of
    each (token, choice) in its expert's buffer: the count of earlier
    assignments to the same expert in GShard's k-major order."""
    n, gs, k = idx.shape
    order = idx.transpose(1, 2).reshape(n, k * gs)
    onehot = (order[..., None] == torch.arange(e, device=idx.device)).to(
        torch.int32)                                         # (N, k·gs, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = (before * onehot).sum(dim=-1)                      # (N, k·gs)
    return pos.reshape(n, k, gs).transpose(1, 2)


def _experts(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """(E, R, d) rows of each expert → (E, R, d): SiLU(x·gate) * (x·up),
    then ·down, batched over the experts."""
    with _range('moe_experts'):
        h = nn.functional.silu(torch.bmm(xs, w_gate)) * torch.bmm(xs, w_up)
        return torch.bmm(h, w_down)


def dense(x: torch.Tensor, idx: torch.Tensor, probs: torch.Tensor,
          w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """The reference's `_dense`: every expert on every token, combined in
    fp32 by the (..., E) map of each token's k weights."""
    e, d = w_gate.shape[0], x.shape[-1]
    combine = ((idx[..., None] == torch.arange(e, device=x.device)).float()
               * probs[..., None]).sum(dim=-2)               # (..., E)
    xs = x.reshape(1, -1, d).to(dtype).expand(e, -1, -1)
    out = _experts(xs, w_gate.to(dtype), w_up.to(dtype), w_down.to(dtype))
    out = (out.float() * combine.reshape(-1, e).t()[..., None]).sum(dim=0)
    return out.reshape(x.shape).to(dtype)


def dispatch(x: torch.Tensor, idx: torch.Tensor, probs: torch.Tensor,
             w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             capacity_factor: float, dtype: torch.dtype) -> torch.Tensor:
    """The reference's `_dispatch`: x (B, T, d), idx/probs (B, T, k) from
    `route` → (B, T, d) in `dtype`, each token's kept choices' expert
    outputs weighed by their probabilities (which choices are kept
    follows from idx alone: `positions` < `capacity`)."""
    e = w_gate.shape[0]
    b, s, d = x.shape
    k = idx.shape[-1]
    g = b * s
    gs = group_size(g)
    n = g // gs
    cap = capacity(gs, k, e, capacity_factor)
    dev = x.device
    with _range('moe_dispatch'):
        idx = idx.reshape(n, gs, k)
        pos = positions(idx, e)
        keep = pos < cap                                      # (N, gs, k)
        # Slot of each kept (token, choice) in the (E, N, C) buffers,
        # flat; each dropped one gets a slot of its own past them.
        group = torch.arange(n, device=dev)[:, None, None]
        slot = (idx * n + group) * cap + pos
        spare = e * n * cap + torch.arange(g * k, device=dev).reshape(
            n, gs, k)
        slot = torch.where(keep, slot, spare).reshape(-1)
        token = torch.arange(g, device=dev)[:, None].expand(g, k).reshape(-1)
        # Which token fills each slot; g (a zero row) where none does.
        filler = torch.full((e * n * cap + g * k,), g, dtype=torch.int64,
                            device=dev)
        filler = filler.scatter(0, slot, token)[:e * n * cap]
        rows = torch.cat([x.reshape(g, d).to(dtype),
                          x.new_zeros((1, d), dtype=dtype)])
        xs = rows.index_select(0, filler).reshape(e, n * cap, d)
    out = _experts(xs, w_gate.to(dtype), w_up.to(dtype), w_down.to(dtype))
    # Combine: each choice's expert row back in fp32, weighed by
    # probs * keep (a dropped choice reads some slot, weighed by 0), the
    # k choices summed in order.
    with _range('moe_combine'):
        out = out.reshape(e * n * cap, d)
        back = torch.where(keep, slot.reshape(n, gs, k), 0).reshape(-1)
        weights = (probs.reshape(n, gs, k).float() * keep).reshape(g, k, 1)
        picked = out.index_select(0, back).float().reshape(g, k, d) * weights
        total = picked[:, 0]
        for j in range(1, k):
            total = total + picked[:, j]
        return total.reshape(b, s, d).to(dtype)


class MoEBlock(nn.Module):
    """The reference's MoEBlock: `router` (d, E), `w_gate` / `w_up`
    (E, d, M) and `w_down` (E, M, d), made as the dense projections are
    (models/transformer._new_param: frozen under LoRA training, which
    puts no adapter on the experts, as in the reference)."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        from skypilot_tpu_torch.models.transformer import (
            _new_param as new_param)
        e, d, m = cfg.num_experts, cfg.d_model, cfg.d_mlp
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.router = new_param(cfg, (d, e), device)
        self.w_gate = new_param(cfg, (e, d, m), device)
        self.w_up = new_param(cfg, (e, d, m), device)
        self.w_down = new_param(cfg, (e, m, d), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        idx, probs = route(x, self.router, cfg.experts_per_token)
        weights = (self.w_gate, self.w_up, self.w_down)
        if cfg.moe_impl == 'dense':
            return dense(x, idx, probs, *weights, self.dtype)
        if cfg.moe_impl != 'dispatch':
            # A typo must not switch semantics (dispatch drops
            # over-capacity tokens; dense is exact).
            raise ValueError(f'Unknown moe_impl {cfg.moe_impl!r}; expected '
                             f"'dispatch' or 'dense'.")
        return dispatch(x, idx, probs, *weights, cfg.moe_capacity_factor,
                        self.dtype)
