"""The autograd regions of tensor-parallel training: Megatron's *f* and
*g* and the vocab-parallel cross-entropy, each over the `tensor` group of
a parallel/mesh.TrainGroup (the tp ranks that share the other indices),
so every collective is one of the group's counted all-reduces.

The residual stream is replicated on every tp rank. A column-parallel
product (the fused qkv, gate/up, lm_head) reads it through `copy_to_tp`
(*f*): the identity forward, and in backward one all-reduce that sums
the ranks' parts of the input's gradient. A row-parallel product (o,
down) and the vocab-parallel embedding end in `reduce_from_tp` (*g*):
one all-reduce forward, the identity backward. The reference gets the
same collectives from GSPMD over its logical rules
(skypilot_tpu/parallel/sharding.py:18-36).

The loss reads each rank's slice of the vocabulary
(`vocab_parallel_cross_entropy`): per token, the max, the sum of exps
and the target's logit each take one all-reduce, in fp32; the gradient
is softmax - onehot on the rank's own slice, with no collective.
"""
from __future__ import annotations

import torch


class _CopyToTP(torch.autograd.Function):
    """*f*: identity forward; backward sums the gradient over the
    group."""

    @staticmethod
    def forward(ctx, x, group):  # pylint: disable=arguments-differ
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous().clone()), None


class _ReduceFromTP(torch.autograd.Function):
    """*g*: forward sums the ranks' partial products over the group;
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):  # pylint: disable=arguments-differ
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """`x` entering a column-parallel region (Megatron's *f*)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of the ranks' partial `x` leaving a
    row-parallel region (Megatron's *g*)."""
    return _ReduceFromTP.apply(x, group)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross-entropy from each rank's vocab slice (module
    docstring)."""

    @staticmethod
    def forward(ctx, logits, targets,  # pylint: disable=arguments-differ
                group):
        width = logits.shape[-1]
        x = logits.float()
        top = group.all_reduce(x.amax(dim=-1), op='max')
        exp = torch.exp(x - top[..., None])
        total = group.all_reduce(exp.sum(dim=-1))
        local = targets.long() - group.rank * width
        inside = (local >= 0) & (local < width)
        local = local.clamp(0, width - 1)
        picked = x.gather(-1, local[..., None])[..., 0]
        target = group.all_reduce(torch.where(inside, picked,
                                              torch.zeros_like(picked)))
        losses = torch.log(total) + top - target
        ctx.save_for_backward(exp, total, local, inside)
        ctx.dtype = logits.dtype
        return losses

    @staticmethod
    def backward(ctx, grad):
        exp, total, local, inside = ctx.saved_tensors
        out = exp / total[..., None]
        out.scatter_add_(-1, local[..., None],
                         -inside[..., None].to(out.dtype))
        out.mul_(grad[..., None])
        return out.to(ctx.dtype), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 group) -> torch.Tensor:
    """(...,) fp32 per-token losses logsumexp(logits) - logits[target]
    over the whole vocabulary, from this rank's (..., vocab / tp) slice
    `logits` (rank r's at [r vocab / tp, (r + 1) vocab / tp), the final
    softcap and the padded-vocab mask applied) and the global `targets`;
    three all-reduces over `group`."""
    return _VocabParallelCE.apply(logits, targets, group)
