"""Full-sequence (training) attention: three hand-written CUDA kernels and
their plain twins, bound into one autograd Function.

Replaces the TPU kernels of skypilot_tpu/ops/flash_attention.py:
`_fwd_kernel` (O and the per-row logsumexp), `_bwd_dq_kernel` (dQ) and
`_bwd_dkv_kernel` (dK, dV). The kernels live in
ops/csrc/flash_attention.cu (sm_90a, built at first use by ops/_build.py
and called through ctypes); its source comment says what bounds each one
on the H100 and what the design does about it.

Layout: the public entry keeps the reference's (B, S, H, D) tensors. The
kernels read them through their strides (the fused q/k/v projection's
column slices need no copy) and index KV head `h // n_rep` themselves,
so K/V are never repeated in memory; the dK/dV kernel sums the n_rep
query heads of a group in fp32 before it writes. lse and delta are
(B, H, S) fp32: the port's own layout (the reference's (BH, 1, S) was a
TPU tiling constraint).

Each wrapper (`flash_forward`, `flash_dq`, `flash_dkv`) launches its
kernel on a CUDA tensor or raises: a build or launch failure is an
error, never a quiet switch to the plain version. Only a tensor that
lies on the CPU takes the plain version. `<wrapper>.launches` counts
kernel launches, so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build, limits

_NEG_INF = -1e30
_HEAD_DIMS = limits.HEAD_DIMS
_GROUPED_ROWS = 128     # rows of the bf16 forward's and dQ's work tiles
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = ('auto', 'pallas', 'pallas_interpret', 'xla', 'ring')


# --------------------------------------------------------------- plain path

def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    return x if n_rep == 1 else torch.repeat_interleave(x, n_rep, dim=2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, sm_scale: float,
                        logit_softcap: float = 0.0,
                        window: int = 0) -> torch.Tensor:
    """The reference's XLA path (`_reference_attention`), op for op:
    fp32 scores, optional tanh softcap, -1e30 mask, fp32 softmax,
    probabilities cast to the value dtype before the weighted sum.
    q: (B, S, H, D); k/v: (B, S, KV, D), repeated to H heads here."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    logits = logits * sm_scale
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if causal or window:
        logits = torch.where(_mask(logits.shape[-2], logits.shape[-1],
                                   window, logits.device),
                             logits, torch.full((), _NEG_INF,
                                                device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', probs, v)


def _mask(s_q: int, s_k: int, window: int, device) -> torch.Tensor:
    rows = torch.arange(s_q, device=device)[:, None] + (s_k - s_q)
    cols = torch.arange(s_k, device=device)[None, :]
    mask = cols <= rows
    if window:
        mask &= rows - cols < window
    return mask


def _grouped_scores(q, k, causal, sm_scale, window) -> torch.Tensor:
    """(B, KV, n_rep, S, S) fp32 scaled scores, masked to -1e30 (causal /
    window). Query head h reads KV head h // n_rep, as the reference's
    repeat does."""
    batch, seq, heads, head_dim = q.shape
    kv_heads = k.shape[2]
    qg = q.reshape(batch, seq, kv_heads, heads // kv_heads, head_dim)
    scores = torch.einsum('bqkrd,bskd->bkrqs', qg.float(), k.float())
    scores = scores * sm_scale
    if causal or window:
        scores = torch.where(_mask(seq, seq, window, q.device), scores,
                             torch.full((), _NEG_INF, device=q.device))
    return scores


def _grouped(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.reshape(b, s, kv_heads, h // kv_heads, d)


def _rows(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, H, S) per-row statistics → (B, KV, n_rep, S, 1)."""
    b, h, s = x.shape
    return x.reshape(b, kv_heads, h // kv_heads, s, 1)


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, sm_scale: float, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of `_fwd_kernel` over the whole sequence at once.
    Returns O (B, S, H, D) in q.dtype and lse (B, H, S) fp32, the per-row
    logsumexp of the SCALED logits, m + log(max(l, 1e-30)). p is cast to
    the input dtype before P·V while l sums it unrounded."""
    batch, seq, heads, head_dim = q.shape
    kv_heads = k.shape[2]
    scores = _grouped_scores(q, k, causal, sm_scale, window)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum('bkrqs,bskd->bkrqd', p.to(q.dtype).float(), v.float())
    out = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(
        batch, seq, heads, head_dim).to(q.dtype)
    lse = (m + torch.log(l_safe)).reshape(batch, heads, seq)
    return out, lse


def _probs_and_dscores(q, k, v, do, lse, delta, causal, sm_scale, window):
    kv_heads = k.shape[2]
    p = torch.exp(_grouped_scores(q, k, causal, sm_scale, window) -
                  _rows(lse, kv_heads))
    dp = torch.einsum('bqkrd,bskd->bkrqs', _grouped(do, kv_heads).float(),
                      v.float())
    return p, p * (dp - _rows(delta, kv_heads))


def flash_dq_plain(q, k, v, do, lse, delta, *, causal: bool,
                   sm_scale: float, window: int = 0) -> torch.Tensor:
    """Plain twin of `_bwd_dq_kernel`: rebuild p = exp(s - lse), then
    dp = dO·Vᵀ, ds = p·(dp - delta), dq = ds·K·sm_scale (ds cast to the
    input dtype before the product). Returns (B, S, H, D) in q.dtype."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, sm_scale,
                               window)
    dq = torch.einsum('bkrqs,bskd->bqkrd', ds.to(q.dtype).float(), k.float())
    return (dq * sm_scale).reshape(q.shape).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                    sm_scale: float, window: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of `_bwd_dkv_kernel` plus the reference's GQA sum:
    dv = pᵀ·dO and dk = dsᵀ·Q·sm_scale (p and ds cast to the input dtype
    before the products), summed over the n_rep query heads of each KV
    head in fp32 and rounded once. Returns (B, S, KV, D) each."""
    kv_heads = k.shape[2]
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, sm_scale,
                               window)
    dv = torch.einsum('bkrqs,bqkrd->bskd', p.to(q.dtype).float(),
                      _grouped(do, kv_heads).float())
    dk = torch.einsum('bkrqs,bqkrd->bskd', ds.to(q.dtype).float(),
                      _grouped(q, kv_heads).float())
    return (dk * sm_scale).to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels

def _lib() -> ctypes.CDLL:
    lib = _build.load('flash_attention')
    if not getattr(lib, '_flash_signatures_set', False):
        common = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 +
                  [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
        lib.flash_attention_forward.argtypes = [ctypes.c_void_p] * 5 + common
        lib.flash_attention_dq.argtypes = [ctypes.c_void_p] * 7 + common
        lib.flash_attention_dkv.argtypes = [ctypes.c_void_p] * 8 + common
        for fn in (lib.flash_attention_forward, lib.flash_attention_dq,
                   lib.flash_attention_dkv):
            fn.restype = ctypes.c_int
        lib._flash_signatures_set = True
    return lib


def _check(q, k, v, extra=()) -> None:
    """What every kernel takes: one CUDA device, one dtype (fp32 or
    bf16), (B, S, H|KV, D) with D in {64, 128, 256}, unit stride on D,
    every stride and pointer aligned for 16-byte loads (and for the bf16
    kernels' TMA tensor maps, which need 16-byte strides); bf16 at D <= 128
    at most 128 query heads per KV head (one grouped tile)."""
    tensors = (q, k, v, *extra)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f'flash attention kernels take float32 or '
                        f'bfloat16, got {q.dtype}')
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError('q, k, v (and dO) must share one dtype')
    if any(t.device != q.device for t in tensors):
        raise ValueError('all flash attention inputs must be on one device')
    batch, seq, heads, head_dim = q.shape
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f'flash attention kernels take head_dim in '
                         f'{_HEAD_DIMS}, got {head_dim}')
    if k.shape != v.shape or k.shape[:2] != (batch, seq) or \
            k.shape[3] != head_dim or heads % k.shape[2]:
        raise ValueError(f'k/v {tuple(k.shape)} do not fit q '
                         f'{tuple(q.shape)}')
    if q.dtype == torch.bfloat16 and head_dim <= 128 and \
            heads // k.shape[2] > _GROUPED_ROWS:
        raise ValueError(f'the bf16 flash kernels group the n_rep query '
                         f'heads of a KV head into {_GROUPED_ROWS}-row '
                         f'tiles: n_rep {heads // k.shape[2]} > '
                         f'{_GROUPED_ROWS}')
    vec = 16 // q.element_size()
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError('flash attention kernels need unit stride on '
                             'head_dim')
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError('flash attention kernels need strides that are '
                             f'multiples of {vec} elements and 16-byte '
                             'aligned pointers')


def _strides(*tensors) -> ctypes.Array:
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'flash attention {what} kernel launch failed: '
                           f'CUDA error {err}')


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _dims(q, k, sm_scale, causal, window):
    batch, seq, heads, head_dim = q.shape
    return (batch, seq, heads, k.shape[2], head_dim, float(sm_scale),
            int(causal), int(window), _DTYPE_CODE[q.dtype])


def _on_cuda(q: torch.Tensor) -> bool:
    if q.device.type == 'cpu':
        return False
    if q.device.type != 'cuda':
        raise ValueError(f'flash attention runs on cuda (kernels) or cpu '
                         f'(plain versions), not {q.device.type}')
    return True


def flash_forward(q, k, v, *, causal: bool, sm_scale: float,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """O (B, S, H, D) and lse (B, H, S) fp32: the forward kernel on a CUDA
    tensor, `flash_forward_plain` on a CPU tensor."""
    if not _on_cuda(q):
        return flash_forward_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                   window=window)
    _check(q, k, v)
    batch, seq, heads, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _strides(q, k, v),
            *_dims(q, k, sm_scale, causal, window), _stream(q.device))
    _raise_on(err, 'forward')
    flash_forward.launches += 1
    return out, lse


def flash_dq(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float,
             window: int = 0) -> torch.Tensor:
    """dQ (B, S, H, D): the dQ kernel on a CUDA tensor, `flash_dq_plain`
    on a CPU tensor. lse/delta: (B, H, S) fp32."""
    if not _on_cuda(q):
        return flash_dq_plain(q, k, v, do, lse, delta, causal=causal,
                              sm_scale=sm_scale, window=window)
    _check(q, k, v, (do,))
    _check_rows(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do), *_dims(q, k, sm_scale, causal, window),
            _stream(q.device))
    _raise_on(err, 'dQ')
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float,
              window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK, dV (B, S, KV, D), summed over each KV head's query heads: the
    dK/dV kernel on a CUDA tensor, `flash_dkv_plain` on a CPU tensor."""
    if not _on_cuda(q):
        return flash_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                               sm_scale=sm_scale, window=window)
    _check(q, k, v, (do,))
    _check_rows(q, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do), *_dims(q, k, sm_scale, causal, window),
            _stream(q.device))
    _raise_on(err, 'dK/dV')
    flash_dkv.launches += 1
    return dk, dv


def _check_rows(q, lse, delta) -> None:
    batch, seq, heads, _ = q.shape
    for t in (lse, delta):
        if t.dtype != torch.float32 or tuple(t.shape) != (batch, heads, seq) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError('lse and delta must be contiguous (B, H, S) '
                             'float32 on the device of q')


flash_forward.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


# ----------------------------------------------------------------- autograd

def backward_delta(out: torch.Tensor, grad_out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32 as (B, H, S), from the ROUNDED
    output (the reference forms it outside any kernel too). O is widened
    inside the product (exact), so only dO takes an fp32 copy."""
    delta = (grad_out.float() * out).sum(dim=-1)
    return delta.transpose(1, 2).contiguous()


class _Flash(torch.autograd.Function):
    """The reference's `jax.custom_vjp` `_flash`: saves (q, k, v, out,
    lse); the backward forms delta = rowsum(dO ∘ O) in fp32 from the
    ROUNDED output (the reference does this outside any kernel too), then
    runs dQ and dK/dV. `kernels` picks the wrappers (kernel on CUDA,
    plain on CPU) or, for impl='pallas_interpret', the plain pair."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window, kernels):
        fwd = flash_forward if kernels else flash_forward_plain
        out, lse = fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                       window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, window=window)
        ctx.kernels = kernels
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        delta = backward_delta(out, grad_out)
        if ctx.kernels:
            dq = flash_dq(q, k, v, grad_out, lse, delta, **ctx.opts)
            dk, dv = flash_dkv(q, k, v, grad_out, lse, delta, **ctx.opts)
        else:
            dq = flash_dq_plain(q, k, v, grad_out, lse, delta, **ctx.opts)
            dk, dv = flash_dkv_plain(q, k, v, grad_out, lse, delta,
                                     **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor,
                    k: torch.Tensor,
                    v: torch.Tensor,
                    *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None,
                    impl: str = 'auto',
                    logit_softcap: float = 0.0,
                    window: int = 0) -> torch.Tensor:
    """Multi-head attention with GQA over a whole sequence (the
    reference entry's contract and refusals).

    Args:
      q: (batch, seq, num_heads, head_dim)
      k/v: (batch, seq, num_kv_heads, head_dim); num_heads a multiple of
        num_kv_heads.
      impl: 'xla' is the reference's plain path (`reference_attention`);
        'auto' and 'pallas' run the CUDA kernels on a CUDA tensor and
        their plain versions on a CPU tensor; 'pallas_interpret' always
        runs the plain pair; 'ring' is sequence-parallel ring attention
        (ops/ring_attention.py) over the ambient context of
        parallel/sharding.use_sequence_parallel, and raises without one.
      logit_softcap: tanh cap on the logits, on the 'xla' path only.
      window: sliding window in keys (query r sees keys (r - window, r]);
        requires causal.

    The reference's block_q/block_k knobs are TPU tile sizes; the CUDA
    kernels pick their own tiles (bf16 at head_dim 64/128: the forward
    and dQ take 128 rows of n_rep grouped query heads against 64-key
    tiles, dK/dV 128-key tiles against 64-position (Q, dO) tiles; the
    others 64 rows up to head_dim 128, 32 at 256) and mask a ragged last
    tile, so any S works.
    """
    heads, head_dim = q.shape[2], q.shape[3]
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    if heads % k.shape[2]:
        raise ValueError(f'num_heads {heads} not divisible by kv heads '
                         f'{k.shape[2]}')
    if window and not causal:
        raise ValueError('window requires causal attention')
    if window < 0:
        raise ValueError(f'window must be >= 0, got {window}')
    if impl not in _IMPLS:
        raise ValueError(f'Unknown impl {impl!r}')
    if impl == 'auto' and logit_softcap:
        impl = 'xla'                 # the reference routes softcap to XLA
    if impl == 'xla':
        return reference_attention(q, k, v, causal, sm_scale, logit_softcap,
                                   window)
    if logit_softcap:
        raise ValueError(
            f'logit_softcap is only supported on the XLA attention path '
            f'(got impl={impl!r}); use attention_impl="xla" or "auto".')
    if impl == 'ring':
        # Sequence parallelism: the sequence cut into sp chunks, K/V
        # rotating around the ring (ops/ring_attention.py), in the form
        # the ambient context names (parallel/sharding.py).
        if window:
            raise ValueError('window is not supported on the ring path; '
                             'a sliding window makes ring rotation '
                             'unnecessary — shard the sequence instead.')
        from skypilot_tpu_torch.ops.ring_attention import \
            ring_attention_ambient
        return ring_attention_ambient(q, k, v, causal=causal,
                                      sm_scale=sm_scale)
    return _Flash.apply(q, k, v, causal, float(sm_scale), int(window),
                        impl != 'pallas_interpret')
