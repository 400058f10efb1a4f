"""Ring attention: exact attention over a sequence split into `sp` chunks,
K/V travelling around a ring of ranks (sequence parallelism).

Port of skypilot_tpu/ops/ring_attention.py. Its TPU kernel,
`_chunk_update_kernel` (one hop's online-softmax update), is the
hand-written CUDA kernel ops/csrc/ring_attention.cu, behind
`chunk_update`; `chunk_update_plain` is its plain twin, `_chunk_update`
op for op. The wrapper launches the kernel on a CUDA tensor or raises; a
tensor on the CPU takes the plain version. `chunk_update.launches`
counts kernel launches.

The ring comes in the reference's two forms, which make the same chunk
updates in the same order and so give the same bits:
- `ring_attention(q, k, v, group=...)`: per rank, over a training
  group's `ring` (parallel/mesh.TrainGroup) or a `torch.distributed`
  group (the reference's `ring_attention` under `shard_map`). Each
  process holds its (B, S/sp, H|KV, D) chunk; K/V rotate one hop per
  step through the group's counted `permute` ('collective_permute', the
  reference's ring hop: one `batch_isend_irecv`, NCCL across cards, gloo
  on the CPU, or gloo through the host for ranks that share a card).
- `ring_attention_sharded(q, k, v, sp=...)`: one process, global
  (B, S, H|KV, D) tensors (the reference's `ring_attention_sharded` on a
  mesh whose sp devices share one host). It runs every rank's hops in
  turn on one device over chunk views: a rotation is an index.
`ring_attention_ambient` picks the form from the ambient context of
parallel/sharding.use_sequence_parallel; flash_attention(impl='ring')
calls it.

Hops follow the reference (`ring_attention` :190-230): hop i attends the
local Q chunk to the K/V chunk of rank (r - i) mod sp, skips future
chunks under causal, masks the own chunk causally and attends past
chunks fully; the output is o / max(l, 1e-30).

K/V stay at KV heads: the kernel and the plain version index KV head
h // n_rep themselves, and the ring rotates KV-head chunks (the
reference repeats K/V to H heads before its ring).

The gradient is `_Ring`, an autograd Function (the reference has no
backward kernel; JAX differentiates through its loop). Its backward
replays the ring with the flash dQ and dK/dV kernels of
ops/flash_attention.py on each visited (Q chunk, K/V chunk) pair, fed the
ring's global logsumexp, so p = exp(s - lse) is each pair's exact share
of the global softmax; delta = rowsum(dO * O) comes from the rounded
output, as `_Flash` forms it. dQ accumulates locally; dK/dV accumulators
travel with K/V and arrive home after sp rotations. Sums are fp32 and
cast once; each hop's dq, dk, dv come out of the kernels in the input
dtype (bf16 rounds each hop's share before the fp32 sum).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build, limits
from skypilot_tpu_torch.ops import flash_attention as fa

_NEG_INF = -1e30
_HEAD_DIMS = limits.HEAD_DIMS
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------- plain path

def chunk_update_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, *,
                       sm_scale: float, mask_mode: int, q_offset: int,
                       k_offset: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's `_chunk_update` op for op: one online-softmax
    accumulation step of the Q chunk against one K/V chunk.
    q (B, Sq, H, D); k/v (B, Sk, KV, D), query head h reading KV head
    h // n_rep; o (B, Sq, H, D) fp32; m/l (B, H, Sq) fp32. mask_mode 0
    attends fully, 1 masks keys past each query across the offsets to
    -1e30. Scores fp32; p rounded to v.dtype before P·V, whose result is
    rounded to v.dtype and widened. Returns new (o, m, l)."""
    batch, s_q, heads, head_dim = q.shape
    s_k, kv_heads = k.shape[1], k.shape[2]
    n_rep = heads // kv_heads
    qg = q.reshape(batch, s_q, kv_heads, n_rep, head_dim)
    s = torch.einsum('bqkrd,bskd->bkrqs', qg.float(), k.float())
    s = s.reshape(batch, heads, s_q, s_k) * sm_scale
    if mask_mode == 1:
        rows = q_offset + torch.arange(s_q, device=q.device)[:, None]
        cols = k_offset + torch.arange(s_k, device=q.device)[None, :]
        s = torch.where(cols <= rows, s,
                        torch.full((), _NEG_INF, device=q.device))
    m_cur = s.amax(dim=-1)                              # (B, H, Sq)
    m_new = torch.maximum(m, m_cur)
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pg = p.to(v.dtype).float().reshape(batch, kv_heads, n_rep, s_q, s_k)
    pv = torch.einsum('bkrqs,bskd->bqkrd', pg, v.float()).to(v.dtype)
    o_new = (o * alpha.transpose(1, 2)[..., None] +
             pv.float().reshape(batch, s_q, heads, head_dim))
    return o_new, m_new, l_new


# ------------------------------------------------------------------- kernel

def _lib() -> ctypes.CDLL:
    lib = _build.load('ring_attention')
    if not getattr(lib, '_ring_signatures_set', False):
        lib.ring_chunk_update.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_longlong)] +
            [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 4 +
            [ctypes.c_void_p])
        lib.ring_chunk_update.restype = ctypes.c_int
        lib._ring_signatures_set = True
    return lib


def _check(q, k, v, o, m, l) -> None:
    """What the kernel takes: one CUDA device; q, k, v of one dtype
    (fp32 or bf16), (B, Sq, H, D) and (B, Sk, KV, D) with D in
    {64, 128, 256}, unit stride on D, strides and pointers aligned for
    16-byte loads; o, m, l contiguous fp32 of the state's shapes."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f'the ring chunk kernel takes float32 or bfloat16, '
                        f'got {q.dtype}')
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError('q, k, v must share one dtype')
    if any(t.device != q.device for t in (k, v, o, m, l)):
        raise ValueError('all ring chunk inputs must be on one device')
    batch, s_q, heads, head_dim = q.shape
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f'the ring chunk kernel takes head_dim in '
                         f'{_HEAD_DIMS}, got {head_dim}')
    if k.shape != v.shape or k.shape[0] != batch or \
            k.shape[3] != head_dim or heads % k.shape[2]:
        raise ValueError(f'k/v {tuple(k.shape)} do not fit q '
                         f'{tuple(q.shape)}')
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError('the ring chunk kernel needs unit stride on '
                             f'head_dim, strides that are multiples of {vec} '
                             'elements and 16-byte aligned pointers')
    for t, shape in ((o, q.shape), (m, (batch, heads, s_q)),
                     (l, (batch, heads, s_q))):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or \
                not t.is_contiguous():
            raise ValueError('o (B, Sq, H, D) and m, l (B, H, Sq) must be '
                             'contiguous float32')


def chunk_update(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, *,
                 sm_scale: float, mask_mode: int, q_offset: int,
                 k_offset: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """New (o, m, l): the ring chunk kernel on a CUDA tensor,
    `chunk_update_plain` on a CPU tensor. Same arguments."""
    if mask_mode not in (0, 1):
        raise ValueError(f'mask_mode must be 0 or 1, got {mask_mode}')
    opts = dict(sm_scale=sm_scale, mask_mode=mask_mode, q_offset=q_offset,
                k_offset=k_offset)
    if q.device.type == 'cpu':
        return chunk_update_plain(q, k, v, o, m, l, **opts)
    if q.device.type != 'cuda':
        raise ValueError(f'ring attention runs on cuda (kernel) or cpu '
                         f'(plain version), not {q.device.type}')
    _check(q, k, v, o, m, l)
    batch, s_q, heads, head_dim = q.shape
    o_new = torch.empty_like(o)
    m_new = torch.empty_like(m)
    l_new = torch.empty_like(l)
    with torch.cuda.device(q.device):
        err = _lib().ring_chunk_update(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), o_new.data_ptr(), m_new.data_ptr(),
            l_new.data_ptr(), fa._strides(q, k, v), batch, s_q, k.shape[1],
            heads, k.shape[2], head_dim, float(sm_scale), int(mask_mode),
            int(q_offset), int(k_offset), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ring chunk kernel launch failed: CUDA error '
                           f'{err}')
    chunk_update.launches += 1
    return o_new, m_new, l_new


chunk_update.launches = 0


# --------------------------------------------------------------------- ring

def _mask_mode(rank: int, src: int, causal: bool) -> Optional[int]:
    """The hop's mask mode for the Q chunk of `rank` against the K/V chunk
    of `src`: None skips a future chunk (causal), 1 is the own chunk's
    causal mask, 0 attends fully."""
    if not causal:
        return 0
    if src > rank:
        return None
    return 1 if src == rank else 0


def _fresh_state(q: torch.Tensor):
    batch, s_q, heads, head_dim = q.shape
    o = torch.zeros((batch, s_q, heads, head_dim), dtype=torch.float32,
                    device=q.device)
    m = torch.full((batch, heads, s_q), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((batch, heads, s_q), dtype=torch.float32,
                    device=q.device)
    return o, m, l


def _finish(o, m, l, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's normalisation o / max(l, 1e-30) in `dtype`, and the
    row logsumexp m + log(max(l, 1e-30)) the backward needs."""
    l_safe = l.clamp_min(1e-30)
    out = (o / l_safe.transpose(1, 2)[..., None]).to(dtype)
    return out, m + torch.log(l_safe)


def _rotate(group, *tensors):
    """Send each tensor to rank r + 1 of the ring and receive its
    counterpart from rank r - 1: the ring group's counted `permute`."""
    return group.permute(tensors)


def _rank_forward(q, k, v, group, causal, sm_scale):
    """One rank's ring: its Q chunk against every K/V chunk as it comes
    by, rotating unconditionally every hop so all ranks stay in step."""
    sp, rank = group.size, group.rank
    chunk = q.shape[1]
    o, m, l = _fresh_state(q)
    k_cur, v_cur = k, v
    for i in range(sp):
        src = (rank - i) % sp
        mode = _mask_mode(rank, src, causal)
        if mode is not None:
            o, m, l = chunk_update(q, k_cur, v_cur, o, m, l,
                                   sm_scale=sm_scale, mask_mode=mode,
                                   q_offset=rank * chunk,
                                   k_offset=src * chunk)
        k_cur, v_cur = _rotate(group, k_cur, v_cur)
    return _finish(o, m, l, q.dtype)


def _sharded_forward(q, k, v, sp, causal, sm_scale):
    """Every rank's ring in turn, over chunk views of the global tensors.
    Returns the (B, S, H, D) output and lse stacked (sp, B, H, S / sp)."""
    chunk = q.shape[1] // sp
    outs, lses = [], []
    for rank in range(sp):
        q_r = q[:, rank * chunk:(rank + 1) * chunk]
        o, m, l = _fresh_state(q_r)
        for i in range(sp):
            src = (rank - i) % sp
            mode = _mask_mode(rank, src, causal)
            if mode is None:
                continue
            cols = slice(src * chunk, (src + 1) * chunk)
            o, m, l = chunk_update(q_r, k[:, cols], v[:, cols], o, m, l,
                                   sm_scale=sm_scale, mask_mode=mode,
                                   q_offset=rank * chunk,
                                   k_offset=src * chunk)
        out, lse = _finish(o, m, l, q.dtype)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.stack(lses)


def _pair_grads(q, k, v, do, lse, delta, mode, sm_scale):
    """dq, dk, dv of one (Q chunk, K/V chunk) pair through the flash dQ
    and dK/dV kernels (their plain twins on the CPU): causal on the
    diagonal hop, full on a past one."""
    opts = dict(causal=mode == 1, sm_scale=sm_scale)
    dq = fa.flash_dq(q, k, v, do, lse, delta, **opts)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, **opts)
    return dq, dk, dv


def _rank_backward(q, k, v, do, lse, delta, group, causal, sm_scale):
    sp, rank = group.size, group.rank
    delta = delta.transpose(1, 2).contiguous()           # (B, H, chunk)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k, v
    for i in range(sp):
        src = (rank - i) % sp
        mode = _mask_mode(rank, src, causal)
        if mode is not None:
            dq_h, dk_h, dv_h = _pair_grads(q, k_cur, v_cur, do, lse, delta,
                                           mode, sm_scale)
            dq += dq_h
            dk += dk_h
            dv += dv_h
        k_cur, v_cur, dk, dv = _rotate(group, k_cur, v_cur, dk, dv)
    return dq, dk, dv


def _sharded_backward(q, k, v, do, lse, delta, sp, causal, sm_scale):
    """The per-rank backward of every rank, hop by hop: at hop i each rank
    adds its share to the dK/dV of the chunk it holds, which is the order
    in which the travelling accumulators of the per-rank form take them."""
    batch, seq, heads, _ = q.shape
    chunk = seq // sp
    delta = delta.reshape(batch, sp, chunk, heads).permute(1, 0, 3, 2)
    delta = delta.contiguous()                           # (sp, B, H, chunk)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i in range(sp):
        for rank in range(sp):
            src = (rank - i) % sp
            mode = _mask_mode(rank, src, causal)
            if mode is None:
                continue
            rows = slice(rank * chunk, (rank + 1) * chunk)
            cols = slice(src * chunk, (src + 1) * chunk)
            dq_h, dk_h, dv_h = _pair_grads(
                q[:, rows], k[:, cols], v[:, cols], do[:, rows], lse[rank],
                delta[rank], mode, sm_scale)
            dq[:, rows] += dq_h
            dk[:, cols] += dk_h
            dv[:, cols] += dv_h
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    """Both forms of the ring with their gradient: `group` set runs this
    rank's chunk over the group, else `sp` chunks of global tensors in
    one process. Saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, sp, group):
        # Named ranges let a torch.profiler trace attribute the ring's
        # host and device time; free when not profiling.
        with torch.profiler.record_function('ring_forward'):
            if group is None:
                out, lse = _sharded_forward(q, k, v, sp, causal, sm_scale)
            else:
                out, lse = _rank_forward(q, k, v, group, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, sm_scale, sp, group)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        causal, sm_scale, sp, group = ctx.opts
        with torch.profiler.record_function('ring_backward'):
            delta = (grad_out.float() * out.float()).sum(dim=-1)  # (B,S,H)
            if group is None:
                dq, dk, dv = _sharded_backward(q, k, v, grad_out, lse, delta,
                                               sp, causal, sm_scale)
            else:
                dq, dk, dv = _rank_backward(q, k, v, grad_out, lse, delta,
                                            group, causal, sm_scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _check_heads(q, k, v) -> None:
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or \
            q.shape[2] % k.shape[2] or k.shape[3] != q.shape[3]:
        raise ValueError(f'ring attention takes q (B, S, H, D) and k/v '
                         f'(B, S, KV, D) with KV dividing H; got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group=None, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's sequence chunk over the ring
    `group` (a training group's `ring`, parallel/mesh.TrainGroup), sp =
    the group's size and the chunk's index = this process's rank in it.
    q: (B, S/sp, H, D); k/v: (B, S/sp, KV, D). Returns (B, S/sp, H, D) in
    q.dtype."""
    _check_heads(q, k, v)
    from skypilot_tpu_torch.parallel import sharding
    sharding.check_ring(group)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, causal, float(sm_scale), group.size, group)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, sp: int, causal: bool = True,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention of global (B, S, H|KV, D) tensors in one process,
    the sequence cut into `sp` chunks of S / sp. Returns (B, S, H, D) in
    q.dtype, equal bit for bit to the per-rank form on the same data."""
    _check_heads(q, k, v)
    if sp < 1 or q.shape[1] % sp:
        raise ValueError(f'sequence {q.shape[1]} is not divisible by '
                         f'sp={sp}')
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, causal, float(sm_scale), sp, None)


def ring_attention_ambient(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention in the form the ambient sequence-parallel context
    names (parallel/sharding.use_sequence_parallel): the form model code
    uses, so modules need not thread a group through."""
    from skypilot_tpu_torch.parallel import sharding
    ctx = sharding.current_sequence_parallel()
    if ctx is None:
        raise ValueError(
            "impl='ring' needs a sequence-parallel context: enter "
            'parallel.sharding.use_sequence_parallel(sp=N) (one process) or '
            'use_sequence_parallel(group=g) (one rank per process)')
    if ctx.group is None:
        return ring_attention_sharded(q, k, v, sp=ctx.sp, causal=causal,
                                      sm_scale=sm_scale)
    return ring_attention(q, k, v, group=ctx.group, causal=causal,
                          sm_scale=sm_scale)
