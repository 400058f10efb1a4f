"""Paged-KV attention: the hand-written CUDA kernel and its plain twin.

Replaces the TPU kernels skypilot_tpu/ops/paged_attention.py
`_decode_kernel` (float pools) and `_decode_kernel_int8` (int8 pools with
fp32 per-token scale rows), entry `paged_decode_attention`. Both live in
ops/csrc/paged_attention.cu (sm_90a, built at first use by ops/_build.py
and called through ctypes); its source comment says what bounds it on
the H100 and what its design does about that. bf16 queries, over bf16
or int8 pools, take one of two redesigned kernels by `kernel_route`
(tensor-core prefill at PREFILL_ROWS grouped rows or more, else the
key-span-split decode route); fp32 queries take the first design.
`workspace_floats` sizes the split-key partials the kernel writes, by the
same rule as the library's `paged_attention_workspace_floats`.

`paged_decode_attention` is the wrapper the model calls. On a CUDA tensor
it launches the kernel or raises: a build or launch failure is an error,
never a quiet switch to the plain version. Only a tensor that lies on the
CPU takes `paged_decode_attention_plain` (gather each row's logical
window, and its scale rows, through its block table, then
`attend_window`, the one definition of the attention math).
`paged_decode_attention.launches` counts float-pool kernel launches and
`paged_decode_attention.int8_launches` int8-pool ones, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from skypilot_tpu_torch.ops import _build, limits

_NEG_INF = -1e30
_HEAD_DIMS = limits.HEAD_DIMS
_STEP_KEYS = limits.PAGED_STEP_KEYS   # keys the kernel stages per loop step
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's routes (ops/csrc/paged_attention.cu). bf16 queries, over
# bf16 or int8 pools, take the tensor-core prefill route at PREFILL_ROWS
# grouped rows or more (head_dim <= 128), else the decode route, whose key
# axis splits by SPLIT_KEYS keys (INT8_SPLIT_KEYS over int8 pools); fp32
# queries take the first design, whose key axis splits by grid size (up
# to _MAX_SPLITS, aiming at _TARGET_CTAS CUDA blocks).
PREFILL_ROWS = 64
SPLIT_KEYS = 256
INT8_SPLIT_KEYS = 128
_TARGET_CTAS = 528
_MAX_SPLITS = 16


def kernel_route(dtype: torch.dtype, head_dim: int, total_rows: int) -> str:
    """'prefill', 'decode' or 'first': the route the kernel takes for
    `total_rows` = T * n_rep grouped rows per (row, kv head) of `dtype`
    queries, over bf16 and int8 pools alike."""
    if dtype != torch.bfloat16:
        return 'first'
    if head_dim <= 128 and total_rows >= PREFILL_ROWS:
        return 'prefill'
    return 'decode'


def rows_per_tile(total_rows: int) -> int:
    """Grouped rows per CUDA block on the decode and first routes."""
    return 4 if total_rows <= 4 else 16


def split_keys(kv_quant: bool) -> int:
    """The decode route's key span over int8 (`kv_quant`) or bf16 pools."""
    return INT8_SPLIT_KEYS if kv_quant else SPLIT_KEYS


def num_splits(route: str, batch: int, kv_heads: int, total_rows: int,
               blocks_per_seq: int, block_size: int,
               kv_quant: bool = False) -> int:
    """The grid's split extent of the key axis (host-known: it reads no
    positions)."""
    if route == 'first':
        rows = rows_per_tile(total_rows)
        ctas = batch * kv_heads * -(-total_rows // rows)
        return max(1, min(_MAX_SPLITS, -(-_TARGET_CTAS // ctas)))
    if route == 'prefill' or total_rows >= PREFILL_ROWS:
        return 1
    return -(-blocks_per_seq * block_size // split_keys(kv_quant))


def workspace_floats(batch: int, cur_len: int, num_heads: int,
                     kv_heads: int, head_dim: int, blocks_per_seq: int,
                     block_size: int, dtype: torch.dtype,
                     kv_quant: bool = False) -> int:
    """fp32 words of split-key partials one call writes: (m, l, acc) per
    split and grouped row, 0 when the key axis is whole. The C library's
    `paged_attention_workspace_floats` is the same rule."""
    total_rows = cur_len * (num_heads // kv_heads)
    route = kernel_route(dtype, head_dim, total_rows)
    splits = num_splits(route, batch, kv_heads, total_rows, blocks_per_seq,
                        block_size, kv_quant)
    if splits == 1:
        return 0
    return batch * kv_heads * splits * total_rows * (head_dim + 2)


def fused_hbm_bytes_per_step(live_blocks: int, block_size: int,
                             kv_heads: int, head_dim: int,
                             num_layers: int, payload_itemsize: int,
                             kv_quant: bool) -> int:
    """Bytes ONE decode step streams through the kernel: every live
    block's K and V payload read once per layer, plus the fp32 scale rows
    under int8 (the reference's formula, skypilot_tpu/ops/
    paged_attention.py `fused_hbm_bytes_per_step`)."""
    per_block = 2 * block_size * kv_heads * head_dim * payload_itemsize
    if kv_quant:
        per_block += 2 * block_size * kv_heads * 4   # fp32 scale rows
    return live_blocks * per_block * num_layers


def tile_live_keys(tile_positions, blocks_per_seq: int,
                   block_size: int) -> int:
    """Keys a row tile walks: whole blocks up to its largest position
    (blocks past it are skipped)."""
    max_pos = max([0] + [int(p) for p in tile_positions])
    return min(blocks_per_seq, max_pos // block_size + 1) * block_size


def split_ranges(tile_positions, blocks_per_seq: int, block_size: int,
                 splits: int, kv_quant: bool = False) -> list:
    """[lo, hi) key range of each split of the decode route that does
    work for a row tile, in merge order; splits past the tile's live keys
    exit at once and are not listed."""
    live = tile_live_keys(tile_positions, blocks_per_seq, block_size)
    span = split_keys(kv_quant) if splits > 1 else live
    return [(lo, min(live, lo + span)) for lo in range(0, live, span)]


def attend_window(q: torch.Tensor, k_win: torch.Tensor,
                  v_win: torch.Tensor, positions: torch.Tensor,
                  sm_scale: float, window: int = 0,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None,
                  logit_softcap: float = 0.0) -> torch.Tensor:
    """Score/softmax/weighted-sum over one gathered KV window: the
    reference's `transformer._attend_window`, op for op, float and int8.

    q: (B, T, H, D); k_win/v_win: (B, S, KV, D) (int8 when scales are
    given); k_scale/v_scale: (B, S, KV) fp32 or None (together);
    positions: (B, T). Grouped-query attention against the unrepeated
    window; scores in fp32 (the reference's preferred_element_type),
    capped to cap * tanh(s / cap) after sm_scale when `logit_softcap`,
    masked to -1e30 unless k_pos <= q_pos (and q_pos - k_pos < window).
    Float: probabilities cast to the value dtype before the weighted sum.
    int8: K converts int8 → q's dtype for the score product and its
    per-token scale multiplies the fp32 scores before sm_scale; the V
    scale multiplies the probabilities, which then round to q's dtype
    for the product with V (int8 → q's dtype). Returns (B, T, H, D).
    """
    batch, cur_len, num_heads, head_dim = q.shape
    seq_len, kv_heads = k_win.shape[1], k_win.shape[2]
    n_rep = num_heads // kv_heads
    kv_quant = k_scale is not None
    q_grouped = q.reshape(batch, cur_len, kv_heads, n_rep, head_dim)
    key_in = k_win.to(q.dtype) if kv_quant else k_win
    scores = torch.einsum('bqkrd,bskd->bkrqs', q_grouped.float(),
                          key_in.float())
    if kv_quant:
        scores = scores * k_scale.transpose(1, 2)[:, :, None, None, :]
    scores = scores * sm_scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    q_pos = positions[:, :, None]                            # (b, q, 1)
    k_pos = torch.arange(seq_len, device=q.device)[None, None, :]
    mask = k_pos <= q_pos                                    # causal+fill
    if window:
        mask &= q_pos - k_pos < window
    # A Python scalar, not a host tensor: the 'xla' route runs inside
    # the engine's CUDA-graph captures, where a host copy is refused.
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if kv_quant:
        probs = probs * v_scale.transpose(1, 2)[:, :, None, None, :]
        out = torch.einsum('bkrqs,bskd->bqkrd', probs.to(q.dtype),
                           v_win.to(q.dtype))
    else:
        out = torch.einsum('bkrqs,bskd->bqkrd', probs.to(v_win.dtype),
                           v_win)
    return out.reshape(batch, cur_len, num_heads, head_dim)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 positions: torch.Tensor, *,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 sm_scale: Optional[float] = None,
                                 window: int = 0,
                                 logit_softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather every row's whole
    logical window (B, bps * bs, KV, D), and under int8 its scale rows
    (B, bps * bs, KV), through its table, then `attend_window`. Used on
    the CPU, as the kernel's yardstick of correctness on the card, and
    as the reference's XLA route (`decode_kernel='xla'`), the only one
    that serves a logit softcap."""
    batch = q.shape[0]
    num_blocks, block_size, kv_heads, head_dim = k_pool.shape
    blocks_per_seq = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    gidx = (block_tables[:, :, None].long() * block_size +
            torch.arange(block_size, device=q.device)[None, None, :]
            ).reshape(batch, blocks_per_seq * block_size)
    k_win = k_pool.reshape(num_blocks * block_size, kv_heads,
                           head_dim)[gidx]
    v_win = v_pool.reshape(num_blocks * block_size, kv_heads,
                           head_dim)[gidx]
    if k_scale is not None:
        k_scale = k_scale.reshape(num_blocks * block_size, kv_heads)[gidx]
        v_scale = v_scale.reshape(num_blocks * block_size, kv_heads)[gidx]
    return attend_window(q, k_win, v_win, positions, sm_scale, window,
                         k_scale, v_scale, logit_softcap)


def _lib() -> ctypes.CDLL:
    lib = _build.load('paged_attention')
    if not getattr(lib, '_signatures_set', False):
        tail = ([ctypes.c_int] * 8 +
                [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fwd = lib.paged_attention_forward
        fwd.argtypes = [ctypes.c_void_p] * 7 + tail
        fwd.restype = ctypes.c_int
        fwd8 = lib.paged_attention_forward_int8
        fwd8.argtypes = [ctypes.c_void_p] * 9 + tail
        fwd8.restype = ctypes.c_int
        ws = lib.paged_attention_workspace_floats
        ws.argtypes = [ctypes.c_int] * 9
        ws.restype = ctypes.c_longlong
        lib._signatures_set = True
    return lib


def _launch(q, k_pool, v_pool, block_tables, positions, sm_scale,
            window, k_scale=None, v_scale=None) -> torch.Tensor:
    batch, cur_len, num_heads, head_dim = q.shape
    _, block_size, kv_heads, _ = k_pool.shape
    kv_quant = k_scale is not None
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f'paged attention kernel takes float32 or '
                        f'bfloat16, got {q.dtype}')
    pool_dtype = torch.int8 if kv_quant else q.dtype
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError('k_pool and v_pool must be int8 with scales, else '
                        'share q\'s dtype')
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f'paged attention kernel takes head_dim in '
                         f'{_HEAD_DIMS}, got {head_dim}')
    if v_pool.shape != k_pool.shape:
        raise ValueError('k_pool and v_pool shapes differ')
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError('block_tables and positions must be int32')
    if tuple(positions.shape) != (batch, cur_len) or \
            block_tables.shape[0] != batch:
        raise ValueError('positions must be (B, T) and block_tables (B, bps)')
    tensors = [q, k_pool, v_pool, block_tables, positions]
    scales = []
    if kv_quant:
        scales = [k_scale, v_scale]
        want = tuple(k_pool.shape[:3]) + (1,)
        if any(tuple(s.shape) != want for s in scales):
            raise ValueError(f'k_scale and v_scale must be {want}')
        if any(s.dtype != torch.float32 or not s.is_contiguous()
               for s in scales):
            raise TypeError('k_scale and v_scale must be contiguous '
                            'float32')
    if any(t.device != q.device for t in tensors + scales):
        raise ValueError('all paged attention inputs must be on one device')
    if not (q.is_contiguous() and k_pool.is_contiguous() and
            v_pool.is_contiguous() and positions.is_contiguous()):
        raise ValueError('q, pools and positions must be contiguous')
    if block_tables.stride(1) != 1:
        raise ValueError('block_tables rows must be contiguous')
    if any(t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError('pools must be 16-byte aligned')
    if _STEP_KEYS % block_size:
        raise ValueError(f'paged attention kernel takes a block_size that '
                         f'divides {_STEP_KEYS}, got {block_size}')
    lib = _lib()
    out = torch.empty_like(q)
    # Split-key partials (m, l, acc) when the key axis splits (decode).
    # Under CUDA-graph capture this comes from the graph's pool: a
    # temporary of each replay, like the call's output.
    workspace = torch.empty(
        workspace_floats(batch, cur_len, num_heads, kv_heads, head_dim,
                         block_tables.shape[1], block_size, q.dtype,
                         kv_quant),
        dtype=torch.float32, device=q.device)
    pools = [k_pool.data_ptr(), v_pool.data_ptr()]
    if kv_quant:
        pools += [k_scale.data_ptr(), v_scale.data_ptr()]
    forward = (lib.paged_attention_forward_int8 if kv_quant
               else lib.paged_attention_forward)
    # A one-row table's row stride is arbitrary (numpy's `[None]` gives
    # 0); the kernel never steps it.
    table_stride = (block_tables.stride(0) if batch > 1
                    else block_tables.shape[1])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = forward(
            q.data_ptr(), *pools, block_tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(),
            workspace.data_ptr() if workspace.numel() else None,
            batch, cur_len, num_heads, kv_heads, head_dim, block_size,
            block_tables.shape[1], table_stride, float(sm_scale),
            int(window), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f'paged attention kernel launch failed: CUDA '
                           f'error {err}')
    if kv_quant:
        paged_decode_attention.int8_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor,
                           k_pool: torch.Tensor,
                           v_pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           positions: torch.Tensor,
                           *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           sm_scale: Optional[float] = None,
                           window: int = 0,
                           logit_softcap: float = 0.0) -> torch.Tensor:
    """Paged attention over a block pool (the reference entry's contract).

    Args:
      q: (B, T, H, D) queries — T is 1 for plain decode, the chunk length
        for chunked prefill.
      k_pool / v_pool: (num_blocks, block_size, KV, D) shared pool.
      block_tables: (B, blocks_per_seq) int32 logical→physical block ids —
        the table WITHOUT the engine's extra clip column (callers pass
        `tables[:, :max_seq_len // block_size]`).
      positions: (B, T) int32 per-row query positions.
      k_scale / v_scale: (num_blocks, block_size, KV, 1) fp32
        per-token-per-kv-head scale rows of int8 pools (both or neither).
      window: sliding window in keys (0 = full causal).
      logit_softcap: refused, as by the reference kernel.

    Returns (B, T, H, D) in q.dtype.
    """
    if logit_softcap:
        raise NotImplementedError(
            'paged_decode_attention does not support logit softcap; '
            'use the XLA path (decode_kernel="xla") for softcapped '
            'models — same policy as ops/flash_attention.py')
    if (k_scale is None) != (v_scale is None):
        raise ValueError('k_scale and v_scale must be given together')
    num_heads = q.shape[2]
    kv_heads = k_pool.shape[2]
    if num_heads % kv_heads:
        raise ValueError(
            f'num_heads {num_heads} not divisible by kv_heads '
            f'{kv_heads}')
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == 'cpu':
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_tables, positions, k_scale=k_scale,
            v_scale=v_scale, sm_scale=sm_scale, window=window)
    if q.device.type != 'cuda':
        raise ValueError(f'paged attention runs on cuda (kernel) or cpu '
                         f'(plain version), not {q.device.type}')
    return _launch(q, k_pool, v_pool, block_tables, positions, sm_scale,
                   window, k_scale, v_scale)


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
