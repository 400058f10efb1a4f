"""The port's CUDA kernels against their plain PyTorch versions on the
card: paged attention over float and int8 pools, the flash-attention
forward and backward, the fused multi-LoRA delta and the ring-attention
chunk update; and the engine's steps on the card, the contiguous
layout's clamped write, decode graph and paged parity among them. Needs
an NVIDIA GPU and nvcc: every test is marked `cuda` and skips inside the
test when torch.cuda is unavailable. The file imports no JAX, so on a GPU machine
without JAX it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py imports JAX; --noconftest leaves it out).

Tolerances: fp32 1e-5 (the kernel and the plain version sum in other
orders); bf16 2e-2 absolute and relative (both round p to bf16, at
different points of the softmax, and round the output to bf16).
"""
import weakref

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.ops import paged_attention as pa

_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the kernel is CUDA-only')


def _case(batch, cur_len, kv_heads, n_rep, head_dim, block_size,
          blocks_per_seq, dtype, seed):
    """Shuffled physical blocks, rows at different depths (one at
    position 0, one at the end of its window), table tails at scratch
    block 0 holding garbage, plus the engine's extra clip column."""
    rng = np.random.RandomState(seed)
    num_blocks = batch * blocks_per_seq + 2
    q = rng.randn(batch, cur_len, kv_heads * n_rep, head_dim)
    k_pool = rng.randn(num_blocks, block_size, kv_heads, head_dim)
    v_pool = rng.randn(num_blocks, block_size, kv_heads, head_dim)
    k_pool[0] = v_pool[0] = 50.0
    perm = rng.permutation(num_blocks - 1) + 1
    tables = np.zeros((batch, blocks_per_seq + 1), np.int32)
    seq = blocks_per_seq * block_size
    starts = np.linspace(0, seq - cur_len, batch).astype(int)
    positions = np.stack([np.arange(cur_len) + s for s in starts])
    for b in range(batch):
        need = positions[b].max() // block_size + 1
        tables[b, :need] = perm[b * blocks_per_seq:b * blocks_per_seq + need]

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to('cuda', dt)

    return (dev(q, dtype), dev(k_pool, dtype), dev(v_pool, dtype),
            dev(tables, torch.int32)[:, :blocks_per_seq],
            dev(positions, torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('batch,cur_len,n_rep,head_dim,block_size,window', [
    (8, 1, 4, 128, 16, 0),      # decode: small grid, split key axis
    (3, 1, 1, 64, 8, 0),        # MHA decode, smaller blocks
    (1, 256, 4, 128, 16, 0),    # prefill chunk: many row tiles
    (2, 37, 4, 128, 16, 40),    # ragged row tiles, sliding window
    (2, 5, 2, 256, 32, 0),      # wide heads
])
def test_kernel_matches_plain_version(dtype, batch, cur_len, n_rep,
                                      head_dim, block_size, window):
    _need_gpu()
    args = _case(batch, cur_len, kv_heads=2, n_rep=n_rep, head_dim=head_dim,
                 block_size=block_size, blocks_per_seq=24, dtype=dtype,
                 seed=cur_len + head_dim)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(*args, window=window)
    assert pa.paged_decode_attention.launches == before + 1
    ref = pa.paged_decode_attention_plain(*args, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    tol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    _need_gpu()
    q, kp, vp, tables, pos = _case(1, 1, 2, 4, 128, 16, 4, torch.float32, 0)
    with pytest.raises(ValueError, match='head_dim'):
        pa.paged_decode_attention(q[..., :96].contiguous(),
                                  kp[..., :96].contiguous(),
                                  vp[..., :96].contiguous(), tables, pos)
    with pytest.raises(TypeError, match='int32'):
        pa.paged_decode_attention(q, kp, vp, tables.long(), pos)
    with pytest.raises(TypeError, match='dtype'):
        pa.paged_decode_attention(q, kp.bfloat16(), vp.bfloat16(), tables,
                                  pos)


# The bf16 routes at their boundaries (ops/paged_attention.py
# `kernel_route`): grouped rows T * n_rep just under, at and over the
# prefill route's PREFILL_ROWS; T not a multiple of a 64-row tile; block
# sizes 8-64; n_rep 1-8; head_dim 64, 128 and 256 (which keeps the decode
# route); windows of 37 keys (96 keys, below); and long rows, whose key
# axis splits by SPLIT_KEYS. Same tolerances as above; reruns equal.
_BOUNDARY_CASES = [  # (batch, cur_len, n_rep, head_dim, block_size, window, bps)
    (8, 1, 4, 128, 16, 0, 128),     # serve decode: 8 key-span splits
    (3, 1, 8, 64, 8, 37, 80),       # decode, 3 splits, window
    (4, 1, 1, 128, 64, 0, 40),      # MHA decode, 64-token blocks, 10 splits
    (2, 15, 4, 128, 16, 0, 48),     # 60 rows: decode route, split
    (2, 16, 4, 128, 16, 0, 48),     # 64 rows: prefill route
    (2, 17, 4, 128, 32, 0, 24),     # 68 rows: a ragged second tile
    (2, 37, 4, 128, 16, 96, 48),    # 148 rows, window
    (2, 64, 1, 64, 8, 0, 48),       # head_dim 64, n_rep 1
    (2, 33, 2, 64, 64, 0, 12),      # head_dim 64, n_rep 2
    (2, 40, 2, 256, 32, 0, 24),     # head_dim 256: decode route, whole
    (2, 3, 4, 256, 16, 0, 48),      # head_dim 256: decode route, split
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    'batch,cur_len,n_rep,head_dim,block_size,window,bps', _BOUNDARY_CASES)
def test_bf16_routes_at_their_boundaries(batch, cur_len, n_rep, head_dim,
                                         block_size, window, bps):
    _need_gpu()
    args = _case(batch, cur_len, kv_heads=2, n_rep=n_rep, head_dim=head_dim,
                 block_size=block_size, blocks_per_seq=bps,
                 dtype=torch.bfloat16, seed=cur_len * 7 + bps)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(*args, window=window)
    again = pa.paged_decode_attention(*args, window=window)
    assert pa.paged_decode_attention.launches == before + 2
    ref = pa.paged_decode_attention_plain(*args, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    tol = _TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_workspace_rule_matches_the_library():
    _need_gpu()
    lib = pa._lib()  # pylint: disable=protected-access
    for dtype, quant in ((torch.bfloat16, False), (torch.float32, False),
                         (torch.bfloat16, True), (torch.float32, True)):
        for batch, cur_len, heads, kv, dim, bps, bs in (
                (8, 1, 32, 8, 128, 512, 16), (1, 256, 32, 8, 128, 512, 16),
                (3, 15, 8, 2, 64, 48, 8), (2, 16, 8, 2, 256, 48, 16),
                (5, 1, 4, 4, 128, 8, 64), (1, 1, 8, 1, 128, 2048, 32)):
            assert lib.paged_attention_workspace_floats(
                batch, cur_len, heads, kv, dim, bps, bs,
                pa._DTYPE_CODE[dtype], int(quant)) == pa.workspace_floats(  # pylint: disable=protected-access
                    batch, cur_len, heads, kv, dim, bps, bs, dtype, quant)


# ------------------------------------------------- flash attention kernels
# Tolerances: fp32 2e-5 on O and lse and 1e-4 on the gradients (the
# kernels and the plain versions sum in other orders; dK/dV sum over up
# to S x n_rep rows); bf16 2e-2 absolute and relative (both round p and
# ds to bf16 and round every output to bf16, whose step is 2^-8).

from skypilot_tpu_torch.ops import flash_attention as fa  # noqa: E402

_FA_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _flash_case(batch, seq, heads, kv_heads, head_dim, dtype, seed):
    """q, k, v as the model makes them: q contiguous (B, S, H, D), k and v
    strided column slices of one fused projection output."""
    rng = np.random.RandomState(seed)
    q = rng.randn(batch, seq, heads, head_dim)
    kv = rng.randn(batch, seq, 2 * kv_heads, head_dim)
    g = rng.randn(batch, seq, heads, head_dim)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to('cuda', dtype)

    kv = dev(kv)
    return dev(q), kv[:, :, :kv_heads], kv[:, :, kv_heads:], dev(g)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('seq,heads,kv_heads,head_dim,causal,window', [
    (256, 4, 2, 128, True, 0),     # GQA, tiles divide S
    (200, 4, 2, 128, True, 0),     # ragged last tile
    (200, 2, 2, 64, False, 0),     # non-causal, MHA
    (256, 4, 1, 128, True, 48),    # sliding window, n_rep 4
    (100, 2, 1, 256, True, 0),     # wide heads, 32-row tiles
])
def test_flash_kernels_match_plain(dtype, seq, heads, kv_heads, head_dim,
                                   causal, window):
    _need_gpu()
    q, k, v, g = _flash_case(2, seq, heads, kv_heads, head_dim, dtype, seq)
    opts = dict(causal=causal, sm_scale=head_dim ** -0.5, window=window)
    launches = (fa.flash_forward.launches, fa.flash_dq.launches,
                fa.flash_dkv.launches)
    out, lse = fa.flash_forward(q, k, v, **opts)
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, **opts)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_dq(q, k, v, g, lse, delta, **opts)
    dk, dv = fa.flash_dkv(q, k, v, g, lse, delta, **opts)
    ref_dq = fa.flash_dq_plain(q, k, v, g, lse, delta, **opts)
    ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, g, lse, delta, **opts)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in launches)
    fwd_tol, bwd_tol = _FA_TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=fwd_tol,
                               rtol=fwd_tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
    for name, got, ref in (('dq', dq, ref_dq), ('dk', dk, ref_dk),
                           ('dv', dv, ref_dv)):
        assert got.dtype == dtype and got.shape == ref.shape, name
        torch.testing.assert_close(got.float(), ref.float(), atol=bwd_tol,
                                   rtol=bwd_tol, msg=name)


# The bf16 forward groups the n_rep query heads of a KV head into one
# 128-row tile (128 / n_rep positions each): n_rep 1, 2, 4 and 8, both
# head_dims of the wgmma route and 256 through the CUDA-core route;
# ragged S, window, non-causal; q, k and v strided column slices of one
# fused qkv tensor; reruns equal.
@pytest.mark.cuda
@pytest.mark.parametrize('seq,heads,kv_heads,head_dim,causal,window', [
    (1000, 8, 8, 128, True, 0),     # n_rep 1: 128 positions a tile
    (1000, 16, 8, 128, True, 256),  # n_rep 2, window
    (300, 16, 4, 64, False, 0),     # n_rep 4, non-causal
    (333, 16, 2, 128, True, 0),     # n_rep 8: 16 positions a tile
    (257, 4, 2, 256, True, 0),      # head_dim 256: CUDA-core forward
])
def test_flash_forward_grouped_tiles_from_fused_qkv(seq, heads, kv_heads,
                                                   head_dim, causal, window):
    _need_gpu()
    rng = np.random.RandomState(seq + heads)
    qkv = torch.from_numpy(rng.randn(2, seq, heads + 2 * kv_heads,
                                     head_dim)).to('cuda', torch.bfloat16)
    q, k, v = qkv.split([heads, kv_heads, kv_heads], dim=2)
    opts = dict(causal=causal, sm_scale=head_dim ** -0.5, window=window)
    out, lse = fa.flash_forward(q, k, v, **opts)
    again, again_lse = fa.flash_forward(q, k, v, **opts)
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, **opts)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, again_lse)
    tol = _FA_TOL[torch.bfloat16][0]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)


# The bf16 backward pair: dQ groups the n_rep query heads of a KV head
# into 128-row tiles as the forward does, dK/dV walks each KV head's query
# heads over 128-key tiles. n_rep 1, 2, 4 and 8, ragged S, window,
# non-causal, head_dim 64; q, k, v and dO strided column slices of fused
# tensors; two runs bit-identical (no atomics).
@pytest.mark.cuda
@pytest.mark.parametrize('seq,heads,kv_heads,head_dim,causal,window', [
    (1000, 8, 8, 128, True, 0),     # n_rep 1, ragged S
    (1000, 16, 8, 128, True, 256),  # n_rep 2, window
    (300, 16, 4, 64, False, 0),     # n_rep 4, non-causal, head_dim 64
    (333, 16, 2, 128, True, 0),     # n_rep 8: 16 positions a dQ tile
    (129, 6, 2, 64, True, 40),      # n_rep 3: 126 live rows a dQ tile
    (5, 4, 2, 128, True, 0),        # S shorter than any tile
])
def test_flash_backward_grouped_tiles_from_fused_qkv(seq, heads, kv_heads,
                                                     head_dim, causal,
                                                     window):
    _need_gpu()
    rng = np.random.RandomState(seq + heads + head_dim)
    qkv = torch.from_numpy(rng.randn(2, seq, heads + 2 * kv_heads,
                                     head_dim)).to('cuda', torch.bfloat16)
    q, k, v = qkv.split([heads, kv_heads, kv_heads], dim=2)
    g = torch.from_numpy(rng.randn(2, seq, 2 * heads, head_dim)).to(
        'cuda', torch.bfloat16)[:, :, heads:]
    opts = dict(causal=causal, sm_scale=head_dim ** -0.5, window=window)
    out, lse = fa.flash_forward_plain(q, k, v, **opts)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    _hold_backward_pair(q, k, v, g, lse, delta, opts)


def _hold_backward_pair(q, k, v, g, lse, delta, opts):
    launches = fa.flash_dq.launches, fa.flash_dkv.launches
    got = [fa.flash_dq(q, k, v, g, lse, delta, **opts),
           *fa.flash_dkv(q, k, v, g, lse, delta, **opts)]
    again = [fa.flash_dq(q, k, v, g, lse, delta, **opts),
             *fa.flash_dkv(q, k, v, g, lse, delta, **opts)]
    ref = [fa.flash_dq_plain(q, k, v, g, lse, delta, **opts),
           *fa.flash_dkv_plain(q, k, v, g, lse, delta, **opts)]
    torch.cuda.synchronize()
    assert (fa.flash_dq.launches, fa.flash_dkv.launches) == (
        launches[0] + 2, launches[1] + 2)
    tol = _FA_TOL[torch.bfloat16][1]
    for name, a, b, c in zip(('dq', 'dk', 'dv'), got, again, ref):
        assert torch.equal(a, b), name
        assert a.dtype == c.dtype and a.shape == c.shape, name
        torch.testing.assert_close(a.float(), c.float(), atol=tol, rtol=tol,
                                   msg=name)


# The ring backward's hop shapes (B 4, 512 queries x 512 keys, llama3-1b
# heads): the diagonal hop (causal) and a past hop (full), fed the lse and
# delta of the whole 1024-long sequence's softmax, as the ring feeds them.
@pytest.mark.cuda
@pytest.mark.parametrize('src', [0, 1], ids=['full-hop', 'diagonal-hop'])
def test_flash_backward_at_the_ring_hop_shapes(src):
    _need_gpu()
    q, k, v, g = _flash_case(4, 1024, 16, 8, 128, torch.bfloat16, 11)
    out, lse = fa.flash_forward_plain(q, k, v, causal=True,
                                      sm_scale=128 ** -0.5)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    rows, cols = slice(512, 1024), slice(512 * src, 512 * (src + 1))
    _hold_backward_pair(q[:, rows], k[:, cols], v[:, cols], g[:, rows],
                        lse[:, :, rows].contiguous(),
                        delta[:, :, rows].contiguous(),
                        dict(causal=src == 1, sm_scale=128 ** -0.5))


@pytest.mark.cuda
def test_flash_backward_is_deterministic_and_autograd_runs_kernels():
    _need_gpu()
    q, k, v, g = _flash_case(2, 192, 4, 2, 128, torch.bfloat16, 7)
    grads = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, impl='auto')
        before = fa.flash_dq.launches, fa.flash_dkv.launches
        out.backward(g)
        assert (fa.flash_dq.launches, fa.flash_dkv.launches) == (
            before[0] + 1, before[1] + 1)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take():
    _need_gpu()
    q, k, v, _ = _flash_case(1, 64, 2, 1, 128, torch.float32, 0)
    opts = dict(causal=True, sm_scale=0.1)
    with pytest.raises(ValueError, match='head_dim'):
        fa.flash_forward(q[..., :96], k[..., :96], v[..., :96], **opts)
    with pytest.raises(TypeError, match='dtype'):
        fa.flash_forward(q, k.bfloat16(), v.bfloat16(), **opts)
    with pytest.raises(TypeError, match='float32 or'):
        fa.flash_forward(q.half(), k.half(), v.half(), **opts)
    # The bf16 kernels group a KV head's query heads into one 128-row tile.
    qb = torch.zeros((1, 8, 129, 64), device='cuda', dtype=torch.bfloat16)
    kb = torch.zeros((1, 8, 1, 64), device='cuda', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='n_rep 129'):
        fa.flash_dkv(qb, kb, kb, qb, torch.zeros((1, 129, 8), device='cuda'),
                     torch.zeros((1, 129, 8), device='cuda'), **opts)


# -------------------------------------------- int8 paged attention kernel
# Same tolerances as the float pools: the int8 route dequantizes exactly
# (int8 -> fp32) and differs from the plain version only in where p
# rounds to the compute dtype and in the order of the sums.

from skypilot_tpu_torch.models.transformer import int8_quantize  # noqa: E402


def _int8_case(dtype, **kw):
    """_case's pools (garbage scratch block included) quantized with the
    model's int8_quantize; q in `dtype`."""
    q, kp, vp, tables, pos = _case(dtype=torch.float32, **kw)
    k8, ks = int8_quantize(kp)
    v8, vs = int8_quantize(vp)
    return (q.to(dtype), k8, v8, tables, pos,
            dict(k_scale=ks[..., None].contiguous(),
                 v_scale=vs[..., None].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('batch,cur_len,n_rep,head_dim,block_size,window', [
    (8, 1, 4, 128, 16, 0),      # serve decode: split key axis
    (3, 1, 1, 64, 8, 0),        # MHA decode, smaller blocks
    (1, 256, 4, 128, 16, 0),    # serve prefill chunk
    (2, 37, 4, 128, 16, 40),    # ragged row tiles, sliding window
    (2, 5, 2, 256, 32, 0),      # wide heads
])
def test_int8_kernel_matches_plain_version(dtype, batch, cur_len, n_rep,
                                           head_dim, block_size, window):
    _need_gpu()
    q, k8, v8, tables, pos, scales = _int8_case(
        dtype, batch=batch, cur_len=cur_len, kv_heads=2, n_rep=n_rep,
        head_dim=head_dim, block_size=block_size, blocks_per_seq=24,
        seed=cur_len + head_dim)
    before = (pa.paged_decode_attention.launches,
              pa.paged_decode_attention.int8_launches)
    out = pa.paged_decode_attention(q, k8, v8, tables, pos, window=window,
                                    **scales)
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention.int8_launches) == (before[0],
                                                         before[1] + 1)
    ref = pa.paged_decode_attention_plain(q, k8, v8, tables, pos,
                                          window=window, **scales)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    tol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


# bf16 queries over int8 pools take the bf16 routes (`kernel_route`):
# grouped rows just under and at the prefill route's 64, head_dim 64, 128
# and 256 (decode only), windows 0 and 100, block sizes 8-64, rows long
# enough to split by INT8_SPLIT_KEYS; table tails at scratch block 0 hold
# stale payload and scales. Reruns equal.
_INT8_BOUNDARY_CASES = [  # (batch, cur_len, n_rep, head_dim, block_size, window)
    (3, 63, 1, 128, 16, 0),     # 63 rows: decode route
    (3, 64, 1, 128, 16, 0),     # 64 rows: prefill route
    (2, 16, 4, 64, 8, 100),     # 64 rows, head_dim 64, window
    (2, 15, 4, 64, 32, 0),      # 60 rows, head_dim 64
    (2, 40, 2, 256, 64, 100),   # head_dim 256: decode route, window
    (8, 1, 4, 128, 64, 0),      # decode, 64-token blocks
    (2, 37, 4, 128, 32, 100),   # 148 rows, ragged tile, window
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    'batch,cur_len,n_rep,head_dim,block_size,window', _INT8_BOUNDARY_CASES)
def test_int8_routes_at_their_boundaries(batch, cur_len, n_rep, head_dim,
                                         block_size, window):
    _need_gpu()
    q, k8, v8, tables, pos, scales = _int8_case(
        torch.bfloat16, batch=batch, cur_len=cur_len, kv_heads=2,
        n_rep=n_rep, head_dim=head_dim, block_size=block_size,
        blocks_per_seq=2048 // block_size, seed=cur_len * 3 + head_dim)
    scales['k_scale'][0] = scales['v_scale'][0] = 1e3    # stale scratch
    k8[0], v8[0] = 127, -127
    want = 'prefill' if head_dim <= 128 and cur_len * n_rep >= 64 else 'decode'
    assert pa.kernel_route(torch.bfloat16, head_dim, cur_len * n_rep) == want
    out = pa.paged_decode_attention(q, k8, v8, tables, pos, window=window,
                                    **scales)
    again = pa.paged_decode_attention(q, k8, v8, tables, pos, window=window,
                                      **scales)
    ref = pa.paged_decode_attention_plain(q, k8, v8, tables, pos,
                                          window=window, **scales)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    tol = _TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_int8_kernel_refuses_what_it_does_not_take():
    _need_gpu()
    q, k8, v8, tables, pos, scales = _int8_case(
        torch.bfloat16, batch=1, cur_len=1, kv_heads=2, n_rep=4,
        head_dim=128, block_size=16, blocks_per_seq=4, seed=0)
    with pytest.raises(TypeError, match='float32'):
        pa.paged_decode_attention(
            q, k8, v8, tables, pos, k_scale=scales['k_scale'].double(),
            v_scale=scales['v_scale'].double())
    with pytest.raises(ValueError, match='k_scale and v_scale must be'):
        pa.paged_decode_attention(
            q, k8, v8, tables, pos, k_scale=scales['k_scale'][:, :8],
            v_scale=scales['v_scale'][:, :8])
    with pytest.raises(TypeError, match='int8'):
        pa.paged_decode_attention(q, k8.bfloat16(), v8.bfloat16(), tables,
                                  pos, **scales)


# ----------------------------------------------------- fused LoRA kernel
# fp32 1e-4: the shrink sums up to IN terms in another order than the
# plain bmm. bf16 2e-2: both round z to bf16 between the products (one
# bf16 step, 2^-8 relative, where the sum orders disagree) and round the
# output to bf16.

from skypilot_tpu_torch.ops import fused_lora as fl  # noqa: E402

_LORA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _lora_case(batch, seq, d_in, d_out, rank, slots, dtype, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, seq, d_in)
    a = rng.randn(slots, d_in, rank) / np.sqrt(d_in)
    b = rng.randn(slots, rank, d_out) * 0.25
    a[0] = b[0] = 0.0
    ids = rng.randint(0, slots, batch)
    ids[0] = 0

    def dev(arr, dt):
        return torch.from_numpy(np.ascontiguousarray(arr)).to('cuda', dt)

    return (dev(x, dtype), dev(a, dtype), dev(b, dtype),
            dev(ids, torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('batch,seq,d_in,d_out,rank', [
    (8, 1, 4096, 1024, 16),     # serve decode, k/v projection
    (1, 256, 1024, 4096, 16),   # serve prefill chunk, 4-row tiles
    (3, 37, 300, 203, 8),       # ragged IN, OUT and row tiles
    (2, 5, 640, 96, 64),        # wide rank, 1-row tiles
    (4, 3, 512, 512, 32),
])
def test_fused_lora_kernel_matches_plain(dtype, batch, seq, d_in, d_out,
                                         rank):
    _need_gpu()
    x, a, b, ids = _lora_case(batch, seq, d_in, d_out, rank, 5, dtype,
                              seed=d_in + rank)
    before = fl.fused_multi_lora.launches
    out = fl.fused_multi_lora(x, a, b, ids)
    assert fl.fused_multi_lora.launches == before + 1
    again = fl.fused_multi_lora(x, a, b, ids)
    ref = fl.fused_multi_lora_plain(x, a, b, ids)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, again)
    assert not bool(out[ids == 0].any())     # slot 0: exactly zero
    tol = _LORA_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_fused_lora_kernel_refuses_what_it_does_not_take():
    _need_gpu()
    x, a, b, ids = _lora_case(2, 1, 256, 128, 16, 3, torch.float32, 0)
    with pytest.raises(ValueError, match='rank'):
        fl.fused_multi_lora(x, a[..., :12].contiguous(),
                            b[:, :12].contiguous(), ids)
    with pytest.raises(TypeError, match='int32'):
        fl.fused_multi_lora(x, a, b, ids.long())
    with pytest.raises(TypeError, match='dtype'):
        fl.fused_multi_lora(x, a.bfloat16(), b.bfloat16(), ids)


# The grouped kernel (LoRAGroup): targets of one fused projection adding
# their scaled deltas into y's column slices in place, against the plain
# per-target composition y[..., s] += plain(...) * scale. Group shapes:
# name -> (IN, OUT of each target); the last one's widths are not
# multiples of 8 (the CUDA-core route with scalar accesses).
_LORA_GROUPS = {'qkv': (256, (256, 64, 64)), 'o': (256, (256,)),
                'gate_up': (256, (512, 512)), 'down': (512, (256,)),
                'ragged': (300, (203, 97))}
_LORA_SCALE = 2.0


def _lora_group_case(name, batch, seq, rank, slots, dtype, seed, ids=None):
    d_in, outs = _LORA_GROUPS[name]
    rng = np.random.RandomState(seed)

    def dev(arr, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(arr)).to('cuda', dt)

    stacks = []
    for d_out in outs:
        a = rng.randn(slots, d_in, rank) / np.sqrt(d_in)
        b = rng.randn(slots, rank, d_out) * 0.25
        a[0] = b[0] = 0.0
        stacks.append((dev(a), dev(b)))
    offsets = [sum(outs[:i]) for i in range(len(outs))]
    group = fl.LoRAGroup(stacks, offsets, sum(outs), _LORA_SCALE)
    x = dev(rng.randn(batch, seq, d_in))
    y = dev(rng.randn(batch, seq, sum(outs)))
    if ids is None:
        ids = rng.randint(0, slots, batch)
        ids[0] = 0
    return group, stacks, offsets, x, y, dev(np.asarray(ids), torch.int32)


def _lora_composition(stacks, offsets, x, y, ids):
    y = y.clone()
    for (a, b), off in zip(stacks, offsets):
        y[..., off:off + b.shape[2]] += \
            fl.fused_multi_lora_plain(x, a, b, ids) * _LORA_SCALE
    return y


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('rank', [8, 16, 32, 64])
@pytest.mark.parametrize('batch,seq', [(8, 1), (3, 17), (1, 255), (2, 256)])
@pytest.mark.parametrize('name', sorted(_LORA_GROUPS))
def test_lora_group_kernel_matches_plain(name, batch, seq, rank, dtype):
    _need_gpu()
    group, stacks, offsets, x, y0, ids = _lora_group_case(
        name, batch, seq, rank, 5, dtype, seed=rank + seq)
    before = fl.fused_multi_lora.launches
    out = group(x, y0.clone(), ids)
    assert fl.fused_multi_lora.launches == before + 1
    again = group(x, y0.clone(), ids)
    ref = _lora_composition(stacks, offsets, x, y0, ids)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    zero = ids == 0
    assert torch.equal(out[zero], y0[zero])     # slot 0: y unchanged
    tol = _LORA_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    for row in range(batch):                     # alone = in the batch
        alone = group(x[row:row + 1].contiguous(), y0[row:row + 1].clone(),
                      ids[row:row + 1].contiguous())
        assert torch.equal(alone, out[row:row + 1])
    tensor_cores = (dtype == torch.bfloat16 and seq >= 16 and rank >= 16
                    and name != 'ragged')
    assert group.plan(seq)[0] == ('tensor_cores' if tensor_cores
                                  else 'cuda_cores')


@pytest.mark.cuda
@pytest.mark.parametrize('seq', [1, 17, 64])
def test_lora_group_32_rows_over_9_slots(seq):
    _need_gpu()
    ids = np.arange(32) % 9
    group, stacks, offsets, x, y0, ids = _lora_group_case(
        'qkv', 32, seq, 16, 9, torch.bfloat16, seed=seq, ids=ids)
    out = group(x, y0.clone(), ids)
    ref = _lora_composition(stacks, offsets, x, y0, ids)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(out, group(x, y0.clone(), ids))
    for row in range(32):
        alone = group(x[row:row + 1].contiguous(), y0[row:row + 1].clone(),
                      ids[row:row + 1].contiguous())
        assert torch.equal(alone, out[row:row + 1])


@pytest.mark.cuda
def test_lora_group_refuses_what_it_does_not_take():
    _need_gpu()
    group, stacks, offsets, x, y, ids = _lora_group_case(
        'qkv', 2, 3, 16, 3, torch.bfloat16, seed=0)
    a, b = stacks[0]
    with pytest.raises(ValueError, match='rank in'):
        fl.LoRAGroup([(a[..., :4].contiguous(), b[:, :4].contiguous())],
                     [0], 256, 1.0)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        fl.LoRAGroup([(a.half(), b.half())], [0], 256, 1.0)
    with pytest.raises(TypeError, match='must be'):
        group(x.float(), y, ids)
    with pytest.raises(ValueError, match='contiguous'):
        group(x, y.transpose(0, 1).contiguous().transpose(0, 1), ids)
    with pytest.raises(ValueError, match='int32'):
        group(x, y, ids.long())
    with pytest.raises(ValueError, match='do not fit'):
        group(x, y[..., :128].contiguous(), ids)


# ------------------------------------------------- ring chunk-update kernel
# Tolerances on (o, m, l): m and l 1e-5 absolute and relative (both sum
# the unrounded p in fp32, in other orders); o compared as o / l, the
# attention output the ring finishes with, at the flash tolerances: fp32
# 1e-5, bf16 2e-2 (the kernel rounds p against its running max, the plain
# version against the chunk's max; both round P·V to bf16 once).

from skypilot_tpu_torch.ops import ring_attention as ra  # noqa: E402

_RING_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _ring_state(q, k, v, carried, sm_scale):
    """Fresh (m = -1e30) state, or the state after one plain full hop of
    the same q over another K/V chunk."""
    batch, s_q, heads, head_dim = q.shape
    o = torch.zeros((batch, s_q, heads, head_dim), device='cuda')
    m = torch.full((batch, heads, s_q), -1e30, device='cuda')
    l = torch.zeros((batch, heads, s_q), device='cuda')
    if carried:
        o, m, l = ra.chunk_update_plain(q, k.flip(1), v.flip(1), o, m, l,
                                        sm_scale=sm_scale, mask_mode=0,
                                        q_offset=0, k_offset=0)
    return o, m, l


def _ring_close(got, ref, dtype):
    (o, m, l), (ro, rm, rl) = got, ref
    torch.testing.assert_close(m, rm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, rl, atol=1e-5, rtol=1e-5)
    tol = _RING_TOL[dtype]
    torch.testing.assert_close(
        o / l.transpose(1, 2)[..., None], ro / rl.transpose(1, 2)[..., None],
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('s_q,s_k,head_dim,mode,q_off,k_off,carried', [
    (128, 128, 128, 0, 128, 0, False),    # past chunk, full
    (128, 128, 128, 1, 128, 128, False),  # own chunk, causal, tiles skipped
    (128, 128, 128, 1, 128, 128, True),   # the same with carried state
    (100, 72, 128, 1, 150, 100, True),    # ragged, q after k, no skip
    (128, 128, 128, 1, 0, 128, False),    # every row fully masked, fresh
    (128, 128, 128, 1, 64, 128, False),   # first tiles masked, then seen
    (96, 96, 64, 0, 96, 0, True),         # head_dim 64
    (64, 96, 256, 1, 96, 96, False),      # head_dim 256, 32-row tiles
])
def test_ring_chunk_kernel_matches_plain(dtype, s_q, s_k, head_dim, mode,
                                         q_off, k_off, carried):
    _need_gpu()
    q, k, v, _ = _flash_case(2, max(s_q, s_k), 4, 2, head_dim, dtype, s_q)
    q, k, v = q[:, :s_q], k[:, :s_k], v[:, :s_k]      # strided views
    scale = head_dim ** -0.5
    state = _ring_state(q, k, v, carried, scale)
    opts = dict(sm_scale=scale, mask_mode=mode, q_offset=q_off,
                k_offset=k_off)
    before = ra.chunk_update.launches
    got = ra.chunk_update(q, k, v, *state, **opts)
    assert ra.chunk_update.launches == before + 1
    again = ra.chunk_update(q, k, v, *state, **opts)
    ref = ra.chunk_update_plain(q, k, v, *state, **opts)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _ring_close(got, ref, dtype)
    if q_off + s_q <= k_off and not carried:
        # Fully masked rows: p = 1 for every key, l = Sk, as the reference.
        assert bool((got[2] == s_k).all())


# The wgmma ring kernel's grouped tiles (128 / n_rep positions x n_rep
# heads) at n_rep 1, 2, 4 and 8, head_dim 64 and 128, Sq != Sk, q, k and
# v strided column slices of one fused (B, S, H + 2 KV, D) tensor; mask
# modes and offsets as the ring gives them. Reruns equal.
@pytest.mark.cuda
@pytest.mark.parametrize('heads,kv_heads,head_dim,s_q,s_k,mode,q_off,k_off', [
    (8, 8, 128, 200, 136, 1, 200, 200),   # n_rep 1, diagonal, skips
    (16, 8, 64, 136, 200, 0, 400, 0),     # n_rep 2, full
    (16, 4, 128, 150, 150, 1, 150, 0),    # n_rep 4, past chunk causal
    (16, 2, 64, 96, 160, 1, 64, 128),     # n_rep 8, masked then seen
    (8, 2, 128, 64, 100, 1, 0, 128),      # n_rep 4, every row masked
])
def test_ring_wgmma_grouped_tiles_from_fused_qkv(heads, kv_heads, head_dim,
                                                 s_q, s_k, mode, q_off,
                                                 k_off):
    _need_gpu()
    gen = torch.Generator(device='cuda').manual_seed(heads + s_q + head_dim)
    qkv = torch.randn((2, max(s_q, s_k), heads + 2 * kv_heads, head_dim),
                      generator=gen, device='cuda').bfloat16()
    q, k, v = qkv.split([heads, kv_heads, kv_heads], dim=2)
    q, k, v = q[:, :s_q], k[:, :s_k], v[:, :s_k]
    scale = head_dim ** -0.5
    for carried in (False, True):
        state = _ring_state(q, k, v, carried, scale)
        opts = dict(sm_scale=scale, mask_mode=mode, q_offset=q_off,
                    k_offset=k_off)
        got = ra.chunk_update(q, k, v, *state, **opts)
        again = ra.chunk_update(q, k, v, *state, **opts)
        ref = ra.chunk_update_plain(q, k, v, *state, **opts)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _ring_close(got, ref, torch.bfloat16)
        if q_off + s_q <= k_off and not carried:
            assert bool((got[2] == s_k).all())


@pytest.mark.cuda
def test_ring_backward_and_forward_run_kernels():
    """The one-process ring on the card: the chunk kernel forward, the
    flash dQ and dK/dV kernels backward. Its gradients are within 5e-2 of
    the flash path's: bf16 rounds each hop's share before the fp32 sum
    (up to 4 shares a chunk here), the flash kernels round once."""
    _need_gpu()
    q, k, v, g = _flash_case(2, 256, 4, 2, 128, torch.bfloat16, 3)
    launches = (ra.chunk_update.launches, fa.flash_forward.launches,
                fa.flash_dq.launches, fa.flash_dkv.launches)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ra.ring_attention_sharded(*leaves, sp=4).backward(g)
    after = (ra.chunk_update.launches, fa.flash_forward.launches,
             fa.flash_dq.launches, fa.flash_dkv.launches)
    # 10 visited hops of 4 ranks; no flash forward; one dQ, dK/dV a hop.
    assert tuple(a - b for a, b in zip(after, launches)) == (10, 0, 10, 10)
    flash = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention(*flash, impl='pallas')
    ref.backward(g)
    for a, b in zip(leaves, flash):
        torch.testing.assert_close(a.grad.float(), b.grad.float(),
                                   atol=5e-2, rtol=5e-2)


@pytest.mark.cuda
def test_ring_chunk_kernel_refuses_what_it_does_not_take():
    _need_gpu()
    q, k, v, _ = _flash_case(1, 64, 2, 1, 128, torch.float32, 0)
    state = _ring_state(q, k, v, False, 0.1)
    opts = dict(sm_scale=0.1, mask_mode=1, q_offset=0, k_offset=0)
    with pytest.raises(ValueError, match='head_dim'):
        ra.chunk_update(q[..., :96], k[..., :96], v[..., :96],
                        state[0][..., :96].contiguous(), *state[1:], **opts)
    with pytest.raises(TypeError, match='dtype'):
        ra.chunk_update(q, k.bfloat16(), v.bfloat16(), *state, **opts)
    with pytest.raises(ValueError, match='contiguous float32'):
        ra.chunk_update(q, k, v, state[0].transpose(1, 2).contiguous()
                        .transpose(1, 2), *state[1:], **opts)


# ------------------------------------------- kernel limits at construction

@pytest.mark.cuda
def test_engine_and_trainer_refuse_kernel_shapes_at_construction():
    """On the card a model the kernels cannot run fails at construction
    (ops/limits.py), not at its first tick or step."""
    _need_gpu()
    import dataclasses

    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    from skypilot_tpu_torch.train import trainer
    with pytest.raises(ValueError, match='divides 64'):
        ContinuousBatchingEngine('llama3-1b', paged_block_size=128)
    tiny = dataclasses.replace(get_config('test-tiny'), attention_impl='auto')
    with pytest.raises(ValueError, match='head_dim'):
        trainer.create_train_state(tiny, device='cuda')


# ------------------------------------------ step graphs of the serving engine

def _graph_engine(dtype, kv_quant=None, adapters=0, decode_chunk=4):
    """A small model (head_dim 128) in the serving engine on the card,
    idle, its pools filled with random K/V (and scale rows)."""
    import dataclasses

    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.convert import adapter_layout
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    cfg = dataclasses.replace(
        get_config('llama3-8b'), name='graph-small', vocab_size=1024,
        d_model=512, num_layers=2, num_heads=4, num_kv_heads=2, d_mlp=1024,
        max_seq_len=512, dtype=dtype)
    kw = {}
    if adapters:
        kw = dict(max_adapters=adapters, adapter_rank=16, adapter_alpha=32.0,
                  adapter_targets='q,k,v,o,gate,up,down')
    engine = ContinuousBatchingEngine(
        cfg, num_slots=4, paged_block_size=16, prefill_chunk=64,
        kv_quant=kv_quant, decode_chunk=decode_chunk, rng_seed=3,
        device='cuda', **kw)
    gen = torch.Generator(device='cuda').manual_seed(5)
    for pool in (engine._k_pool, engine._v_pool):  # pylint: disable=protected-access
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                     device='cuda', dtype=torch.int8))
        else:
            pool.normal_(generator=gen)
    for scale in (engine._k_scale, engine._v_scale):  # pylint: disable=protected-access
        if scale is not None:
            scale.uniform_(0.001, 0.02, generator=gen)
    rng = np.random.default_rng(9)
    for i in range(adapters):

        def walk(node):
            return {k: (walk(v) if isinstance(v, dict) else
                        (rng.standard_normal(v) * 0.05).astype(np.float32))
                    for k, v in sorted(node.items())}
        tree = walk(adapter_layout(engine.cfg))
        engine.load_adapter(f'ad{i}', tree)
    return engine


def _stage_decode(engine, positions):
    """Stage 4 rows at `positions` (None: an inert row) on blocks 1...,
    and return the eager step's inputs."""
    width = engine._blocks_per_seq + 1  # pylint: disable=protected-access
    tables = np.zeros((4, width), np.int32)
    nxt = 1
    for row, pos in enumerate(positions):
        if pos is not None:
            need = (pos + 8) // 16 + 1
            tables[row, :need] = np.arange(nxt, nxt + need)
            nxt += need
    tokens = np.array([[7 * r + 3] for r in range(4)], np.int32)
    pos = np.array([[p or 0] for p in positions], np.int32)
    aids = np.array([r % (engine.max_adapters + 1) for r in range(4)],
                    np.int32)
    dec = engine._dec  # pylint: disable=protected-access
    dec.feed.put([tokens[:, 0], pos[:, 0]])
    dec.tables.put(tables)
    dec.temps.put(np.zeros(4, np.float32))
    if dec.aids is not None:
        dec.aids.put(aids)
    dev = {'tokens': torch.from_numpy(tokens).cuda(),
           'positions': torch.from_numpy(pos).cuda(),
           'temps': torch.zeros(4, device='cuda'),
           'tables': torch.from_numpy(tables).cuda(),
           'aids': (torch.from_numpy(aids).cuda() if dec.aids is not None
                    else None)}
    return dev


def _pools(engine):
    return [t for t in (engine._k_pool, engine._v_pool, engine._k_scale,  # pylint: disable=protected-access
                        engine._v_scale) if t is not None]  # pylint: disable=protected-access


_GRAPH_CASES = {'bf16': ('bfloat16', None, 0), 'fp32': ('float32', None, 0),
                'int8_lora': ('bfloat16', 'int8', 3)}


@pytest.mark.cuda
@pytest.mark.parametrize('k', [1, 4])
@pytest.mark.parametrize('case', sorted(_GRAPH_CASES))
def test_decode_graph_equals_eager_step(case, k):
    """A replay of the engine's k-step decode graph gives the eager
    `_decode_impl` steps' tokens bit for bit, and a graph of the forward
    its logits; the pools end equal; the launch counters count
    replays."""
    _need_gpu()
    dtype, kv_quant, adapters = _GRAPH_CASES[case]
    engine = _graph_engine(dtype, kv_quant, adapters, decode_chunk=k)
    try:
        with torch.inference_mode():
            saved = [t.clone() for t in _pools(engine)]
            inputs = _stage_decode(engine, [5, 40, None, 130])
            eager, logits = [], None
            tokens, positions = inputs['tokens'], inputs['positions'].clone()
            for j in range(k):
                if j == 0:
                    logits = engine._forward(  # pylint: disable=protected-access
                        tokens, positions, inputs['tables'],
                        inputs['aids'])[:, -1].clone()
                nxt = engine._decode_impl(  # pylint: disable=protected-access
                    tokens, positions, inputs['temps'], inputs['tables'],
                    False, inputs['aids'])
                eager.append(nxt)
                tokens, positions = nxt[:, None], positions + 1
            eager = torch.stack(eager, dim=1).cpu()
            after_eager = [t.clone() for t in _pools(engine)]
            for t, s in zip(_pools(engine), saved):
                t.copy_(s)
            engine._run_decode(k, False)  # pylint: disable=protected-access  (capture)
            for t, s in zip(_pools(engine), saved):
                t.copy_(s)
            _stage_decode(engine, [5, 40, None, 130])
            counts = (pa.paged_decode_attention.launches,
                      pa.paged_decode_attention.int8_launches,
                      fl.fused_multi_lora.launches)
            got = engine._run_decode(k, False).result()  # pylint: disable=protected-access
            layers = engine.cfg.num_layers
            assert (pa.paged_decode_attention.launches - counts[0],
                    pa.paged_decode_attention.int8_launches - counts[1],
                    fl.fused_multi_lora.launches - counts[2]) == (
                (0 if kv_quant else k * layers),
                (k * layers if kv_quant else 0),
                (k * layers * 4 if adapters else 0))
            assert torch.equal(torch.from_numpy(got), eager)
            for t, s in zip(_pools(engine), after_eager):
                assert torch.equal(t, s)
            # The feed advanced in place: positions + k, the last tokens.
            dec = engine._dec  # pylint: disable=protected-access
            assert torch.equal(dec.positions.cpu(),
                               inputs['positions'].cpu() + k)
            assert torch.equal(dec.tokens.cpu()[:, 0], eager[:, -1])
            # The forward alone, captured and replayed.
            static = torch.empty_like(logits)
            for t, s in zip(_pools(engine), saved):
                t.copy_(s)
            _stage_decode(engine, [5, 40, None, 130])

            def forward():
                static.copy_(engine._forward(  # pylint: disable=protected-access
                    dec.tokens, dec.positions, dec.tables.dev,
                    dec.aids.dev if dec.aids is not None else None)[:, -1])

            engine._steps.run(('test-forward',), forward)  # pylint: disable=protected-access
            engine._steps.run(('test-forward',), forward)  # pylint: disable=protected-access
            torch.cuda.synchronize()
            assert torch.equal(static, logits)
    finally:
        engine.stop()


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(_GRAPH_CASES))
def test_prefill_graph_equals_eager_chunk(case):
    """The prefill graph's first token is the argmax of the eager
    `_prefill_chunk_impl` logits, and a graph of the chunk gives those
    logits bit for bit from its 0-d start and row-index inputs."""
    _need_gpu()
    dtype, kv_quant, adapters = _GRAPH_CASES[case]
    engine = _graph_engine(dtype, kv_quant, adapters)
    try:
        with torch.inference_mode():
            width = engine._blocks_per_seq + 1  # pylint: disable=protected-access
            table = np.zeros(width, np.int32)
            table[:10] = np.arange(3, 13)
            chunk = (np.arange(64) * 13 % 1024).astype(np.int32)
            start, n, aid = 64, 41, min(adapters, 2)
            saved = [t.clone() for t in _pools(engine)]
            aids = (torch.tensor([aid], dtype=torch.int32, device='cuda')
                    if adapters else None)
            eager = engine._prefill_chunk_impl(  # pylint: disable=protected-access
                torch.from_numpy(chunk[None]).cuda(),
                torch.from_numpy(table[None]).cuda(), start, n - 1,
                aids).clone()
            pf = engine._pf  # pylint: disable=protected-access
            pf.ints.put(np.concatenate([table, chunk, [start, n - 1, aid]]))
            for t, s in zip(_pools(engine), saved):
                t.copy_(s)
            engine._run_prefill(False)  # pylint: disable=protected-access
            engine._run_prefill(False)  # pylint: disable=protected-access
            torch.cuda.synchronize()
            assert int(pf.first) == int(torch.argmax(eager))
            static = torch.empty_like(eager)

            def chunk_logits():
                static.copy_(engine._prefill_chunk_impl(  # pylint: disable=protected-access
                    pf.tokens, pf.table, pf.start, pf.logits_at, pf.aid))

            engine._steps.run(('test-chunk',), chunk_logits)  # pylint: disable=protected-access
            engine._steps.run(('test-chunk',), chunk_logits)  # pylint: disable=protected-access
            torch.cuda.synchronize()
            assert torch.equal(static, eager)
    finally:
        engine.stop()


@pytest.mark.cuda
def test_sampling_decode_graph_draws_anew_each_replay():
    _need_gpu()
    engine = _graph_engine('bfloat16', decode_chunk=1)
    try:
        with torch.inference_mode():
            draws = []
            for _ in range(3):
                _stage_decode(engine, [5, 40, 60, 130])
                engine._dec.temps.put(np.ones(4, np.float32))  # pylint: disable=protected-access
                draws.append(engine._run_decode(1, True).result())  # pylint: disable=protected-access
            assert all(((d >= 0) & (d < 1024)).all() for d in draws)
            assert len({d.tobytes() for d in draws}) > 1
    finally:
        engine.stop()


@pytest.mark.cuda
def test_graph_captured_before_a_larger_lora_call_replays_right():
    """A larger call replaces the LoRA scratch; a graph captured on the
    smaller one still replays into live memory and stays right."""
    _need_gpu()
    from skypilot_tpu_torch.models import step_graph
    fl._workspaces.pop(torch.device('cuda', torch.cuda.current_device()),  # pylint: disable=protected-access
                       None)
    group, stacks, offsets, x, y0, ids = _lora_group_case(
        'gate_up', 8, 1, 16, 5, torch.bfloat16, seed=4)
    y = y0.clone()

    def body():
        y.copy_(y0)
        group(x, y, ids)

    steps = step_graph.StepGraphs(torch.device('cuda'))
    steps.run('lora', body)
    captured = weakref.ref(fl._workspaces[x.device])  # pylint: disable=protected-access
    group2, _, _, x2, y2, ids2 = _lora_group_case(
        'gate_up', 2, 256, 16, 5, torch.bfloat16, seed=5)
    group2(x2, y2, ids2)
    assert fl._workspaces[x.device] is not captured()  # pylint: disable=protected-access
    assert captured() is not None       # the graph's scratch stays alive
    steps.run('lora', body)
    torch.cuda.synchronize()
    ref = _lora_composition(stacks, offsets, x, y0, ids)
    tol = _LORA_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_capture_raises_on_cuda_rather_than_stepping_eagerly():
    """A step that cannot be captured fails its tick's request on the
    card; nothing runs it eagerly instead."""
    _need_gpu()
    from skypilot_tpu_torch.models import step_graph
    steps = step_graph.StepGraphs(torch.device('cuda'))
    with pytest.raises(RuntimeError):
        steps.run('sync', lambda: torch.ones(1, device='cuda').item())
    assert steps.keys == []
    engine = _graph_engine('bfloat16', decode_chunk=1)
    real = engine._decode_body  # pylint: disable=protected-access

    def syncing(k, sampling):
        real(k, sampling)
        engine._dec.out[k].cpu()  # pylint: disable=protected-access

    engine._decode_body = syncing  # pylint: disable=protected-access
    try:
        emitted = []
        future = engine.submit([1, 2, 3], max_new_tokens=4,
                               on_token=emitted.append)
        with pytest.raises(RuntimeError):
            future.result(timeout=120)
        # The prefill's first token was emitted, and no decode column.
        assert len([t for t in emitted if t is not None]) == 1
        assert ('decode', 1, False) not in engine._steps.keys  # pylint: disable=protected-access
        torch.ones(1, device='cuda').item()     # the device serves on
    finally:
        engine.stop()


# ------------------------------------------------ the prefix cache's traffic
#
# A prefix hit's first prefill chunk starts where its prefix ends, mid-block
# and mid-tile, and decode rows share the cached prefix's physical blocks.
# bf16 queries over bf16 or int8 pools (kv_heads 2, n_rep 4, head_dim 128,
# blocks of 16), each against the plain version, reruns bit-identical.

_HIT_STARTS = (1, 15, 17, 63, 1543)


def _pools_of(q, kp, vp, kv_quant):
    """bf16 q and pools, or int8 pools with fp32 scale rows."""
    if not kv_quant:
        return q.bfloat16(), kp.bfloat16(), vp.bfloat16(), {}
    (k8, ks), (v8, vs) = int8_quantize(kp), int8_quantize(vp)
    return q.bfloat16(), k8, v8, dict(k_scale=ks[..., None].contiguous(),
                                      v_scale=vs[..., None].contiguous())


def _held_bf16(args, scales):
    out = pa.paged_decode_attention(*args, **scales)
    again = pa.paged_decode_attention(*args, **scales)
    ref = pa.paged_decode_attention_plain(*args, **scales)
    torch.cuda.synchronize()
    tol = _TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(out, again)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', [False, True], ids=['bf16', 'int8'])
@pytest.mark.parametrize('start', _HIT_STARTS)
def test_prefill_chunk_at_hit_boundaries(start, kv_quant):
    _need_gpu()
    rng = np.random.RandomState(start)
    cur_len, bs, bps = 64, 16, 104
    q = torch.from_numpy(rng.randn(1, cur_len, 8, 128)).float().cuda()
    kp = torch.from_numpy(rng.randn(bps + 1, bs, 2, 128)).float().cuda()
    vp = torch.from_numpy(rng.randn(bps + 1, bs, 2, 128)).float().cuda()
    kp[0] = vp[0] = 50.0
    tables = torch.zeros((1, bps), dtype=torch.int32)
    need = (start + cur_len - 1) // bs + 1
    tables[0, :need] = torch.from_numpy(rng.permutation(bps)[:need] + 1)
    pos = torch.arange(start, start + cur_len, dtype=torch.int32)[None]
    q, kp, vp, scales = _pools_of(q, kp, vp, kv_quant)
    _held_bf16((q, kp, vp, tables.cuda(), pos.cuda()), scales)


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', [False, True], ids=['bf16', 'int8'])
@pytest.mark.parametrize('shift', [1, 7, 16, 37])
def test_chunk_rows_do_not_depend_on_their_place(shift, kv_quant):
    """The same query rows at the same positions, `shift` rows further
    down a chunk that starts `shift` earlier (a hit's chunk against the
    cold prefill's), give bit-identical outputs."""
    _need_gpu()
    rng = np.random.RandomState(shift)
    cur_len, bs, bps, start = 64, 16, 32, 300
    q = torch.from_numpy(rng.randn(1, cur_len, 8, 128)).float().cuda()
    kp = torch.from_numpy(rng.randn(bps + 1, bs, 2, 128)).float().cuda()
    vp = torch.from_numpy(rng.randn(bps + 1, bs, 2, 128)).float().cuda()
    q, kp, vp, scales = _pools_of(q, kp, vp, kv_quant)
    tables = torch.arange(1, bps + 1, dtype=torch.int32).cuda()[None]
    pos = torch.arange(start, start + cur_len, dtype=torch.int32).cuda()[None]
    want = pa.paged_decode_attention(q, kp, vp, tables, pos, **scales)
    moved = torch.zeros_like(q)
    moved[0, shift:] = q[0, :cur_len - shift]
    got = pa.paged_decode_attention(moved, kp, vp, tables, pos - shift,
                                    **scales)
    assert torch.equal(got[0, shift:], want[0, :cur_len - shift])


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', [False, True], ids=['bf16', 'int8'])
def test_decode_rows_sharing_prefix_blocks(kv_quant):
    """8 decode rows whose tables share their first 40 blocks: equal to
    the plain version and, bit for bit, to the same rows over private
    copies of those blocks."""
    _need_gpu()
    rng = np.random.RandomState(8)
    rows, shared_n, bs, bps = 8, 40, 16, 64
    positions = [640 + 45 * r for r in range(rows)]
    tails = [p // bs + 1 - shared_n for p in positions]
    num_blocks = 1 + shared_n * (1 + rows) + sum(tails)
    q = torch.from_numpy(rng.randn(rows, 1, 8, 128)).float().cuda()
    kp = torch.from_numpy(rng.randn(num_blocks, bs, 2, 128)).float().cuda()
    vp = torch.from_numpy(rng.randn(num_blocks, bs, 2, 128)).float().cuda()
    q, kp, vp, scales = _pools_of(q, kp, vp, kv_quant)
    shared = torch.zeros((rows, bps), dtype=torch.int32)
    private = torch.zeros((rows, bps), dtype=torch.int32)
    nxt = 1 + shared_n * (1 + rows)
    for r in range(rows):
        copies = torch.arange(shared_n) + 1 + shared_n * (1 + r)
        for t in [kp, vp] + list(scales.values()):
            t[copies.cuda()] = t[1:1 + shared_n].clone()
        shared[r, :shared_n] = torch.arange(1, 1 + shared_n)
        private[r, :shared_n] = copies
        shared[r, shared_n:shared_n + tails[r]] = torch.arange(
            nxt, nxt + tails[r])
        private[r, shared_n:shared_n + tails[r]] = torch.arange(
            nxt, nxt + tails[r])
        nxt += tails[r]
    pos = torch.tensor(positions, dtype=torch.int32)[:, None].cuda()
    out = _held_bf16((q, kp, vp, shared.cuda(), pos), scales)
    assert torch.equal(out, pa.paged_decode_attention(
        q, kp, vp, private.cuda(), pos, **scales))


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', [None, 'int8'], ids=['bf16', 'int8'])
def test_cow_then_hit_chunk_equals_cold_chunk(kv_quant):
    """The engine at async depth 1 on the card (every chunk a graph
    replay): a prompt extending a cached one copies the boundary block on
    write and prefills its suffix from position 70; its tokens equal the
    cold prefill's, and the K/V rows it publishes equal the cold ones
    (bf16 tolerance; scale rows too under int8)."""
    _need_gpu()
    import dataclasses

    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    cfg = dataclasses.replace(
        get_config('llama3-8b'), name='prefix-small', vocab_size=1024,
        d_model=512, num_layers=2, num_heads=4, num_kv_heads=2, d_mlp=1024,
        max_seq_len=512, dtype='bfloat16')
    engine = ContinuousBatchingEngine(
        cfg, num_slots=4, paged_block_size=16, prefill_chunk=64,
        kv_quant=kv_quant, async_depth=1, prefix_cache=4, rng_seed=3,
        device='cuda')
    base = [(7 * i + 3) % 1024 for i in range(70)]
    ext = base + [(11 * i + 5) % 1024 for i in range(50)]

    def published(key):
        blocks = engine._prefix_entries._lru[tuple(key)]  # pylint: disable=protected-access
        return [t[:, blocks].flatten(1, 2)[:, :len(key)].clone()
                for t in (engine._k_pool, engine._v_pool, engine._k_scale,  # pylint: disable=protected-access
                          engine._v_scale) if t is not None]  # pylint: disable=protected-access

    try:
        cold, _ = engine.generate(ext, max_new_tokens=12)
        cold_rows = published(ext)
        index, pool = engine._prefix_entries, engine._pool  # pylint: disable=protected-access
        while len(index):
            pool.release(index.pop_lru()[1])
        assert pool.used == 1
        engine.generate(base, max_new_tokens=12)
        hot, _ = engine.generate(ext, max_new_tokens=12)
        assert hot == cold
        assert engine.prefix_stats['hits'] == 1
        assert engine.paged_stats['cow_copies'] == 1
        assert ('prefill', False) in engine._steps.keys  # pylint: disable=protected-access
        tol = _TOL[torch.bfloat16]
        for got, want in zip(published(ext), cold_rows):
            if got.dtype == torch.int8:
                assert (got.int() - want.int()).abs().max() <= 1
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)
    finally:
        engine.stop()


# ------------------------------------------ the speculative verify's shapes
#
# A verify tick runs kernels 1/2 at T = K+1 query rows a slot on the decode
# route (llama3-8b: n_rep 4, so (K+1) * 4 grouped rows under 64) and kernel
# 7 at x (8, K+1, IN). B 8, KV 8, D 128, blocks of 16, 8192 keys; rows
# straddle the 256-key (128 over int8) split boundaries; the last row is
# inert (position 0, an all-scratch table).

_VERIFY_STARTS = (0, 250, 1020, 3000, 4093, 6000, 8180, None)


def _verify_case(span, kv_quant, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    bs, bps, kv_heads = 16, 512, 8
    num_blocks = 8 * bps + 1
    q = torch.randn((8, span, kv_heads * 4, 128), generator=gen,
                    device='cuda')
    kp = torch.randn((num_blocks, bs, kv_heads, 128), generator=gen,
                     device='cuda')
    vp = torch.randn((num_blocks, bs, kv_heads, 128), generator=gen,
                     device='cuda')
    perm = (torch.randperm(num_blocks - 1, generator=gen, device='cuda')
            + 1).cpu()
    tables = torch.zeros((8, bps), dtype=torch.int32)
    pos = torch.zeros((8, span), dtype=torch.int32)
    for row, start in enumerate(_VERIFY_STARTS):
        if start is None:
            continue
        start = min(start, bps * bs - span)
        pos[row] = torch.arange(start, start + span)
        need = (start + span - 1) // bs + 1
        tables[row, :need] = perm[row * bps:row * bps + need]
    q, kp, vp, scales = _pools_of(q, kp, vp, kv_quant)
    return (q, kp, vp, tables.cuda(), pos.cuda()), scales


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', [False, True], ids=['bf16', 'int8'])
@pytest.mark.parametrize('span', [5, 9])
def test_verify_span_kernel_matches_plain(span, kv_quant):
    _need_gpu()
    args, scales = _verify_case(span, kv_quant, seed=span)
    assert pa.kernel_route(torch.bfloat16, 128, span * 4) == 'decode'
    counter = 'int8_launches' if kv_quant else 'launches'
    before = getattr(pa.paged_decode_attention, counter)
    _held_bf16(args, scales)
    assert getattr(pa.paged_decode_attention, counter) == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', [False, True], ids=['bf16', 'int8'])
@pytest.mark.parametrize('span', [5, 9])
def test_verify_rows_equal_their_t1_calls(span, kv_quant):
    """Each row of a verify span gets, bit for bit, the attention the same
    query gets alone at T = 1 over the same pools: the decode-route
    analogue of test_chunk_rows_do_not_depend_on_their_place."""
    _need_gpu()
    (q, kp, vp, tables, pos), scales = _verify_case(span, kv_quant,
                                                    seed=10 + span)
    out = pa.paged_decode_attention(q, kp, vp, tables, pos, **scales)
    for t in range(span):
        alone = pa.paged_decode_attention(
            q[:, t:t + 1].contiguous(), kp, vp, tables,
            pos[:, t:t + 1].contiguous(), **scales)
        assert torch.equal(alone[:7, 0], out[:7, t]), t


@pytest.mark.cuda
@pytest.mark.parametrize('span', [5, 9])
@pytest.mark.parametrize('name', sorted(_LORA_GROUPS))
def test_lora_group_at_the_verify_shape(name, span):
    """Kernel 7 at x (8, K+1, IN) with adapter slots spread over 0-4:
    against the plain composition, reruns and a row alone bit-identical,
    on the route plan(K+1) names."""
    _need_gpu()
    group, stacks, offsets, x, y0, ids = _lora_group_case(
        name, 8, span, 16, 5, torch.bfloat16, seed=span,
        ids=[0, 1, 2, 3, 4, 1, 0, 2])
    assert group.plan(span)[0] == 'cuda_cores'
    out = group(x, y0.clone(), ids)
    ref = _lora_composition(stacks, offsets, x, y0, ids)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(out, group(x, y0.clone(), ids))
    for row in range(8):
        alone = group(x[row:row + 1].contiguous(), y0[row:row + 1].clone(),
                      ids[row:row + 1].contiguous())
        assert torch.equal(alone, out[row:row + 1])


@pytest.mark.cuda
@pytest.mark.parametrize('sampling', [False, True], ids=['greedy', 'mixed'])
@pytest.mark.parametrize('case', sorted(_GRAPH_CASES))
def test_verify_graph_equals_eager_verify(case, sampling):
    """A replay of the ('verify', K, sampling) graph gives the eager
    `_verify_impl`'s columns and accepted counts (greedy rows; a sampling
    row accepts 0) and leaves the pools as the eager step does; each
    replay adds one launch a layer (x 4 LoRA groups)."""
    _need_gpu()
    dtype, kv_quant, adapters = _GRAPH_CASES[case]
    engine = _graph_engine(dtype, kv_quant, adapters)
    k = 4
    try:
        with torch.inference_mode():
            saved = [t.clone() for t in _pools(engine)]
            inputs = _stage_decode(engine, [5, 40, None, 130])
            tokens = torch.cat([inputs['tokens'], torch.tensor(
                [[3, 1, 4, 1], [5, 9, 2, 6], [0, 0, 0, 0], [5, 3, 5, 8]],
                dtype=torch.int32, device='cuda')], dim=1)
            positions = inputs['positions'] + torch.arange(
                k + 1, dtype=torch.int32, device='cuda')
            temps = torch.tensor([0.0, 0.9 if sampling else 0.0, 0.0, 0.0],
                                 device='cuda')
            eager_out, eager_acc = engine._verify_impl(  # pylint: disable=protected-access
                tokens, positions, temps, inputs['tables'], False,
                inputs['aids'])
            after_eager = [t.clone() for t in _pools(engine)]
            v = engine._verify_buffers(k)  # pylint: disable=protected-access
            v.feed.put(np.stack([tokens.cpu().numpy(),
                                 positions.cpu().numpy()]))
            v.tables.put(inputs['tables'].cpu().numpy())
            v.temps.put(temps.cpu().numpy())
            if v.aids is not None:
                v.aids.put(inputs['aids'].cpu().numpy())
            for _ in range(2):       # the capture, then a replay
                for t, s in zip(_pools(engine), saved):
                    t.copy_(s)
                counts = (pa.paged_decode_attention.launches,
                          pa.paged_decode_attention.int8_launches,
                          fl.fused_multi_lora.launches)
                got = engine._run_verify(k, sampling).result()  # pylint: disable=protected-access
            layers = engine.cfg.num_layers
            assert (pa.paged_decode_attention.launches - counts[0],
                    pa.paged_decode_attention.int8_launches - counts[1],
                    fl.fused_multi_lora.launches - counts[2]) == (
                (0 if kv_quant else layers), (layers if kv_quant else 0),
                (layers * 4 if adapters else 0))
            assert ('verify', k, sampling) in engine._steps.keys  # pylint: disable=protected-access
            want = eager_out.cpu().numpy()
            acc = eager_acc.cpu().numpy()
            if sampling:
                acc[1] = 0
                assert (got[[0, 2, 3], :k + 1] == want[[0, 2, 3]]).all()
                assert (got[1, 1:k + 1] == want[1, 1:]).all()
            else:
                assert (got[:, :k + 1] == want).all()
            assert (got[:, k + 1] == acc).all()
            for t, s in zip(_pools(engine), after_eager):
                assert torch.equal(t, s)
    finally:
        engine.stop()


# ------------------------------------------------------ int8 weight product

@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('lead,n_in,n_out', [
    ((1, 8), 4096, 6144),         # llama3-8b decode tick, fused qkv
    ((1, 256), 4096, 28672),      # a prefill chunk, fused gate,up
    ((2, 7), 80, 96),             # two rows of an odd width
])
def test_int8_matmul_matches_dequantized_product(dtype, lead, n_in, n_out):
    """transformer.int8_matmul on the card (bf16: torch.mm with an fp32
    accumulator, reshaped back; fp32: x @ q) against (x.float() @
    q.float()) * scale, the reference's QuantDenseGeneral in fp32, within
    the file's tolerance of the compute dtype."""
    _need_gpu()
    from skypilot_tpu_torch.models.quantize import quantize_weight
    from skypilot_tpu_torch.models.transformer import int8_matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(n_out)
    x = torch.randn(*lead, n_in, device='cuda', generator=gen).to(dtype)
    q, scale = quantize_weight(0.02 * torch.randn(
        n_in, n_out, device='cuda', generator=gen))
    got = int8_matmul(x, q, scale, dtype)
    want = (x.float() @ q.float()) * scale
    assert got.shape == (*lead, n_out) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want, atol=_TOL[dtype],
                               rtol=_TOL[dtype])


# ------------------------------------------------------- LoRA train step

@pytest.mark.cuda
@pytest.mark.parametrize('targets', ['q,v', 'q,k,v,o,gate,up,down'])
def test_lora_train_steps_on_the_card_equal_the_cpu_steps(targets):
    """Two LoRA train steps (lr 0, then lr > 0, clipping active) of one
    small fp32 model (head_dim 128: the flash kernels) from identical
    seeded weights and a masked batch, on the card and on the CPU (the
    plain versions). Tolerances, chip_smoke's train_parity ones: loss and
    grad_norm 1e-4 relative (fp32 sums in other orders), adapters 5e-5
    absolute after the update; every base tensor bit-unchanged on both."""
    _need_gpu()
    import dataclasses

    from skypilot_tpu_torch.models import lora
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.train import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        get_config('llama3-1b'), name='lora-parity-small', vocab_size=1024,
        d_model=512, num_layers=2, num_heads=4, num_kv_heads=2, d_mlp=1024,
        max_seq_len=512, dtype='float32', param_dtype='float32',
        lora_rank=8, lora_alpha=16.0, lora_targets=targets)
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=10, grad_clip_norm=0.01)
    gen = torch.Generator().manual_seed(4)
    batches = [trainer.synthetic_batch(gen, 2, 200, cfg.vocab_size)
               for _ in range(2)]
    for b in batches:
        b['mask'][:, :37] = 0                      # a prompt, SFT-style
    results = {}
    for device in ('cpu', 'cuda'):
        state = trainer.create_train_state(cfg, tc, device='cpu', seed=5)
        base = {k: v.clone() for k, v in state.model.state_dict().items()
                if not lora.is_adapter_key(k)}
        state.model.to(device)
        state = trainer.TrainState(state.model, tc)
        step = trainer.make_train_step()
        metrics = [step(state, {k: v.to(device) for k, v in b.items()})
                   for b in batches]
        after = {k: v.cpu() for k, v in state.model.state_dict().items()}
        for key, value in base.items():
            assert torch.equal(after[key], value), (device, key)
        results[device] = ([(float(m['loss']), float(m['grad_norm']))
                            for m in metrics], after)
    (cpu_metrics, cpu_state), (gpu_metrics, gpu_state) = (results['cpu'],
                                                          results['cuda'])
    for (l_c, n_c), (l_g, n_g) in zip(cpu_metrics, gpu_metrics):
        assert n_c > tc.grad_clip_norm
        assert abs(l_c - l_g) <= 1e-4 * abs(l_c)
        assert abs(n_c - n_g) <= 1e-4 * abs(n_c)
    for key in lora.adapter_keys(cfg):
        torch.testing.assert_close(gpu_state[key], cpu_state[key],
                                   atol=5e-5, rtol=0)
    assert max(float(cpu_state[k].abs().max()) for k in
               lora.adapter_keys(cfg) if k.endswith('_lora_b')) > 0


@pytest.mark.cuda
def test_moe_block_bf16_on_the_card_matches_fp32_under_its_routing():
    """A mixtral-width MoE block (one layer's experts, 8 top 2) on a
    256-token chunk: bf16 output within 3e-2 of max |out| of the fp32
    block given the bf16 run's routing (chip_smoke's MOE_BLOCK_TOL: the
    bf16 buffers and products round to 2^-8 before the down product's
    sum); the dispatch also equal to dense where nothing drops."""
    _need_gpu()
    import dataclasses

    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.models.configs import get_config
    cfg = dataclasses.replace(get_config('mixtral-8x7b'), d_mlp=2048,
                              dtype='bfloat16')
    block = moe.MoEBlock(cfg, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, p.shape[-2] ** -0.5, generator=gen)
        x = torch.randn(1, 256, cfg.d_model, device='cuda',
                        generator=gen).to(torch.bfloat16)
        out = block(x).float()
        idx, probs = moe.route(x, block.router, cfg.experts_per_token)
        w = [t.float() for t in (block.w_gate, block.w_up, block.w_down)]
        want = moe.dispatch(x.float(), idx, probs, *w,
                            cfg.moe_capacity_factor, torch.float32)
        rel = float((out - want).abs().max() / want.abs().max())
        assert rel <= 3e-2, rel
        full = moe.dispatch(x.float(), idx, probs, *w, 8.0, torch.float32)
        dense = moe.dense(x.float(), idx, probs, *w, torch.float32)
        torch.testing.assert_close(full, dense, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_moe_engine_tokens_on_the_card_equal_the_cpu_tokens():
    """test-tiny-moe (head_dim 64) fp32 through the paged engine, 4 slots
    and 6 requests queued before each engine starts: the card's greedy
    tokens (kernel 1, CUDA graphs) equal the CPU's."""
    _need_gpu()
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    from skypilot_tpu_torch.models.transformer import Transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config('test-tiny-moe', head_dim_override=64, dtype='float32',
                     param_dtype='float32', max_seq_len=256)
    state = Transformer(cfg, device='cpu').init_random_(4).state_dict()
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 37, 100, 17, 64, 23)]
    outs = []
    for device in ('cpu', 'cuda'):
        engine = ContinuousBatchingEngine(
            cfg, params={k: v.to(device) for k, v in state.items()},
            num_slots=4, paged_block_size=16, prefill_chunk=32,
            device=device)
        engine._ensure_thread = lambda: None  # pylint: disable=protected-access
        futures = [engine.submit(p, max_new_tokens=12) for p in prompts]
        del engine._ensure_thread  # pylint: disable=protected-access
        engine._ensure_thread()  # pylint: disable=protected-access
        outs.append([f.result(timeout=300)[0] for f in futures])
        assert engine.drain(timeout=60)
    assert outs[0] == outs[1]


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', [None, 'int8'], ids=['bf16', 'int8'])
def test_handoff_import_keeps_the_captured_decode_graph(kv_quant):
    """KV handoff on the card: a decode-tier engine captures its step
    graphs first, then ingests a prefill-tier engine's chunk stream. The
    ingest writes the pool tensors in place (their addresses, which the
    graphs hold, are unchanged); a decode graph replay over the ingested
    blocks equals the eager step bit for bit, and the handed-off prompt's
    greedy tokens equal the prefill engine's cold ones."""
    _need_gpu()
    import dataclasses

    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    cfg = dataclasses.replace(
        get_config('llama3-8b'), name='handoff-small', vocab_size=1024,
        d_model=512, num_layers=2, num_heads=4, num_kv_heads=2, d_mlp=1024,
        max_seq_len=512, dtype='bfloat16')
    kw = dict(num_slots=4, paged_block_size=16, prefill_chunk=64,
              kv_quant=kv_quant, async_depth=1, prefix_cache=4, rng_seed=3,
              device='cuda')
    pre = ContinuousBatchingEngine(cfg, tier='prefill', **kw)
    dec = ContinuousBatchingEngine(cfg, tier='decode', **kw)
    prompt = [(7 * i + 3) % 1024 for i in range(150)]
    try:
        cold, _ = pre.generate(prompt, max_new_tokens=12)
        chunks = pre.export_prefix_chunks(prompt, 'card-1', chunk_blocks=3)
        dec.capture_graphs()
        addresses = [t.data_ptr() for t in _pools(dec)]
        for chunk in chunks:
            result = dec.ingest_chunk(chunk)
        assert result['final'] and result['imported_blocks'] == 10
        assert [t.data_ptr() for t in _pools(dec)] == addresses
        blocks = dec._prefix_entries.get(prompt)  # pylint: disable=protected-access
        for ours, theirs in zip(_pools(dec), _pools(pre)):
            want = theirs[:, pre._prefix_entries.get(prompt)]  # pylint: disable=protected-access
            assert torch.equal(ours[:, blocks], want)

        def step():
            """One decode row at the prompt's end over the ingested
            blocks, in the engine thread: (graph tokens, eager tokens)."""
            saved = [t.clone() for t in _pools(dec)]
            width = dec._blocks_per_seq + 1  # pylint: disable=protected-access
            tables = np.zeros((4, width), np.int32)
            tables[0, :len(blocks)] = blocks
            tokens = np.zeros((4, 1), np.int32)
            tokens[0, 0] = prompt[-1]
            pos = np.zeros((4, 1), np.int32)
            pos[0, 0] = len(prompt) - 1
            d = dec._dec  # pylint: disable=protected-access
            dec._forget_inputs()  # pylint: disable=protected-access
            d.feed.put([tokens[:, 0], pos[:, 0]])
            d.tables.put(tables)
            d.temps.put(np.zeros(4, np.float32))
            graph = dec._run_decode(1, False).result()  # pylint: disable=protected-access
            for t, s in zip(_pools(dec), saved):
                t.copy_(s)
            eager = dec._decode_impl(  # pylint: disable=protected-access
                torch.from_numpy(tokens).cuda(),
                torch.from_numpy(pos).cuda(), torch.zeros(4, device='cuda'),
                torch.from_numpy(tables).cuda(), False, None)
            for t, s in zip(_pools(dec), saved):
                t.copy_(s)
            dec._forget_inputs()  # pylint: disable=protected-access
            return graph[:, 0], eager.cpu().numpy()

        graph, eager = dec._run_in_tick(step)  # pylint: disable=protected-access
        assert np.array_equal(graph, eager)
        assert ('decode', 1, False) in dec._steps.keys  # pylint: disable=protected-access
        hot, _ = dec.generate(prompt, max_new_tokens=12)
        assert hot == cold
        assert dec.prewarm_stats['hits'] == 1
        assert dec.prefix_stats['tokens_reused'] == len(prompt) - 1
        dec._pool.check()  # pylint: disable=protected-access
    finally:
        pre.stop()
        dec.stop()


@pytest.mark.cuda
@pytest.mark.parametrize('where', ['point', 'dispatch'])
@pytest.mark.parametrize('kv_quant', [None, 'int8'], ids=['bf16', 'int8'])
def test_wedge_released_after_a_recovery_leaves_the_successor_alone(
        kv_quant, where):
    """A watchdog recovery on the card keeps the step graphs captured at
    async depth 1 (no recapture) and the pool tensors. The abandoned
    thread, released while its successor serves, changes nothing: the
    successor's tokens equal an untouched run's, the prompt blocks it
    holds keep their bits, and its pass replays what the untouched pass
    replays. `where` the thread wedged: 'point', at the `engine.decode`
    fault point (released mid-pass, it exits at its generation check,
    replaying nothing); 'dispatch', inside a decode dispatch after its
    generation check, holding the device lock (the successor's first
    write waits for it; released, its one replay lands on the stream
    ahead of the successor's and is never read)."""
    _need_gpu()
    import dataclasses
    import threading
    import time

    from skypilot_tpu_torch import exceptions
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    from skypilot_tpu_torch.utils import fault_injection
    cfg = dataclasses.replace(
        get_config('llama3-8b'), name='wedge-small', vocab_size=1024,
        d_model=512, num_layers=2, num_heads=4, num_kv_heads=2, d_mlp=1024,
        max_seq_len=512, dtype='bfloat16')
    engine = ContinuousBatchingEngine(
        cfg, num_slots=4, paged_block_size=16, prefill_chunk=64,
        kv_quant=kv_quant, async_depth=1, rng_seed=3, watchdog_timeout=1.0,
        device='cuda')
    prompts = [[(7 * i + 3 * r) % 1024 for i in range(40 + 30 * r)]
               for r in range(4)]
    released = threading.Event()

    def serve(during=None):
        """The prompts as one batch, queued while the engine thread is
        held (both passes admit them in one tick and schedule them
        alike); `during(reqs)` runs once every request decodes, or at
        once with None when the engine cannot move. Returns (tokens,
        replays of the pass)."""
        replays = engine._steps.replays  # pylint: disable=protected-access
        seen = threading.Event()
        held_now, go = threading.Event(), threading.Event()
        holder = threading.Thread(target=lambda: engine._run_in_tick(  # pylint: disable=protected-access
            lambda: (held_now.set(), go.wait(60)), timeout=120))
        holder.start()
        assert held_now.wait(60)
        futures = [engine.submit(p, max_new_tokens=120,
                                 on_token=lambda _t: seen.set())
                   for p in prompts]
        go.set()
        if during is not None and where == 'dispatch':
            during(None)
        elif during is not None:
            assert seen.wait(60)
            deadline = time.monotonic() + 60
            while any(r is None or r.prefilling for r in engine._slots):  # pylint: disable=protected-access
                assert time.monotonic() < deadline
                time.sleep(0.001)
            during(list(engine._slots))  # pylint: disable=protected-access
        holder.join(120)
        tokens = [f.result(timeout=300)[0] for f in futures]
        return tokens, engine._steps.replays - replays  # pylint: disable=protected-access

    def prompt_blocks(ids):
        return [t[:, full].clone() for full in ids for t in _pools(engine)]

    stale_spec = None
    real_run = engine._steps.run  # pylint: disable=protected-access
    try:
        engine.capture_graphs()
        want, want_replays = serve()
        captures = engine._steps.captures  # pylint: disable=protected-access
        addresses = [t.data_ptr() for t in _pools(engine)]
        if where == 'point':
            fault_injection.arm('engine.decode', 'wedge')
        else:
            stale = engine._thread  # pylint: disable=protected-access

            def gated(key, body, **kw):
                if threading.current_thread() is stale and \
                        key[0] == 'decode':
                    assert released.wait(60)
                real_run(key, body, **kw)

            engine._steps.run = gated  # pylint: disable=protected-access
        wedged = engine.submit(prompts[0], max_new_tokens=8)
        with pytest.raises(exceptions.EngineWedgedError):
            wedged.result(timeout=30)
        assert engine._generation == 1  # pylint: disable=protected-access
        if where == 'point':
            # The abandoned thread waits on this wedge; the successor's
            # firings pass through.
            stale_spec = fault_injection._specs['engine.decode']  # pylint: disable=protected-access
            fault_injection.arm('engine.decode', 'delay:0')
        held = {}

        def release(reqs):
            if reqs is not None:
                # The successor's full prompt blocks, which no later
                # write touches while it holds them.
                held['ids'] = [req.blocks[:len(req.ids) // 16]
                               for req in reqs]
                held['before'] = prompt_blocks(held['ids'])
            else:
                time.sleep(0.2)   # the successor waits on the lock
            released.set()
            if stale_spec is not None:
                stale_spec.release.set()
            deadline = time.monotonic() + 30
            while engine.watchdog_stats['stale_exits'] < 1:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            if reqs is not None:
                held['after'] = prompt_blocks(held['ids'])

        got, replays = serve(during=release)
        assert got == want
        # The abandoned thread's one dispatch, if it had one in hand.
        assert replays == want_replays + (where == 'dispatch')
        if where == 'point':
            assert all(held['ids'])
            assert all(torch.equal(a, b)
                       for a, b in zip(held['before'], held['after']))
            # Released at the finish and taken by nothing since.
            assert all(torch.equal(a, b) for a, b in zip(
                held['before'], prompt_blocks(held['ids'])))
        assert engine._steps.captures == captures  # pylint: disable=protected-access
        assert [t.data_ptr() for t in _pools(engine)] == addresses
        engine._pool.check()  # pylint: disable=protected-access
    finally:
        released.set()
        if stale_spec is not None:
            stale_spec.release.set()
        fault_injection.disarm_all()
        engine.stop()


def _contiguous_cfg(dtype='float32', max_seq_len=512):
    """The graph tests' small model (head_dim 128) without pool
    geometry."""
    import dataclasses

    from skypilot_tpu_torch.models.configs import get_config
    return dataclasses.replace(
        get_config('llama3-8b'), name='contiguous-small', vocab_size=1024,
        d_model=512, num_layers=2, num_heads=4, num_kv_heads=2, d_mlp=1024,
        max_seq_len=max_seq_len, dtype=dtype, decode=True)


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', ['', 'int8'], ids=['float', 'int8'])
def test_contiguous_write_at_the_window_end_matches_the_cpu(kv_quant):
    """A 4-token chunk starting at S - 2 and an inert decode row at S + 5
    are clamped into their rows as dynamic_update_slice clamps them: no
    device-side assert, and the cache and logits equal the CPU's: float
    within 1e-4; int8 payloads within one step, the logits within 1e-2
    (a K/V element the two devices round to neighbouring int8 steps on a
    rounding boundary moves later logits by ~3e-3)."""
    _need_gpu()
    import dataclasses

    from skypilot_tpu_torch.models.transformer import Transformer
    cfg = dataclasses.replace(_contiguous_cfg(max_seq_len=64),
                              kv_cache_quant=kv_quant)
    cpu = Transformer(cfg, device='cpu').init_random_(0)
    card = Transformer(cfg, device='cuda')
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    seq = cfg.max_seq_len
    steps = [(np.tile(np.arange(16), (2, 1)), 16),
             (np.stack([np.arange(seq - 2, seq + 2), np.arange(20, 24)]), 4),
             (np.array([[seq + 5], [24]]), 1)]
    rng = np.random.RandomState(0)
    caches = {'cpu': cpu.new_kv_cache(2), 'cuda': card.new_kv_cache(2)}
    with torch.inference_mode():
        for positions, width in steps:
            tokens = torch.from_numpy(rng.randint(1, 1024, (2, width)))
            out = {}
            for dev, model in (('cpu', cpu), ('cuda', card)):
                c = caches[dev]
                scales = c[2:] or (None, None)
                out[dev] = model(tokens.to(dev),
                                 torch.from_numpy(positions).int().to(dev),
                                 None, c[0], c[1], k_scale=scales[0],
                                 v_scale=scales[1]).cpu()
            torch.cuda.synchronize()
            tol = 1e-2 if kv_quant else 1e-4
            torch.testing.assert_close(out['cuda'], out['cpu'], atol=tol,
                                       rtol=tol)
    for a, b in zip(caches['cuda'], caches['cpu']):
        if a.dtype == torch.int8:
            assert (a.cpu().int() - b.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('k', [1, 4])
def test_contiguous_decode_graph_equals_eager_step(k):
    """A replay of the contiguous engine's k-step decode graph over the
    slot cache gives the eager `_decode_impl` steps' tokens bit for bit
    (one row inert, one near its window) and leaves the cache equal."""
    _need_gpu()
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(
        _contiguous_cfg(), num_slots=4, decode_chunk=k, rng_seed=3,
        device='cuda')
    try:
        assert engine.paged_block_size == 0 and engine._dec.tables is None  # pylint: disable=protected-access
        gen = torch.Generator(device='cuda').manual_seed(5)
        for cache in _pools(engine):
            cache.normal_(generator=gen)
        with torch.inference_mode():
            saved = [t.clone() for t in _pools(engine)]
            tokens = torch.tensor([[3], [10], [0], [24]], dtype=torch.int32,
                                  device='cuda')
            positions = torch.tensor([[5], [40], [0], [509]],
                                     dtype=torch.int32, device='cuda')
            temps = torch.zeros(4, device='cuda')
            eager = []
            tok, pos = tokens, positions.clone()
            for _ in range(k):
                nxt = engine._decode_impl(tok, pos, temps, None, False)  # pylint: disable=protected-access
                eager.append(nxt)
                tok, pos = nxt[:, None], pos + 1
            eager = torch.stack(eager, dim=1).cpu()
            after = [t.clone() for t in _pools(engine)]
            dec = engine._dec  # pylint: disable=protected-access
            for _ in range(2):   # the capture, then a replay
                for t, s in zip(_pools(engine), saved):
                    t.copy_(s)
                dec.feed.put([tokens[:, 0].cpu().numpy(),
                              positions[:, 0].cpu().numpy()])
                dec.temps.put(np.zeros(4, np.float32))
                got = engine._run_decode(k, False).result()  # pylint: disable=protected-access
            assert torch.equal(torch.from_numpy(got), eager)
            for t, s in zip(_pools(engine), after):
                assert torch.equal(t, s)
            assert engine._steps.replays >= 2  # pylint: disable=protected-access
    finally:
        engine.stop()


@pytest.mark.cuda
@pytest.mark.parametrize('kv_quant', [None, 'int8'], ids=['float', 'int8'])
def test_contiguous_equals_paged_xla_on_the_card(kv_quant):
    """fp32 with TF32 off: the contiguous engine's greedy tokens equal
    the paged engine's on the 'xla' route bit for bit, and the paged
    kernel route's."""
    _need_gpu()
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    cfg = _contiguous_cfg()
    prompts = [list(range(2, 9)), list(range(2, 26)),
               list(range(40, 140)), [7] * 17]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    params, outs = None, {}
    try:
        for name, kw in (('contiguous', {}),
                         ('paged-xla', dict(paged_block_size=16,
                                            decode_kernel='xla')),
                         ('paged-kernel', dict(paged_block_size=16))):
            engine = ContinuousBatchingEngine(
                cfg, params=params and dict(params), num_slots=3,
                kv_quant=kv_quant, rng_seed=3, device='cuda', **kw)
            if params is None:
                params = dict(engine.model.state_dict())
            try:
                futures = [engine.submit(p, max_new_tokens=12)
                           for p in prompts]
                outs[name] = [f.result(timeout=300)[0] for f in futures]
            finally:
                engine.stop()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert outs['contiguous'] == outs['paged-xla'] == outs['paged-kernel']


# ------------------------------------------------------- tensor parallel

# A tp=2 rank's shard of llama3-8b's attention: KV 8 / 2 heads, n_rep 4,
# D 128, over an 8192-key window (blocks of 16) at the serve path's
# decode and prefill calls.
_TP_SHARD_CASES = [(8, 1), (1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize('int8', [False, True], ids=['float', 'int8'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('batch,cur_len', _TP_SHARD_CASES,
                         ids=['decode', 'prefill'])
def test_kernels_at_the_tp2_shard_shape(batch, cur_len, dtype, int8):
    _need_gpu()
    kw = dict(batch=batch, cur_len=cur_len, kv_heads=4, n_rep=4,
              head_dim=128, block_size=16, blocks_per_seq=512,
              seed=cur_len + 7)
    if int8:
        q, k_pool, v_pool, tables, pos, scales = _int8_case(dtype, **kw)
    else:
        (q, k_pool, v_pool, tables, pos), scales = _case(dtype=dtype,
                                                         **kw), {}
    counter = 'int8_launches' if int8 else 'launches'
    before = getattr(pa.paged_decode_attention, counter)
    out = pa.paged_decode_attention(q, k_pool, v_pool, tables, pos,
                                    **scales)
    assert getattr(pa.paged_decode_attention, counter) == before + 1
    ref = pa.paged_decode_attention_plain(q, k_pool, v_pool, tables, pos,
                                          **scales)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    tol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_tp2_engine_on_one_card_equals_tp1():
    """Two ranks on cuda:0 over gloo (NCCL takes one card a rank): fp32
    greedy tokens equal tp=1's on the same seeded weights, and every
    rank launches kernel 1 layers x (chunks + decode steps) times."""
    _need_gpu()
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    from skypilot_tpu_torch.parallel.mesh import decode_group
    cfg = _contiguous_cfg()
    prompts = [list(range(2, 40)), [7] * 17]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    group = decode_group(2, devices=['cuda:0', 'cuda:0'], backend='gloo',
                         device='cuda')
    outs = {}
    try:
        for tp in (1, 2):
            engine = ContinuousBatchingEngine(
                cfg, num_slots=2, paged_block_size=16, rng_seed=3,
                mesh=group if tp == 2 else None, device='cuda:0')
            # A capture's warm-up call launches for real: capture first.
            engine.capture_graphs()
            before = engine.tp_counts()
            outs[tp] = [engine.generate(p, max_new_tokens=12)[0]
                        for p in prompts]
            after = engine.tp_counts()
            steps = engine.tick_stats['decode_steps']
            chunks = engine.paged_stats['prefill_chunks']
            launches = [a['paged_decode_attention'] -
                        b['paged_decode_attention']
                        for a, b in zip(after, before)]
            assert launches == [cfg.num_layers * (chunks + steps)] * tp, (
                tp, launches, chunks, steps)
            engine.stop()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        group.close()
    assert outs[1] == outs[2], outs
    assert [p.returncode for p in group.processes] == [0]
