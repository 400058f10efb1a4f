"""The port's CUDA kernels against their plain PyTorch versions on the
card: paged attention over float and int8 pools, the flash-attention
forward and backward, the fused multi-LoRA delta and the ring-attention
chunk update. Needs an NVIDIA
GPU and nvcc: every test is marked `cuda` and skips inside the test when
torch.cuda is unavailable. The file imports no JAX, so on a GPU machine
without JAX it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py imports JAX; --noconftest leaves it out).

Tolerances: fp32 1e-5 (the kernel and the plain version sum in other
orders); bf16 2e-2 absolute and relative (both round p to bf16, at
different points of the softmax, and round the output to bf16).
"""
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
