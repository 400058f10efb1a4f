"""The port's CUDA kernels against their plain PyTorch versions on the
card: paged attention over float and int8 pools, the flash-attention
forward and backward, and the fused multi-LoRA delta. Needs an NVIDIA
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
