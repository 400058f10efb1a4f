"""The CUDA paged-attention kernel against its plain PyTorch version on
the card. Needs an NVIDIA GPU and nvcc: every test is marked `cuda` and
skips inside the test when torch.cuda is unavailable. The file imports
no JAX, so on a GPU machine without JAX it runs as

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
