"""The port's ring attention (ops/ring_attention.py) against the JAX
package's (skypilot_tpu/ops/ring_attention.py).

- `chunk_update_plain` (the CUDA kernel's plain twin) against the
  reference's `_chunk_update` and its Pallas kernel in interpret mode
  (`_chunk_update_pallas(interpret=True)`), fp32 and bf16, over both mask
  modes, equal and unequal offsets, fresh and carried state and the fully
  masked row (p = 1 for every key at m = -1e30, the reference's answer).
- `ring_attention_sharded` for sp in {1, 2, 4}, causal and not, against
  the reference's `ring_attention_sharded` on an sp mesh of the conftest's
  fake CPU devices (impl='pallas_interpret') and against dense attention;
  its gradients against jax.grad of the reference ring (impl='xla', as
  tests/test_ring_attention.py pins it), GQA included.
- The per-rank form on the ring of 2- and 4-process gloo training groups
  (parallel/mesh.TrainGroup with sp = the world; its hops counted as
  `collective_permute`) equal bit for bit to the one-process form,
  forward and gradients: both make the same chunk updates and the same
  flash dQ/dK/dV calls in the same order.
- The refusals.

The reference ring takes K/V repeated to H heads; the port's takes them
at KV heads, so the tests repeat them for the reference only.

Tolerances (fp32 unless named): 1e-5 absolute and relative between the
port and the reference (fp32 sums in other orders; measured <= 3e-6).
bf16 chunk update: 1e-5 against `_chunk_update` (both round P·V to bf16;
measured 2.4e-7) and 4e-2 absolute against the Pallas kernel in interpret
mode, which keeps P·V in fp32 where the reference's own XLA twin rounds
it to bf16: they differ by up to half a bf16 step of |P·V|, 3.1e-2 below
|P·V| = 16 (these inputs; measured 2.1e-2). Gradients 5e-5, the
reference's own bound for its ring against dense attention.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.flash_attention import _reference_attention
from skypilot_tpu.ops.ring_attention import _chunk_update
from skypilot_tpu.ops.ring_attention import _chunk_update_pallas
from skypilot_tpu.ops.ring_attention import \
    ring_attention_sharded as jax_ring_sharded
from skypilot_tpu.parallel.mesh import MeshConfig, build_mesh
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops import ring_attention as ra
from skypilot_tpu_torch.parallel import sharding

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(batch=2, seq=32, heads=4, kv_heads=2, dim=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, seq, heads, dim).astype(np.float32),
            rng.randn(batch, seq, kv_heads, dim).astype(np.float32),
            rng.randn(batch, seq, kv_heads, dim).astype(np.float32))


def _rep(x, n_rep):
    return np.repeat(x, n_rep, axis=2)


# ---------------------------------------------------------- chunk update

_CHUNK = 16
# (mask_mode, q_offset, k_offset, carried state): full and causal hops of
# the ring, a q chunk after and before the k chunk, and rows that see no
# key of the chunk (q_offset < k_offset) with fresh and carried state.
_CASES = {
    'full_fresh': (0, 16, 0, False),
    'full_carried': (0, 32, 0, True),
    'causal_equal_fresh': (1, 16, 16, False),
    'causal_later_q_carried': (1, 24, 16, True),
    'fully_masked_rows_fresh': (1, 0, 16, False),
    'partly_masked_rows_carried': (1, 8, 16, True),
}


def _state(rng, batch, heads, carried):
    shape_o, shape_ml = (batch, _CHUNK, heads, 16), (batch, heads, _CHUNK)
    if not carried:
        return (np.zeros(shape_o, np.float32),
                np.full(shape_ml, -1e30, np.float32),
                np.zeros(shape_ml, np.float32))
    return (rng.randn(*shape_o).astype(np.float32),
            rng.randn(*shape_ml).astype(np.float32),
            (rng.rand(*shape_ml) + 0.5).astype(np.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', list(_CASES))
def test_chunk_update_plain_matches_reference_and_pallas(case, dtype):
    mode, q_off, k_off, carried = _CASES[case]
    rng = np.random.RandomState(len(case))
    q, k, v = _qkv(seq=_CHUNK, seed=len(case))
    o, m, l = _state(rng, 2, 4, carried)
    opts = dict(sm_scale=16 ** -0.5, mask_mode=mode, q_offset=q_off,
                k_offset=k_off)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ra.chunk_update_plain(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        *(torch.from_numpy(x) for x in (o, m, l)), **opts)
    jargs = ([jnp.asarray(x, jdt) for x in (q, _rep(k, 2), _rep(v, 2))] +
             [jnp.asarray(x) for x in (o, m, l)])
    ref = _chunk_update(*jargs, **opts)
    pallas = _chunk_update_pallas(*jargs, interpret=True, **opts)
    for name, x, r, p in zip('oml', got, ref, pallas):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(r), **_TOL,
                                   err_msg=f'{name} vs _chunk_update')
        atol = 4e-2 if dtype == 'bfloat16' else 1e-5
        np.testing.assert_allclose(x.numpy(), np.asarray(p), atol=atol,
                                   rtol=1e-5, err_msg=f'{name} vs Pallas')
    if case == 'fully_masked_rows_fresh':
        # Every key masked at m = -1e30: p = exp(0) = 1 for each, so l is
        # the chunk length and o the sum of the (rounded) V rows.
        np.testing.assert_array_equal(got[2].numpy(), np.float32(_CHUNK))
        np.testing.assert_array_equal(got[1].numpy(), np.float32(-1e30))
        v_sum = torch.from_numpy(v).to(tdt).float().sum(dim=1)  # (B, KV, D)
        np.testing.assert_allclose(
            got[0].numpy(), _rep(v_sum.to(tdt).float().numpy()[:, None], 2)
            .repeat(_CHUNK, axis=1), atol=1e-5)


@pytest.mark.parametrize('case', ['masked_first_tiles', 'all_tiles_masked'])
def test_tiled_walk_gives_the_whole_chunk_answer(case):
    """The kernel walks a chunk's keys tile by tile with a running max
    that starts at the incoming m. That is the whole-chunk update when the
    first tiles are fully masked and a later one is not (their p = 1 are
    multiplied by exp(-1e30 - m) = 0) and when every tile is masked (alpha
    stays 1): checked by applying the plain update to 4-key tiles in turn
    (fp32: rounding only, 1e-5)."""
    q_off = 12 if case == 'masked_first_tiles' else 0
    q, k, v = (torch.from_numpy(x) for x in _qkv(seq=_CHUNK, seed=3))
    o, m, l = (torch.from_numpy(x) for x in _state(
        np.random.RandomState(3), 2, 4, carried=False))
    opts = dict(sm_scale=0.25, mask_mode=1, q_offset=q_off, k_offset=16)
    whole = ra.chunk_update_plain(q, k, v, o, m, l, **opts)
    tiled = (o, m, l)
    for t in range(0, _CHUNK, 4):
        tiled = ra.chunk_update_plain(
            q, k[:, t:t + 4], v[:, t:t + 4], *tiled,
            **{**opts, 'k_offset': 16 + t})
    for a, b in zip(tiled, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **_TOL)


def _grouped_ring_walk(q, k, v, o, m, l, *, sm_scale, mask_mode, q_offset,
                       k_offset):
    """The bf16 ring kernel's walk in plain fp32 torch: work tiles of 128
    grouped rows (128 / n_rep positions x the n_rep heads of one KV head,
    row = position * n_rep + head), 64-key tiles from key tile 0, the
    running max starting at the incoming m, key tiles wholly past the
    tile's last visible key skipped only in mode 1 with q_offset >=
    k_offset, keys past Sk at -inf and masked keys at -1e30 (never a
    select to 0); P.V summed apart from o and added once at the end."""
    batch, s_q, heads, dim = q.shape
    s_k, kv_heads = k.shape[1], k.shape[2]
    n_rep = heads // kv_heads
    positions = 128 // n_rep
    skips = mask_mode == 1 and q_offset >= k_offset
    o_out, m_out, l_out = o.clone(), m.clone(), l.clone()
    for b in range(batch):
        for kvh in range(kv_heads):
            for q0 in range(0, s_q, positions):
                pos = torch.arange(q0, min(s_q, q0 + positions))
                hs = kvh * n_rep + torch.arange(n_rep)
                qg = q[b, pos][:, hs].reshape(-1, dim)       # (rows, D)
                rpos = pos.repeat_interleave(n_rep)
                rhead = hs.repeat(len(pos))
                m_in = m[b, rhead, rpos]
                k_hi = (min(s_k, q_offset - k_offset + int(pos[-1]) + 1)
                        if skips else s_k)
                run_m, run_l = m_in.clone(), torch.zeros_like(m_in)
                acc = torch.zeros(len(rpos), dim)
                for k0 in range(0, k_hi, 64):
                    keys = torch.arange(k0, k0 + 64)
                    kt = torch.zeros(64, dim)
                    vt = torch.zeros(64, dim)
                    present = keys < s_k
                    kt[present] = k[b, keys[present], kvh]
                    vt[present] = v[b, keys[present], kvh]
                    s = (qg @ kt.T) * sm_scale
                    if mask_mode == 1:
                        s = torch.where(k_offset + keys[None, :] >
                                        q_offset + rpos[:, None],
                                        torch.tensor(-1e30), s)
                    s = torch.where(present[None, :], s,
                                    torch.tensor(float('-inf')))
                    new_m = torch.maximum(run_m, s.max(dim=1).values)
                    alpha = torch.exp(run_m - new_m)
                    p = torch.exp(s - new_m[:, None])
                    run_l = run_l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vt
                    run_m = new_m
                alpha = torch.exp(m_in - run_m)
                o_out[b, rpos, rhead] = o[b, rpos, rhead] * alpha[:, None] + acc
                l_out[b, rhead, rpos] = l[b, rhead, rpos] * alpha + run_l
                m_out[b, rhead, rpos] = run_m
    return o_out, m_out, l_out


# The ring kernel's offset patterns (chip_smoke.py RING_CASES) at a chunk
# of 160: three key tiles, the last ragged. (mask_mode, q_offset, k_offset,
# carried state).
_WALK_CASES = {
    'full_hop': (0, 160, 0, False),
    'diagonal_hop': (1, 160, 160, False),
    'diagonal_hop_carried': (1, 480, 480, True),
    'past_hop_carried': (0, 480, 160, True),
    'q_after_k_causal': (1, 240, 160, True),
    'fully_masked_rows': (1, 0, 160, False),
    'masked_then_seen': (1, 80, 160, False),
}


@pytest.mark.parametrize('n_rep', [1, 4])
@pytest.mark.parametrize('case', list(_WALK_CASES))
def test_grouped_ring_walk_matches_plain_and_pallas(case, n_rep):
    """The wgmma ring kernel's grouped-head walk against chunk_update_plain
    and the reference's Pallas kernel in interpret mode (fp32: sums in
    other orders only, 1e-5), over every offset pattern of the card's
    checks, fully masked rows (l = Sk) and carried state included."""
    mode, q_off, k_off, carried = _WALK_CASES[case]
    chunk, heads = 160, 4
    rng = np.random.RandomState(n_rep + len(case))
    q, k, v = _qkv(batch=1, seq=chunk, heads=heads, kv_heads=heads // n_rep,
                   seed=len(case))
    if carried:
        o = rng.randn(1, chunk, heads, 16).astype(np.float32)
        m = rng.randn(1, heads, chunk).astype(np.float32)
        l = (rng.rand(1, heads, chunk) + 0.5).astype(np.float32)
    else:
        o = np.zeros((1, chunk, heads, 16), np.float32)
        m = np.full((1, heads, chunk), -1e30, np.float32)
        l = np.zeros((1, heads, chunk), np.float32)
    opts = dict(sm_scale=16 ** -0.5, mask_mode=mode, q_offset=q_off,
                k_offset=k_off)
    args = [torch.from_numpy(x) for x in (q, k, v, o, m, l)]
    walked = _grouped_ring_walk(*args, **opts)
    plain = ra.chunk_update_plain(*args, **opts)
    pallas = _chunk_update_pallas(
        *[jnp.asarray(x) for x in (q, _rep(k, n_rep), _rep(v, n_rep), o, m,
                                   l)], interpret=True, **opts)
    for name, w, p, r in zip('oml', walked, plain, pallas):
        np.testing.assert_allclose(w.numpy(), p.numpy(), **_TOL,
                                   err_msg=f'{name} vs plain')
        np.testing.assert_allclose(w.numpy(), np.asarray(r), **_TOL,
                                   err_msg=f'{name} vs Pallas')
    if case == 'fully_masked_rows':
        np.testing.assert_array_equal(walked[2].numpy(), np.float32(chunk))


def test_chunk_update_on_cpu_launches_nothing_and_refuses_other_devices():
    q, k, v = (torch.from_numpy(x) for x in _qkv(seq=_CHUNK))
    o, m, l = (torch.from_numpy(x) for x in _state(
        np.random.RandomState(0), 2, 4, carried=False))
    before = ra.chunk_update.launches
    opts = dict(sm_scale=0.25, mask_mode=1, q_offset=0, k_offset=0)
    got = ra.chunk_update(q, k, v, o, m, l, **opts)
    ref = ra.chunk_update_plain(q, k, v, o, m, l, **opts)
    assert ra.chunk_update.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match='not meta'):
        ra.chunk_update(*(t.to('meta') for t in (q, k, v, o, m, l)),
                        **opts)
    with pytest.raises(ValueError, match='mask_mode'):
        ra.chunk_update(q, k, v, o, m, l, **{**opts, 'mask_mode': 2})


# ------------------------------------------------------------------ ring

@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
@pytest.mark.parametrize('sp', [1, 2, 4])
def test_sharded_ring_matches_reference_ring_and_dense(sp, causal):
    q, k, v = _qkv()
    got = ra.ring_attention_sharded(
        *(torch.from_numpy(x) for x in (q, k, v)), sp=sp, causal=causal)
    mesh = build_mesh(MeshConfig(sp=sp), jax.devices()[:sp])
    with mesh:
        ref = jax_ring_sharded(mesh, jnp.asarray(q), jnp.asarray(_rep(k, 2)),
                               jnp.asarray(_rep(v, 2)), causal=causal,
                               impl='pallas_interpret')
    dense = _reference_attention(jnp.asarray(q), jnp.asarray(_rep(k, 2)),
                                 jnp.asarray(_rep(v, 2)), causal=causal,
                                 sm_scale=16 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), **_TOL)


def _jax_ring_grads(q, k, v, g, sp, causal):
    mesh = build_mesh(MeshConfig(sp=sp), jax.devices()[:sp])

    def loss(q, k, v):
        out = jax_ring_sharded(mesh, q, jnp.repeat(k, 2, axis=2),
                               jnp.repeat(v, 2, axis=2), causal=causal,
                               impl='xla')
        return jnp.sum(out * g)

    with mesh:
        return jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))


def _ring_grads(q, k, v, g, causal):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ra.ring_attention_sharded(*leaves, sp=4, causal=causal).backward(
        torch.from_numpy(g))
    return [leaf.grad.numpy() for leaf in leaves]


def test_sharded_ring_gradients_match_jax_grad():
    q, k, v = _qkv(seed=1)
    g = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    ref = _jax_ring_grads(q, k, v, jnp.asarray(g), 4, causal=True)
    for name, got, r in zip(('dq', 'dk', 'dv'), _ring_grads(q, k, v, g, True),
                            ref):
        np.testing.assert_allclose(got, np.asarray(r), atol=5e-5, rtol=5e-5,
                                   err_msg=name)


def test_non_causal_ring_gradients_match_the_flash_path():
    """Non-causal, every hop of every rank is a full (mask 0) hop; the
    gradients equal the port's flash path's (itself pinned to the
    reference's Pallas kernels in test_torch_flash_attention.py)."""
    q, k, v = _qkv(seed=4)
    g = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    flash = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*flash, causal=False, impl='pallas').backward(
        torch.from_numpy(g))
    for name, got, r in zip(('dq', 'dk', 'dv'),
                            _ring_grads(q, k, v, g, False), flash):
        np.testing.assert_allclose(got, r.grad.numpy(), atol=5e-5,
                                   rtol=5e-5, err_msg=name)


def test_flash_entry_routes_ring_through_the_ambient_context():
    """flash_attention(impl='ring') is the ring of the ambient context, and
    the other impls never take the ring under it."""
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    flash = fa.flash_attention(q, k, v, impl='auto')
    with sharding.use_sequence_parallel(sp=2):
        ring = fa.flash_attention(q, k, v, impl='ring')
        assert torch.equal(fa.flash_attention(q, k, v, impl='auto'), flash)
    assert torch.equal(ring, ra.ring_attention_sharded(q, k, v, sp=2))
    assert sharding.current_sequence_parallel() is None


def test_refusals():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    with pytest.raises(ValueError, match='sequence-parallel context'):
        fa.flash_attention(q, k, v, impl='ring')
    with sharding.use_sequence_parallel(sp=2):
        with pytest.raises(ValueError, match='window is not supported'):
            fa.flash_attention(q, k, v, impl='ring', window=8)
        with pytest.raises(ValueError, match='logit_softcap'):
            fa.flash_attention(q, k, v, impl='ring', logit_softcap=30.0)
    with sharding.use_sequence_parallel(sp=3):
        with pytest.raises(ValueError, match='not divisible by sp=3'):
            fa.flash_attention(q, k, v, impl='ring')
    with pytest.raises(ValueError, match='not divisible'):
        ra.ring_attention_sharded(q, k, v, sp=5)
    with pytest.raises(ValueError, match='KV dividing H'):
        ra.ring_attention_sharded(q, k[:, :, :1].expand(2, 32, 3, 16),
                                  v[:, :, :1].expand(2, 32, 3, 16), sp=2)
    with pytest.raises(ValueError, match='exactly one of'):
        sharding.sequence_parallel()
    with pytest.raises(ValueError, match='sp must be'):
        sharding.sequence_parallel(0)
    with pytest.raises(RuntimeError, match='torch.distributed'):
        ra.ring_attention(q, k, v)


# -------------------------------------------------------- per-rank (gloo)

_WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from skypilot_tpu_torch.ops import ring_attention as ra
from skypilot_tpu_torch.parallel import distributed, mesh

tmp, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
group = distributed.join_group(world, rank, f'file://{tmp}/rendezvous',
                               'gloo', 'cpu', 30, cls=mesh.TrainGroup)
ring = group.split(1, 1, world).ring
data = np.load(f'{tmp}/inputs.npz')
chunk = data['q'].shape[1] // world
cols = slice(rank * chunk, (rank + 1) * chunk)
out = {}
for causal in (True, False):
    leaves = [torch.from_numpy(np.ascontiguousarray(data[n][:, cols]))
              .requires_grad_() for n in ('q', 'k', 'v')]
    y = ra.ring_attention(*leaves, group=ring, causal=causal)
    y.backward(torch.from_numpy(np.ascontiguousarray(data['g'][:, cols])))
    for name, t in zip(('out', 'dq', 'dk', 'dv'),
                       [y] + [x.grad for x in leaves]):
        out[f'{name}_{causal}'] = t.detach().numpy()
assert ring.calls['collective_permute'] > 0, dict(ring.calls)
np.savez(f'{tmp}/rank{rank}.npz', **out)
dist.destroy_process_group()
'''


def _run_ranks(tmp_path, world, timeout=120):
    env = dict(os.environ, PYTHONPATH=_REPO)
    procs = [subprocess.Popen(
        [sys.executable, '-c', _WORKER, str(tmp_path), str(r), str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f'a gloo rank did not finish within {timeout}s')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [np.load(tmp_path / f'rank{r}.npz') for r in range(world)]


@pytest.mark.parametrize('world', [2, 4])
def test_per_rank_ring_on_gloo_equals_one_process_ring(tmp_path, world):
    q, k, v = _qkv(seq=32, seed=world)
    g = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    np.savez(tmp_path / 'inputs.npz', q=q, k=k, v=v, g=g)
    ranks = _run_ranks(tmp_path, world)
    for causal in (True, False):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        y = ra.ring_attention_sharded(*leaves, sp=world, causal=causal)
        y.backward(torch.from_numpy(g))
        full = {'out': y.detach(), 'dq': leaves[0].grad,
                'dk': leaves[1].grad, 'dv': leaves[2].grad}
        for name, ref in full.items():
            got = np.concatenate([r[f'{name}_{causal}'] for r in ranks],
                                 axis=1)
            np.testing.assert_array_equal(got, ref.numpy(),
                                          err_msg=f'{name} causal={causal}')
