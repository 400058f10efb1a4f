"""The port's flash attention (plain versions, autograd Function, public
entry) against the JAX package's flash attention.

The same numpy inputs go through both. The JAX side runs its Pallas
kernels in interpret mode (impl='pallas_interpret', or `_pallas_forward(
..., interpret=True)` for O and lse), as tests/test_compute_stack.py
does; the port runs its plain versions, which is what its wrappers run
on a CPU tensor. Tolerances (fp32): O, lse and gradients within 1e-5
absolute and relative — only the order of the fp32 sums differs (the
Pallas kernels stream key blocks with an online softmax, the plain
versions take one softmax over the whole row); measured <= 3e-6.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module('skypilot_tpu.ops.flash_attention')

_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(batch, seq, heads, kv_heads, head_dim, seed):
    rng = np.random.RandomState(seed)
    shapes = ((batch, seq, heads, head_dim), (batch, seq, kv_heads, head_dim),
              (batch, seq, kv_heads, head_dim), (batch, seq, heads, head_dim))
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _jax_grads(q, k, v, g, **kw):
    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, **kw)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


def _port_grads(q, k, v, g, **kw):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, **kw)
    out.backward(torch.tensor(g))
    return [out.detach().numpy()] + [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize('causal,window,heads,kv_heads', [
    (True, 0, 4, 2), (False, 0, 4, 2), (True, 40, 4, 2), (True, 0, 2, 2)],
    ids=['causal-gqa', 'full-gqa', 'window-gqa', 'causal-mha'])
def test_forward_and_lse_match_pallas_forward(causal, window, heads,
                                              kv_heads):
    q, k, v, _ = _inputs(2, 128, heads, kv_heads, 32, seed=heads + window)
    scale = 32 ** -0.5
    n_rep = heads // kv_heads
    ref_out, ref_lse = jfa._pallas_forward(  # pylint: disable=protected-access
        jfa._fold(jnp.asarray(q)),  # pylint: disable=protected-access
        jfa._fold(jfa._repeat_kv(jnp.asarray(k), n_rep)),  # pylint: disable=protected-access
        jfa._fold(jfa._repeat_kv(jnp.asarray(v), n_rep)),  # pylint: disable=protected-access
        causal, window, scale, 64, 32, True)
    out, lse = fa.flash_forward_plain(torch.tensor(q), torch.tensor(k),
                                      torch.tensor(v), causal=causal,
                                      sm_scale=scale, window=window)
    np.testing.assert_allclose(
        out.numpy().transpose(0, 2, 1, 3).reshape(2 * heads, 128, 32),
        np.asarray(ref_out), **_TOL)
    np.testing.assert_allclose(lse.numpy().reshape(2 * heads, 1, 128),
                               np.asarray(ref_lse), **_TOL)


@pytest.mark.parametrize('causal,window,heads,kv_heads,block_q,block_k', [
    (True, 0, 4, 2, 64, 64),
    (True, 0, 4, 2, 32, 64),
    (False, 0, 4, 2, 64, 32),
    (True, 48, 4, 2, 32, 32),
    (True, 0, 2, 2, 64, 32),
    (False, 0, 4, 1, 32, 64),
], ids=['causal-gqa', 'causal-bq<bk', 'full-bq>bk', 'window', 'mha',
        'full-mqa'])
def test_grads_match_pallas_interpret(causal, window, heads, kv_heads,
                                      block_q, block_k):
    q, k, v, g = _inputs(2, 128, heads, kv_heads, 32, seed=block_q + window)
    ref = _jax_grads(q, k, v, g, causal=causal, window=window,
                     impl='pallas_interpret', block_q=block_q,
                     block_k=block_k)
    got = _port_grads(q, k, v, g, causal=causal, window=window,
                      impl='pallas_interpret')
    for name, a, b in zip(('out', 'dq', 'dk', 'dv'), got, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **_TOL)


@pytest.mark.parametrize('impl', ['auto', 'pallas'])
@pytest.mark.parametrize('window', [0, 30])
def test_ragged_seq_matches_reference_xla_path(impl, window):
    """S = 100 tiles by no kernel block; the port's kernel route (plain
    pair on the CPU) against the JAX XLA path's VJP."""
    q, k, v, g = _inputs(1, 100, 4, 2, 32, seed=5 + window)
    ref = _jax_grads(q, k, v, g, causal=True, window=window, impl='xla')
    got = _port_grads(q, k, v, g, causal=True, window=window, impl=impl)
    for name, a, b in zip(('out', 'dq', 'dk', 'dv'), got, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **_TOL)


def test_xla_path_matches_reference_with_softcap():
    q, k, v, g = _inputs(1, 64, 4, 2, 32, seed=9)
    ref = _jax_grads(q, k, v, g, impl='xla', logit_softcap=20.0)
    got = _port_grads(q, k, v, g, impl='auto', logit_softcap=20.0)
    for name, a, b in zip(('out', 'dq', 'dk', 'dv'), got, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **_TOL)


def test_backward_numerical_gradcheck():
    """Directional derivative against central finite differences (as
    test_flash_backward_numerical_gradcheck does for the JAX kernels):
    catches a wrong-but-consistent pair of plain versions."""
    q, k, v, _ = (torch.tensor(x) for x in _inputs(1, 64, 2, 1, 32, seed=3))
    tangent = torch.tensor(np.random.RandomState(4).randn(*q.shape),
                           dtype=torch.float32)

    def loss(q_):
        return torch.sin(fa.flash_attention(q_, k, v, impl='pallas')).sum()

    leaf = q.clone().requires_grad_()
    loss(leaf).backward()
    eps = 1e-3
    with torch.no_grad():
        fd = (loss(q + eps * tangent) - loss(q - eps * tangent)) / (2 * eps)
    analytic = float((leaf.grad * tangent).sum())
    np.testing.assert_allclose(analytic, float(fd), rtol=2e-2)


def test_refusals():
    q, k, v, _ = (torch.tensor(x) for x in _inputs(1, 16, 2, 1, 32, seed=0))
    for impl in ('pallas', 'pallas_interpret'):
        with pytest.raises(ValueError, match='softcap'):
            fa.flash_attention(q, k, v, impl=impl, logit_softcap=30.0)
    with pytest.raises(ValueError, match='window requires causal'):
        fa.flash_attention(q, k, v, causal=False, window=8)
    # The ring needs the ambient sequence-parallel context, and refuses a
    # window (the reference's refusals).
    with pytest.raises(ValueError, match='sequence-parallel context'):
        fa.flash_attention(q, k, v, impl='ring')
    with pytest.raises(ValueError, match='window is not supported'):
        fa.flash_attention(q, k, v, impl='ring', window=8)
    with pytest.raises(ValueError, match='Unknown impl'):
        fa.flash_attention(q, k, v, impl='cudnn')
    with pytest.raises(ValueError, match='not divisible'):
        fa.flash_attention(q[:, :, :1].expand(1, 16, 3, 32), k.expand(
            1, 16, 2, 32), v.expand(1, 16, 2, 32))


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run their plain versions and count no
    kernel launch; other devices are refused."""
    q, k, v, g = (torch.tensor(x) for x in _inputs(1, 32, 2, 1, 64, seed=1))
    before = (fa.flash_forward.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, impl='auto').backward(g)
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == before
    out, lse = fa.flash_forward(q, k, v, causal=True, sm_scale=0.125)
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal=True,
                                              sm_scale=0.125)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    with pytest.raises(ValueError, match='not meta'):
        fa.flash_forward(q.to('meta'), k.to('meta'), v.to('meta'),
                         causal=True, sm_scale=0.125)


def _grouped_walk(q, k, v, *, causal, sm_scale, window=0, rows=128,
                  keys=64):
    """The bf16 forward's tile order in plain fp32 torch: a tile is the
    n_rep query heads of one KV head at rows // n_rep positions (row =
    position * n_rep + head), walking the key tiles its causal and window
    bounds reach with an online softmax. Returns O (B, S, H, D) and lse
    (B, H, S)."""
    batch, seq, heads, dim = q.shape
    kv_heads = k.shape[2]
    n_rep = heads // kv_heads
    positions = rows // n_rep
    out = torch.zeros_like(q)
    lse = torch.zeros(batch, heads, seq)
    for b in range(batch):
        for g in range(kv_heads):
            for q0 in range(0, seq, positions):
                pos = torch.arange(q0, min(seq, q0 + positions))
                qt = q[b, pos, g * n_rep:(g + 1) * n_rep].reshape(-1, dim)
                row_pos = pos.repeat_interleave(n_rep)
                k_hi = int(pos[-1]) + 1 if causal else seq
                k_lo = max(0, q0 - window + 1) if window else 0
                m = torch.full((len(row_pos),), float('-inf'))
                l = torch.zeros(len(row_pos))
                acc = torch.zeros(len(row_pos), dim)
                for k0 in range(k_lo // keys * keys, k_hi, keys):
                    cols = torch.arange(k0, k0 + keys)
                    present = cols < seq
                    kt = k[b, cols.clamp(max=seq - 1), g]
                    vt = torch.where(present[:, None],
                                     v[b, cols.clamp(max=seq - 1), g], 0.)
                    s = (qt @ kt.T) * sm_scale
                    keep = torch.ones_like(s, dtype=torch.bool)
                    if causal:
                        keep &= cols[None, :] <= row_pos[:, None]
                    if window:
                        keep &= row_pos[:, None] - cols[None, :] < window
                    s = torch.where(keep, s, torch.tensor(-1e30))
                    s = torch.where(present[None, :], s,
                                    torch.tensor(float('-inf')))
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vt
                    m = m_new
                l_safe = l.clamp(min=1e-30)
                out[b, pos, g * n_rep:(g + 1) * n_rep] = (
                    acc / l_safe[:, None]).reshape(len(pos), n_rep, dim)
                lse[b, g * n_rep:(g + 1) * n_rep, pos] = (
                    m + torch.log(l_safe)).reshape(len(pos), n_rep).T
    return out, lse


@pytest.mark.parametrize('causal,window,heads,kv_heads,seq', [
    (True, 0, 2, 2, 200),      # n_rep 1: 128 positions a tile, ragged S
    (True, 0, 4, 2, 128),      # n_rep 2: 64 positions a tile
    (False, 0, 8, 2, 192),     # n_rep 4, non-causal
    (True, 40, 8, 1, 192),     # n_rep 8, window: leading tiles skipped
])
def test_grouped_head_walk_matches_plain_and_pallas(causal, window, heads,
                                                    kv_heads, seq):
    q, k, v, _ = _inputs(2, seq, heads, kv_heads, 32, seed=seq + heads)
    scale = 32 ** -0.5
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out, lse = _grouped_walk(tq, tk, tv, causal=causal, sm_scale=scale,
                             window=window)
    plain_out, plain_lse = fa.flash_forward_plain(
        tq, tk, tv, causal=causal, sm_scale=scale, window=window)
    np.testing.assert_allclose(out.numpy(), plain_out.numpy(), **_TOL)
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), **_TOL)
    if seq % 64 == 0:          # the Pallas forward tiles S by its blocks
        n_rep = heads // kv_heads
        ref_out, ref_lse = jfa._pallas_forward(  # pylint: disable=protected-access
            jfa._fold(jnp.asarray(q)),  # pylint: disable=protected-access
            jfa._fold(jfa._repeat_kv(jnp.asarray(k), n_rep)),  # pylint: disable=protected-access
            jfa._fold(jfa._repeat_kv(jnp.asarray(v), n_rep)),  # pylint: disable=protected-access
            causal, window, scale, 64, 64, True)
        np.testing.assert_allclose(
            out.numpy().transpose(0, 2, 1, 3).reshape(2 * heads, seq, 32),
            np.asarray(ref_out), **_TOL)
        np.testing.assert_allclose(lse.numpy().reshape(2 * heads, 1, seq),
                                   np.asarray(ref_lse), **_TOL)


def _hidden(row_pos, cols, seq, causal, window):
    """(rows, cols) pairs a mask hides or whose key is absent."""
    hide = cols[None, :] >= seq
    if causal:
        hide = hide | (cols[None, :] > row_pos[:, None])
    if window:
        hide = hide | (row_pos[:, None] - cols[None, :] >= window)
    return hide


def _grouped_dq_walk(q, k, v, do, lse, delta, *, causal, sm_scale, window=0,
                     rows=128, keys=64):
    """The bf16 dQ kernel's walk in plain fp32 torch: a work tile is the
    n_rep query heads of one KV head at rows // n_rep positions (row =
    position * n_rep + head), walking the key tiles its causal and window
    bounds reach; p = exp(s scale - lse) with hidden pairs at 0, ds = p
    (dp - delta), dQ += ds.K, times scale at the end. Returns dQ
    (B, S, H, D)."""
    batch, seq, heads, dim = q.shape
    kv_heads = k.shape[2]
    n_rep = heads // kv_heads
    positions = rows // n_rep
    dq = torch.zeros_like(q)
    for b in range(batch):
        for g in range(kv_heads):
            hs = slice(g * n_rep, (g + 1) * n_rep)
            for q0 in range(0, seq, positions):
                pos = torch.arange(q0, min(seq, q0 + positions))
                row_pos = pos.repeat_interleave(n_rep)
                qt = q[b, pos, hs].reshape(-1, dim)
                dot = do[b, pos, hs].reshape(-1, dim)
                lse_r = lse[b, hs][:, pos].T.reshape(-1)
                delta_r = delta[b, hs][:, pos].T.reshape(-1)
                k_hi = int(pos[-1]) + 1 if causal else seq
                k_lo = max(0, q0 - window + 1) if window else 0
                acc = torch.zeros(len(row_pos), dim)
                for k0 in range(k_lo // keys * keys, k_hi, keys):
                    cols = torch.arange(k0, k0 + keys)
                    present = (cols < seq)[:, None]
                    kt = torch.where(present, k[b, cols.clamp(max=seq - 1), g],
                                     0.)
                    vt = torch.where(present, v[b, cols.clamp(max=seq - 1), g],
                                     0.)
                    p = torch.exp((qt @ kt.T) * sm_scale - lse_r[:, None])
                    p = torch.where(_hidden(row_pos, cols, seq, causal,
                                            window), 0., p)
                    ds = p * ((dot @ vt.T) - delta_r[:, None])
                    acc = acc + ds @ kt
                dq[b, pos, hs] = (acc * sm_scale).reshape(len(pos), n_rep,
                                                          dim)
    return dq


def _dkv_walk(q, k, v, do, lse, delta, *, causal, sm_scale, window=0,
              keys=128, group_keys=64, q_tile=64):
    """The bf16 dK/dV kernel's walk in plain fp32 torch: a work tile is
    (b, KV head, `keys`-key tile), split into warpgroups of `group_keys`
    keys; it walks the group's query heads one after another and, within
    each, the q tiles from the first the causal mask lets see the key tile
    to the last the window lets in, skipping a q tile none of a
    warpgroup's keys can see; dV += p^T.dO and dK += ds^T.Q summed in
    that order, dK times scale at the end. Returns dK, dV (B, S, KV, D)."""
    batch, seq, heads, dim = q.shape
    kv_heads = k.shape[2]
    n_rep = heads // kv_heads
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(batch):
        for g in range(kv_heads):
            for k0 in range(0, seq, keys):
                q_lo = k0 if causal else 0
                q_hi = min(seq, k0 + keys - 1 + window) if window else seq
                for kw0 in range(k0, min(seq, k0 + keys), group_keys):
                    cols = torch.arange(kw0, min(seq, kw0 + group_keys))
                    acc_k = torch.zeros(len(cols), dim)
                    acc_v = torch.zeros(len(cols), dim)
                    for h in range(g * n_rep, (g + 1) * n_rep):
                        for q0 in range(q_lo // q_tile * q_tile, q_hi,
                                        q_tile):
                            if causal and q0 + q_tile - 1 < kw0:
                                continue
                            if window and q0 - (kw0 + group_keys - 1) >= \
                                    window:
                                continue
                            pos = torch.arange(q0, min(seq, q0 + q_tile))
                            p = torch.exp(k[b, cols, g] @ q[b, pos, h].T *
                                          sm_scale - lse[b, h, pos][None, :])
                            p = torch.where(_hidden(pos, cols, seq, causal,
                                                    window).T, 0., p)
                            ds = p * (v[b, cols, g] @ do[b, pos, h].T -
                                      delta[b, h, pos][None, :])
                            acc_v = acc_v + p @ do[b, pos, h]
                            acc_k = acc_k + ds @ q[b, pos, h]
                    dk[b, cols, g] = acc_k * sm_scale
                    dv[b, cols, g] = acc_v
    return dk, dv


@pytest.mark.parametrize('causal,window,heads,kv_heads,seq', [
    (True, 0, 2, 2, 200),      # n_rep 1, ragged S: a ragged last key tile
    (True, 0, 4, 2, 256),      # n_rep 2: 64 positions a dQ tile
    (True, 40, 4, 2, 192),     # n_rep 2, window: leading tiles skipped
    (False, 0, 8, 2, 192),     # n_rep 4, non-causal
    (True, 0, 8, 1, 130),      # n_rep 8, ragged S
    (True, 24, 6, 2, 100),     # n_rep 3: 126 live rows, window, ragged
])
def test_backward_walks_match_plain_and_pallas(causal, window, heads,
                                               kv_heads, seq):
    """The bf16 dQ and dK/dV kernels' tile walks (`_grouped_dq_walk`,
    `_dkv_walk`) in fp32 against the plain pair and, where S tiles by 64,
    the JAX Pallas backward in interpret mode: 1e-5 (the order of fp32
    sums only)."""
    q, k, v, g = _inputs(2, seq, heads, kv_heads, 32, seed=seq + heads + 1)
    scale = 32 ** -0.5
    tq, tk, tv, tg = (torch.tensor(x) for x in (q, k, v, g))
    opts = dict(causal=causal, sm_scale=scale, window=window)
    out, lse = fa.flash_forward_plain(tq, tk, tv, **opts)
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    dq = _grouped_dq_walk(tq, tk, tv, tg, lse, delta, **opts)
    dk, dv = _dkv_walk(tq, tk, tv, tg, lse, delta, **opts)
    ref_dq = fa.flash_dq_plain(tq, tk, tv, tg, lse, delta, **opts)
    ref_dk, ref_dv = fa.flash_dkv_plain(tq, tk, tv, tg, lse, delta, **opts)
    for name, a, b in (('dq', dq, ref_dq), ('dk', dk, ref_dk),
                       ('dv', dv, ref_dv)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **_TOL)
    if seq % 64 == 0:          # the Pallas backward tiles S by its blocks
        n_rep = heads // kv_heads
        fold = jfa._fold  # pylint: disable=protected-access
        rep = jfa._repeat_kv  # pylint: disable=protected-access
        jdq, jdk, jdv = jfa._pallas_backward(  # pylint: disable=protected-access
            fold(jnp.asarray(q)), fold(rep(jnp.asarray(k), n_rep)),
            fold(rep(jnp.asarray(v), n_rep)), fold(jnp.asarray(g)),
            jnp.asarray(lse.numpy().reshape(2 * heads, 1, seq)),
            jnp.asarray(delta.numpy().reshape(2 * heads, 1, seq)),
            causal, window, scale, 64, 64, True)

        def unfold(x):
            return np.asarray(x).reshape(2, heads, seq, 32).transpose(
                0, 2, 1, 3)
        np.testing.assert_allclose(dq.numpy(), unfold(jdq), err_msg='dq',
                                   **_TOL)
        # The reference sums dK/dV over the n_rep heads after its kernel.
        for name, a, j in (('dk', dk, jdk), ('dv', dv, jdv)):
            ref = unfold(j).reshape(2, seq, kv_heads, n_rep, 32).sum(3)
            np.testing.assert_allclose(a.numpy(), ref, err_msg=name, **_TOL)
