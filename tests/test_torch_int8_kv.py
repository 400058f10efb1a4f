"""int8 KV in the port against the JAX package (TPU kernel
`_decode_kernel_int8` and its callers).

- `int8_quantize` is bit-equal to the reference's `_int8_quantize`,
  half-way ties included (round half to even in both frameworks).
- The int8 plain paged attention (what the wrapper runs on a CPU tensor)
  against the reference's `paged_decode_attention(..., k_scale, v_scale,
  interpret=True)`, the TPU kernel under the Pallas interpreter, and
  against `_attend_window` on a contiguous window: T 1, 3 and 16, a
  sliding window, stale blocks, the lone-scale refusal. Tolerance 2e-6,
  the reference's own kernel-vs-dense bound (the streaming softmax sums
  in another order than the one-shot softmax; fp32 inputs).
- The port's int8 engine against the JAX `kv_quant='int8'` engine
  (test-tiny, fp32, paged 8, chunks of 16): greedy tokens equal on
  staggered admission (more requests than slots, then a second wave into
  freed slots). Pools, after one wave with a slot per request (no block
  is reused, so both engines hand out the same block ids; on staggered
  admission they free and reuse blocks in another order, which no
  output depends on), in every block but the scratch block 0 (where
  duplicate pad-token writes land in an unspecified order in both
  frameworks): fp32 scales within 1e-7 in every written row (a row never
  written holds 1 in the port, as the reference's model declares its
  scale rows, and 0 in the reference engine, which zero-fills its cache;
  no query ever sees such a row), and the int8 payload equal
  except where a K or V value sits on a rounding boundary of
  round(x / scale): the two frameworks compute K and V with fp32 sums in
  other orders (1e-6 relative; tests/test_torch_model.py), so such a
  value rounds to the neighbouring int8 step. The pin: every payload
  element within 1 step, at most 1 in 1000 off (measured: 1 of 21,504).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.transformer import _attend_window, _int8_quantize
from skypilot_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.models.transformer import int8_quantize
from skypilot_tpu_torch.ops import paged_attention as pa

_ATOL = 2e-6
_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)


# ------------------------------------------------------------- quantizer

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_int8_quantize_bit_equal_reference(dtype):
    rng = np.random.RandomState(0)
    mags = rng.choice([1e-9, 1e-3, 1.0, 300.0], size=(3, 5, 2, 1))
    x = (rng.randn(3, 5, 2, 16) * mags).astype(np.float32)
    # amax 127 makes the scale exactly 1: these are exact half-way ties.
    x[0, 0, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                  3.5, 0.0, -0.0, 4.5, 5.5, 6.5, -7.5]
    ref_q, ref_s = _int8_quantize(jnp.asarray(x, getattr(jnp, dtype)))
    q, s = int8_quantize(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    if dtype == 'float32':
        assert q[0, 0, 0, 1:7].tolist() == [0, 2, 2, 0, -2, -2]


# ------------------------------------------------- paged attention, int8

def _case(batch=2, block_size=8, blocks_per_seq=4, kv_heads=2, n_rep=2,
          head_dim=16, cur_len=1, seed=0):
    """Float inputs quantized by the reference: shuffled physical blocks
    per row, table entries past each row's last position at scratch
    block 0, rows at different depths. Returns q, int8 K/V pools, tables,
    positions, (NB, bs, KV, 1) fp32 K/V scale pools."""
    rng = np.random.RandomState(seed)
    num_blocks = batch * blocks_per_seq + 3
    heads = kv_heads * n_rep
    q = rng.randn(batch, cur_len, heads, head_dim).astype(np.float32)
    shape = (num_blocks, block_size, kv_heads, head_dim)
    k8, ks = _int8_quantize(jnp.asarray(rng.randn(*shape), jnp.float32))
    v8, vs = _int8_quantize(jnp.asarray(rng.randn(*shape), jnp.float32))
    perm = rng.permutation(num_blocks - 1) + 1
    tables = perm[:batch * blocks_per_seq].reshape(
        batch, blocks_per_seq).astype(np.int32)
    positions = np.stack([
        np.arange(cur_len) + 5,
        np.arange(cur_len) + (blocks_per_seq * block_size - cur_len - 1),
    ])[:batch].astype(np.int32)
    for b in range(batch):
        for i in range(blocks_per_seq):
            if i * block_size > positions[b].max():
                tables[b, i] = 0
    return (q, np.array(k8), np.array(v8), tables, positions,
            np.array(ks)[..., None], np.array(vs)[..., None])


def _both(case, **kw):
    q, k8, v8, tables, pos, ks, vs = case
    ref = jax_paged_decode_attention(
        *(jnp.asarray(a) for a in (q, k8, v8, tables, pos)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True,
        **kw)
    ours = pa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, k8, v8, tables, pos)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs), **kw)
    return np.asarray(ref), ours.numpy()


@pytest.mark.parametrize('cur_len', [1, 3, 16])
@pytest.mark.parametrize('n_rep', [1, 4])
def test_int8_plain_matches_reference_kernel(cur_len, n_rep):
    case = _case(cur_len=cur_len, n_rep=n_rep, blocks_per_seq=6,
                 seed=cur_len + n_rep)
    ref, ours = _both(case)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, atol=_ATOL, rtol=_ATOL)


@pytest.mark.parametrize('cur_len', [1, 3])
def test_int8_sliding_window_matches_reference(cur_len):
    case = _case(cur_len=cur_len, n_rep=2, seed=7)
    ref, ours = _both(case, window=10)
    np.testing.assert_allclose(ours, ref, atol=_ATOL, rtol=_ATOL)
    _, full = _both(case)
    assert float(np.abs(ours - full).max()) > 1e-3


def test_int8_stale_blocks_are_inert():
    """Garbage payload and scale rows in the scratch block (the tail of
    every table) never reach the output."""
    q, k8, v8, tables, pos, ks, vs = _case(seed=3)
    _, clean = _both((q, k8, v8, tables, pos, ks, vs))
    k8, v8, ks, vs = k8.copy(), v8.copy(), ks.copy(), vs.copy()
    k8[0], v8[0], ks[0], vs[0] = 127, -127, 1e3, 1e3
    ref, dirty = _both((q, k8, v8, tables, pos, ks, vs))
    np.testing.assert_array_equal(dirty, clean)
    np.testing.assert_allclose(dirty, ref, atol=_ATOL, rtol=_ATOL)


@pytest.mark.parametrize('cur_len', [1, 3, 16])
def test_int8_attend_window_matches_reference(cur_len):
    """The int8 branch of the shared attention math against the
    reference's transformer._attend_window on a contiguous window."""
    cfg = dataclasses.replace(jax_get_config('test-tiny'), dtype='float32')
    rng = np.random.RandomState(11 + cur_len)
    q = rng.randn(2, cur_len, cfg.num_heads,
                  cfg.head_dim).astype(np.float32)
    shape = (2, 24, cfg.num_kv_heads, cfg.head_dim)
    k8, ks = (np.array(a) for a in _int8_quantize(
        jnp.asarray(rng.randn(*shape), jnp.float32)))
    v8, vs = (np.array(a) for a in _int8_quantize(
        jnp.asarray(rng.randn(*shape), jnp.float32)))
    pos = np.stack([np.arange(cur_len) + 4,
                    np.arange(cur_len) + 24 - cur_len]).astype(np.int32)
    ref = _attend_window(cfg, jnp.asarray(q), jnp.asarray(k8),
                         jnp.asarray(v8), jnp.asarray(ks), jnp.asarray(vs),
                         jnp.asarray(pos))
    ours = pa.attend_window(
        *(torch.from_numpy(a) for a in (q, k8, v8, pos)),
        cfg.head_dim ** -0.5, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=_ATOL,
                               rtol=_ATOL)


def test_int8_cpu_tensor_takes_plain_version_without_a_launch():
    q, k8, v8, tables, pos, ks, vs = (torch.from_numpy(a) for a in _case())
    before = (pa.paged_decode_attention.launches,
              pa.paged_decode_attention.int8_launches)
    out = pa.paged_decode_attention(q, k8, v8, tables, pos, k_scale=ks,
                                    v_scale=vs)
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention.int8_launches) == before
    torch.testing.assert_close(
        out, pa.paged_decode_attention_plain(q, k8, v8, tables, pos,
                                             k_scale=ks, v_scale=vs),
        atol=0, rtol=0)


def test_int8_rejects_lone_scale():
    q, k8, v8, tables, pos, ks, _ = (torch.from_numpy(a) for a in _case())
    with pytest.raises(ValueError, match='together'):
        pa.paged_decode_attention(q, k8, v8, tables, pos, k_scale=ks)


# ----------------------------------------------------------- int8 engine

_LENGTHS = (3, 8, 9, 17, 30, 33)
_SECOND_WAVE = (12, 25)
_MAX_NEW = 8


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 512, n).tolist() for n in lengths]


def _run(engine, first, second):
    """First wave at once (more requests than slots), then a second wave
    once the first request has finished."""
    futures = [engine.submit(p, max_new_tokens=_MAX_NEW) for p in first]
    out = [futures[0].result(timeout=120)[0]]
    futures += [engine.submit(p, max_new_tokens=_MAX_NEW) for p in second]
    out += [f.result(timeout=120)[0] for f in futures[1:]]
    return out


def _one_wave(engine, prompts):
    futures = [engine.submit(p, max_new_tokens=_MAX_NEW) for p in prompts]
    return [f.result(timeout=120)[0] for f in futures]


@pytest.fixture(scope='module')
def int8_reference():
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    first, second = _prompts(_LENGTHS, 0), _prompts(_SECOND_WAVE, 1)
    out = {'first': first, 'second': second}
    for slots in (3, len(_LENGTHS)):
        engine = jax_inference.ContinuousBatchingEngine(
            jcfg, num_slots=slots, paged_block_size=8, prefill_chunk=16,
            rng_seed=0, kv_quant='int8')
        try:
            if slots == 3:
                out['outputs'] = _run(engine, first, second)
            else:
                out['one_wave'] = _one_wave(engine, first)
        finally:
            engine.drain(timeout=60)
        out['params'] = jax.device_get(engine.params)
    out['pools'] = jax.device_get(engine._cache)['layers']['layer']['attn']  # pylint: disable=protected-access
    return out


def _int8_engine(reference, num_slots):
    cfg = dataclasses.replace(get_config('test-tiny'), **_KW)
    return ContinuousBatchingEngine(
        cfg, params=params_from_jax(reference['params'], cfg),
        num_slots=num_slots, paged_block_size=8, prefill_chunk=16,
        kv_quant='int8', device='cpu')


def test_int8_engine_matches_reference_engine(int8_reference):
    engine = _int8_engine(int8_reference, 3)
    try:
        outputs = _run(engine, int8_reference['first'],
                       int8_reference['second'])
    finally:
        assert engine.drain(timeout=60)
    assert outputs == int8_reference['outputs']
    engine._pool.check()  # pylint: disable=protected-access
    assert engine._pool.used == 1  # pylint: disable=protected-access


def test_int8_engine_pools_match_reference_pools(int8_reference):
    engine = _int8_engine(int8_reference, len(_LENGTHS))
    try:
        outputs = _one_wave(engine, int8_reference['first'])
    finally:
        assert engine.drain(timeout=60)
    assert outputs == int8_reference['one_wave']
    ref = int8_reference['pools']
    ours = {'cached_key': engine._k_pool, 'cached_value': engine._v_pool,  # pylint: disable=protected-access
            'cached_key_scale': engine._k_scale,  # pylint: disable=protected-access
            'cached_value_scale': engine._v_scale}  # pylint: disable=protected-access
    assert bool(ours['cached_key'][:, 1:].any())
    for name, pool in ours.items():
        got, want = pool.numpy()[:, 1:], np.asarray(ref[name])[:, 1:]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if got.dtype == np.int8:
            steps = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert steps.max() <= 1, name
            assert np.count_nonzero(steps) <= got.size // 1000, name
            continue
        unwritten = (got == 1.0) & (want == 0.0)
        payload = ours['cached_key' if 'key' in name else 'cached_value']
        assert not bool(payload.numpy()[:, 1:][unwritten[..., 0]].any())
        assert np.count_nonzero(~unwritten) > got.size // 4, name
        np.testing.assert_allclose(got[~unwritten], want[~unwritten],
                                   atol=1e-7, rtol=0, err_msg=name)


def test_int8_pools_start_as_reference_pools():
    """int8 payload pools start at zero and scale pools at ONES, as the
    reference's model declares cached_key_scale / cached_value_scale
    (transformer.py:765-777)."""
    cfg = dataclasses.replace(get_config('test-tiny'), **_KW)
    engine = ContinuousBatchingEngine(cfg, num_slots=2, paged_block_size=8,
                                      kv_quant='int8', device='cpu')
    engine.stop()
    k, v, ks, vs = (engine._k_pool, engine._v_pool, engine._k_scale,  # pylint: disable=protected-access
                    engine._v_scale)  # pylint: disable=protected-access
    assert k.dtype == v.dtype == torch.int8 and not k.any() and not v.any()
    assert ks.shape == k.shape[:-1] + (1,) and ks.dtype == torch.float32
    assert bool((ks == 1).all()) and bool((vs == 1).all())
    with pytest.raises(ValueError, match='kv_quant'):
        ContinuousBatchingEngine(cfg, paged_block_size=8, kv_quant='int4',
                                 device='cpu')
