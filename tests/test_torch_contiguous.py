"""The contiguous KV layout on the port (`paged_block_size=0`, the
reference's default), against the JAX package and against the port's own
paged layout.

Weights are test-tiny fp32 from a seeded JAX init carried across with
params_from_jax. JAX is the oracle, run as its own tests run it on the
CPU:
- the model: a bucketed prefill then decode steps through the contiguous
  cache give the JAX model's logits and cache (float and int8 KV) within
  _ATOL, and a chunk whose start lies past S - T lands where JAX's
  `dynamic_update_slice` puts it;
- the engine: greedy tokens equal the JAX contiguous engine's on prompts
  straddling the bucket edges (15/16/17, 31/32/33), more requests than
  slots and a second wave into freed slots.
Within the port, the reference's own contracts: contiguous equals paged
on the 'xla' route bit for bit (tests/test_paged_cache.py); the int8 and
speculative cells at async depth 0, 1 and 3 equal the sync contiguous
baseline, EOS overshoot included, and so do the port's paged cells
(tests/test_composition_matrix.py); a prefix hit equals a cold prefill,
_MIN_PREFIX and LRU eviction behave as in tests/test_inference.py;
adapter requests bypass the prefix cache and a per-adapter batch equals a
dedicated engine; a wedge recovery keeps the slot cache and the next
pass's tokens; memory_footprint's bytes; the reference's refusals; the
defaults; and the server with --paged-block-size 0.
"""
import dataclasses
import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import adapter_layout, params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.serve.server import BackgroundServer, InferenceServer
from skypilot_tpu_torch.utils import fault_injection

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
# Logits and cache of the two frameworks: fp32, the sums in other orders
# (the paged model's pin, tests/test_torch_model.py, measures ~1.7e-6).
_ATOL = 2e-5
_LENGTHS = (15, 16, 17, 31, 32, 33)
_SECOND_WAVE = (12, 20)
_MAX_NEW = 8
# tests/test_composition_matrix.py's prompt.
_PROMPT = [9, 9, 8, 8, 7, 7, 6, 6]
_WATCHDOG = 1.0


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 512, n).tolist() for n in lengths]


def _cfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


def _run(engine, first, second):
    """First wave at once (more requests than slots), then a second wave
    once the first request has finished."""
    futures = [engine.submit(p, max_new_tokens=_MAX_NEW) for p in first]
    out = [futures[0].result(timeout=120)[0]]
    futures += [engine.submit(p, max_new_tokens=_MAX_NEW) for p in second]
    out += [f.result(timeout=120)[0] for f in futures[1:]]
    return out


@pytest.fixture(scope='module')
def reference():
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    engine = jax_inference.ContinuousBatchingEngine(jcfg, num_slots=3,
                                                    rng_seed=0)
    first, second = _prompts(_LENGTHS, 0), _prompts(_SECOND_WAVE, 1)
    try:
        outputs = _run(engine, first, second)
    finally:
        engine.drain(timeout=60)
    return {'params': jax.device_get(engine.params), 'jcfg': jcfg,
            'first': first, 'second': second, 'outputs': outputs}


def _engine(reference, **kw):
    kw.setdefault('num_slots', 3)
    return ContinuousBatchingEngine(
        _cfg(), params=params_from_jax(reference['params'], _cfg()),
        device='cpu', **kw)


def _generate(engine, prompt, **kw):
    return engine.generate(prompt, timeout=120, **kw)[0]


# ---------------- the model ----------------


def _jax_cache(jmodel, batch):
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((batch, 1), jnp.int32),
        jnp.zeros((batch, 1), jnp.int32)))['cache']
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        nn.unbox(shapes))


def _jax_leaf(cache, name):
    return np.asarray(cache['layers']['layer']['attn'][name])


def _models(reference, kv_quant):
    jcfg = dataclasses.replace(reference['jcfg'], decode=True,
                               kv_cache_quant=kv_quant)
    tcfg = dataclasses.replace(_cfg(), decode=True, kv_cache_quant=kv_quant)
    model = Transformer(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(reference['params'], tcfg),
                          assign=True)
    return JaxTransformer(jcfg), model


def _step_both(reference, jmodel, cache, model, caches, tokens, positions):
    ref, mutated = jmodel.apply(
        {'params': reference['params'], 'cache': cache},
        jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32),
        mutable=['cache'])
    scales = caches[2:] or (None, None)
    with torch.inference_mode():
        ours = model(torch.from_numpy(np.asarray(tokens)).int(),
                     torch.from_numpy(np.asarray(positions)).int(), None,
                     caches[0], caches[1], k_scale=scales[0],
                     v_scale=scales[1])
    return np.asarray(ref), ours.numpy(), nn.unbox(mutated['cache'])


def _check_caches(cache, caches, kv_quant):
    names = ['cached_key', 'cached_value']
    if kv_quant:
        names += ['cached_key_scale', 'cached_value_scale']
    for name, ours in zip(names, caches):
        ref = _jax_leaf(cache, name)
        if ours.dtype == torch.int8:
            # An int8 payload element may sit one step off on a rounding
            # boundary (tests/test_torch_int8_kv.py): at most one step.
            assert np.abs(ours.numpy().astype(np.int32) -
                          ref.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(ours.numpy(), ref, atol=_ATOL,
                                       rtol=_ATOL, err_msg=name)


@pytest.mark.parametrize('kv_quant', ['', 'int8'], ids=['float', 'int8'])
def test_contiguous_logits_match_reference(reference, kv_quant):
    """A batch-2 bucket-16 prefill (rows of 11 and 14 real tokens), then
    decode steps at each row's own position, through the contiguous cache
    of both frameworks."""
    jmodel, model = _models(reference, kv_quant)
    cache = _jax_cache(jmodel, 2)
    caches = model.new_kv_cache(2)
    rng = np.random.RandomState(3)
    tokens = rng.randint(1, 512, (2, 16))
    steps = [(tokens, np.tile(np.arange(16), (2, 1)))]
    steps += [(rng.randint(1, 512, (2, 1)), np.array([[11 + s], [14 + s]]))
              for s in range(4)]
    for tokens, positions in steps:
        ref, ours, cache = _step_both(reference, jmodel, cache, model,
                                      caches, tokens, positions)
        np.testing.assert_allclose(ours, ref, atol=_ATOL, rtol=_ATOL)
    _check_caches(cache, caches, kv_quant)


@pytest.mark.parametrize('kv_quant', ['', 'int8'], ids=['float', 'int8'])
def test_write_past_the_window_lands_where_dus_puts_it(reference, kv_quant):
    """dynamic_update_slice clamps its start to [0, S - T]: a 4-token
    chunk starting at S - 2 lands at S - 4, and an inert decode row at
    S + 5 writes position S - 1. Both frameworks write the same cells and
    give the same logits."""
    jmodel, model = _models(reference, kv_quant)
    seq = _KW['max_seq_len']
    cache = _jax_cache(jmodel, 2)
    caches = model.new_kv_cache(2)
    rng = np.random.RandomState(5)
    prefill = np.tile(np.arange(16), (2, 1))
    _, _, cache = _step_both(reference, jmodel, cache, model, caches,
                             rng.randint(1, 512, (2, 16)), prefill)
    chunk = np.stack([np.arange(seq - 2, seq + 2), np.arange(20, 24)])
    ref, ours, cache = _step_both(reference, jmodel, cache, model, caches,
                                  rng.randint(1, 512, (2, 4)), chunk)
    np.testing.assert_allclose(ours, ref, atol=_ATOL, rtol=_ATOL)
    _check_caches(cache, caches, kv_quant)
    # Row 0's chunk sits at S - 4 .. S - 1; nothing else past 16 moved.
    written = caches[0][0, 0].abs().sum(dim=(-1, -2)) > 0
    assert written[seq - 4:].all() and not written[16:seq - 4].any()
    inert = np.array([[seq + 5], [24]])
    ref, ours, cache = _step_both(reference, jmodel, cache, model, caches,
                                  rng.randint(1, 512, (2, 1)), inert)
    np.testing.assert_allclose(ours[1], ref[1], atol=_ATOL, rtol=_ATOL)
    _check_caches(cache, caches, kv_quant)


# ---------------- the engine against JAX ----------------


def test_greedy_tokens_equal_reference_engine(reference):
    """The default layout, as the reference's ContinuousBatchingEngine(cfg)
    serves it: contiguous, on the 'xla' route, one prefill an
    admission."""
    engine = _engine(reference)
    assert engine.paged_block_size == 0 and engine.decode_kernel == 'xla'
    try:
        outputs = _run(engine, reference['first'], reference['second'])
    finally:
        assert engine.drain(timeout=60)
    assert outputs == reference['outputs']
    assert engine.tick_stats['prefills'] == len(_LENGTHS) + len(
        _SECOND_WAVE)
    assert engine.paged_stats['prefill_chunks'] == 0
    assert engine.paged_occupancy() == {}


def test_default_engine_serves_contiguous_on_xla():
    """ContinuousBatchingEngine(cfg) with defaults: the contiguous layout
    on the 'xla' route; an explicit 'pallas' there is refused with the
    reference's message."""
    engine = ContinuousBatchingEngine(_cfg(), device='cpu')
    assert (engine.paged_block_size, engine.decode_kernel,
            engine.cfg.paged_block_size) == (0, 'xla', 0)
    assert tuple(engine._k_pool.shape) == (  # pylint: disable=protected-access
        engine.cfg.num_layers, 4, _KW['max_seq_len'],
        engine.cfg.num_kv_heads, engine.cfg.head_dim)
    tokens, _ = engine.generate([1, 2, 3], max_new_tokens=3, timeout=60)
    engine.stop()
    assert len(tokens) == 3
    with pytest.raises(NotImplementedError,
                       match="decode_kernel='pallas' requires the paged KV"):
        ContinuousBatchingEngine(_cfg(), decode_kernel='pallas',
                                 device='cpu')


# ---------------- within the port ----------------


@pytest.fixture(scope='module')
def baselines(reference):
    """The sync contiguous streams, float and int8 KV (an engine emits
    the same greedy stream at any max_new_tokens prefix)."""
    out = {}
    for quant in ('', 'int8'):
        engine = _engine(reference, num_slots=2, kv_quant=quant or None)
        try:
            out[quant] = _generate(engine, _PROMPT, max_new_tokens=30)
        finally:
            engine.stop()
    assert out[''] != out['int8'], 'int8 baseline suspiciously equals fp'
    return out


@pytest.mark.parametrize('quant', ['', 'int8'], ids=['float', 'int8'])
def test_contiguous_equals_paged_xla_bit_for_bit(reference, quant):
    """tests/test_paged_cache.py's contract: prompts below, at and above
    a block multiple, and concurrent slots, decode to the same tokens on
    both layouts (the paged one on the 'xla' route)."""
    prompts = [list(range(2, 9)), list(range(2, 10)), list(range(2, 19)),
               list(range(2, 26))]
    contiguous = _engine(reference, num_slots=2, kv_quant=quant or None)
    paged = _engine(reference, num_slots=2, kv_quant=quant or None,
                    paged_block_size=8, decode_kernel='xla')
    try:
        for prompt in prompts:
            assert _generate(paged, prompt, max_new_tokens=8) == \
                _generate(contiguous, prompt, max_new_tokens=8)
        want = _generate(contiguous, prompts[2], max_new_tokens=10)
        futures = [paged.submit(prompts[2], max_new_tokens=10)
                   for _ in range(4)]
        assert all(f.result(timeout=120)[0] == want for f in futures)
    finally:
        contiguous.stop()
        paged.stop()


# The reference's cells that make sense without paging, then the port's
# paged cells (kernel route: its plain version on the CPU).
_CELLS = [
    ('int8', dict(kv_quant='int8')),
    ('spec', dict(speculative=3)),
    ('int8-spec', dict(kv_quant='int8', speculative=3)),
    ('paged', dict(paged_block_size=8)),
    ('paged-int8-spec-chunkedprefill',
     dict(paged_block_size=8, kv_quant='int8', speculative=3,
          prefill_chunk=4)),
]


@pytest.mark.parametrize('depth', [0, 1, 3])
@pytest.mark.parametrize('name,kw', _CELLS, ids=[c[0] for c in _CELLS])
def test_cell_equals_the_contiguous_baseline(reference, baselines, name,
                                             kw, depth):
    ref = baselines['int8' if 'int8' in name else '']
    engine = _engine(reference, num_slots=2, async_depth=depth, **kw)
    try:
        got = _generate(engine, _PROMPT, max_new_tokens=16)
        assert got == ref[:16], (name, depth, got)
        if depth >= 1 and not kw.get('speculative'):
            assert engine.tick_stats['chained'] > 0, (name, depth)
        # EOS overshoot: seen up to `depth` dispatches late, discarded by
        # identity.
        got = _generate(engine, _PROMPT, max_new_tokens=16, eos_id=ref[5])
        assert got == ref[:6], (name, depth, got)
    finally:
        engine.stop()


def test_prefix_hit_equals_cold_prefill(reference):
    """tests/test_inference.py's prefix contract on the contiguous
    layout: a prompt extending a cached one prefills only its suffix, an
    exact repeat reuses all but its last token, and the tokens equal an
    uncached engine's."""
    base = list(range(2, 26))
    extended = base + [3, 9, 27]
    cold = _engine(reference, num_slots=1)
    try:
        want_base = _generate(cold, base, max_new_tokens=6)
        want_ext = _generate(cold, extended, max_new_tokens=6)
    finally:
        cold.stop()
    engine = _engine(reference, num_slots=1, prefix_cache=4)
    try:
        assert _generate(engine, base, max_new_tokens=6) == want_base
        assert engine.prefix_stats['misses'] == 1
        assert _generate(engine, extended, max_new_tokens=6) == want_ext
        assert engine.prefix_stats['hits'] == 1
        assert engine.prefix_stats['tokens_reused'] == len(base)
        assert _generate(engine, extended, max_new_tokens=6) == want_ext
        assert engine.prefix_stats == {
            'hits': 2, 'misses': 1,
            'tokens_reused': len(base) + len(extended) - 1}
        # A cached prefix under _MIN_PREFIX tokens is re-prefilled.
        short = list(range(100, 110))
        _generate(engine, short, max_new_tokens=2)
        _generate(engine, short + [1, 2], max_new_tokens=2)
        assert engine.prefix_stats['hits'] == 2
        # The entries are whole batch-1 caches.
        _key, payload = engine._prefix_entries.entries()[0]  # pylint: disable=protected-access
        assert tuple(payload[0].shape)[1] == 1
    finally:
        engine.stop()


def test_prefix_lru_evicts(reference):
    engine = _engine(reference, num_slots=1, prefix_cache=2)
    try:
        p1, p2, p3 = (list(range(2, 22)), list(range(30, 50)),
                      list(range(60, 80)))
        for p in (p1, p2, p3):
            _generate(engine, p, max_new_tokens=2)
        assert len(engine._prefix_entries) == 2  # pylint: disable=protected-access
        _generate(engine, p1 + [1, 2], max_new_tokens=2)
        assert engine.prefix_stats['hits'] == 0
        _generate(engine, p3 + [1, 2], max_new_tokens=2)
        assert engine.prefix_stats['hits'] == 1
    finally:
        engine.stop()


def _random_adapter(cfg, seed):
    """One adapter in the reference's models/lora layout, scaled to move
    the tokens."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.standard_normal(v) * 0.5).astype(np.float32))
                for k, v in sorted(node.items())}
    return walk(adapter_layout(cfg))


def test_adapters_bypass_the_prefix_cache(reference):
    """A mixed batch of base and adapter requests equals each served
    alone, an adapter moves the tokens, and adapter requests neither hit
    nor publish prefix entries."""
    kw = dict(max_adapters=2, adapter_rank=4, adapter_alpha=8.0,
              adapter_targets='q,v')
    prompt = list(range(2, 26))
    engine = _engine(reference, num_slots=3, prefix_cache=4, **kw)
    try:
        engine.load_adapter('a', _random_adapter(engine.cfg, 1))
        engine.load_adapter('b', _random_adapter(engine.cfg, 2))
        alone = {name: engine.generate(prompt, max_new_tokens=6,
                                       adapter=name, timeout=120)[0]
                 for name in ('a', 'b')}
        assert engine.prefix_stats == {'hits': 0, 'misses': 0,
                                       'tokens_reused': 0}
        base = _generate(engine, prompt, max_new_tokens=6)
        assert base != alone['a'] and alone['a'] != alone['b']
        futures = [engine.submit(prompt, max_new_tokens=6, adapter=a)
                   for a in (None, 'a', 'b')]
        mixed = [f.result(timeout=120)[0] for f in futures]
        assert mixed == [base, alone['a'], alone['b']]
        # Only the base requests looked up: one miss, then one hit.
        assert engine.prefix_stats['misses'] == 1
        assert engine.prefix_stats['hits'] == 1
    finally:
        engine.stop()
    dedicated = _engine(reference, num_slots=1, **kw)
    try:
        dedicated.load_adapter('a', _random_adapter(dedicated.cfg, 1))
        assert dedicated.generate(prompt, max_new_tokens=6, adapter='a',
                                  timeout=120)[0] == alone['a']
    finally:
        dedicated.stop()


def test_wedge_recovery_keeps_the_slot_cache(reference, baselines):
    """At async depth 1 a wedged decode fails its request with
    EngineWedgedError; the successor serves the untouched tokens over the
    same slot cache."""
    engine = _engine(reference, num_slots=2, async_depth=1,
                     watchdog_timeout=_WATCHDOG)
    cache = engine._k_pool  # pylint: disable=protected-access
    try:
        assert _generate(engine, _PROMPT, max_new_tokens=12) == \
            baselines[''][:12]
        fault_injection.arm('engine.decode', 'wedge')
        try:
            future = engine.submit(_PROMPT, max_new_tokens=12)
            with pytest.raises(exceptions.EngineWedgedError):
                future.result(timeout=_WATCHDOG * 10 + 5)
        finally:
            fault_injection.disarm_all()
        deadline = time.monotonic() + 30
        while engine.watchdog_stats['stale_exits'] < 1:
            assert time.monotonic() < deadline, 'stale thread did not exit'
            time.sleep(0.01)
        assert _generate(engine, _PROMPT, max_new_tokens=12) == \
            baselines[''][:12]
        assert engine._k_pool is cache  # pylint: disable=protected-access
        assert engine.watchdog_stats['recoveries'] == 1
    finally:
        fault_injection.disarm_all()
        engine.stop()


@pytest.mark.parametrize('layout', ['contiguous', 'paged'])
@pytest.mark.parametrize('quant', ['', 'int8'], ids=['float', 'int8'])
def test_memory_footprint(reference, layout, quant):
    engine = _engine(reference, num_slots=2, kv_quant=quant or None,
                     paged_block_size=8 if layout == 'paged' else 0)
    cfg = engine.cfg
    weight = sum(p.numel() * p.element_size()
                 for p in engine.model.parameters())
    rows = (2 * cfg.max_seq_len if layout == 'contiguous'
            else cfg.paged_num_blocks * 8)
    per_token = cfg.num_kv_heads * cfg.head_dim * (1 if quant else 4)
    scales = cfg.num_kv_heads * 4 if quant else 0
    kv = 2 * cfg.num_layers * rows * (per_token + scales)
    assert engine.memory_footprint() == {
        'tp': 1, 'weight_bytes': weight, 'weight_bytes_per_device': weight,
        'kv_bytes': kv, 'kv_bytes_per_device': kv,
        'total_bytes': weight + kv, 'total_bytes_per_device': weight + kv}
    engine.stop()


def test_measure_ttft(reference):
    """The reference's test_ttft_measurement, with more requests than
    slots: one TTFT each, or with return_stats each request's stats."""
    engine = _engine(reference, num_slots=2)
    try:
        ttfts = engine.measure_ttft(4, [1, 2, 3], max_new_tokens=4)
        stats = engine.measure_ttft(3, [1, 2, 3], max_new_tokens=2,
                                    return_stats=True)
    finally:
        engine.stop()
    assert len(ttfts) == 4 and all(t > 0 for t in ttfts)
    assert len(stats) == 3
    assert all(st['new_tokens'] == 2 and 0 < st['ttft_s'] <= st['total_s']
               for st in stats)


def test_refusals_keep_the_references_messages(reference, tmp_path):
    with pytest.raises(ValueError, match="tier='prefill' requires "
                       'paged_block_size and prefix_cache'):
        _engine(reference, tier='prefill', prefix_cache=4)
    engine = _engine(reference, num_slots=1, prefix_cache=4)
    try:
        stats = engine.export_prefixes(str(tmp_path / 'a.skypfx'))
        assert stats['reason'] == ('prefix export requires '
                                   'paged_block_size and prefix_cache')
        for call, what in (
                (lambda: engine.import_prefixes(str(tmp_path / 'a')),
                 'prefix import'),
                (lambda: engine.prefill_prefix([1, 2, 3]),
                 'prefill_prefix'),
                (lambda: engine.export_prefix_chunks([1, 2, 3], 's'),
                 'export_prefix_chunks'),
                (lambda: engine.ingest_chunk(b'x'), 'KV ingest')):
            with pytest.raises(ValueError,
                               match=f'^{what} requires paged_block_size '
                                     'and prefix_cache$'):
                call()
        assert engine.kv_block_bytes() == 0
    finally:
        engine.stop()


# ---------------- the server ----------------


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def test_server_serves_the_contiguous_layout(reference, tmp_path):
    """--paged-block-size 0: /generate (plain and SSE) gives the
    contiguous engine's tokens, which are the JAX engine's; the prefix
    store stays off without paging, and the prefill tier is refused."""
    server = InferenceServer(
        _cfg(), num_slots=3, paged_block_size=0, prefix_cache=4,
        prefix_store=str(tmp_path / 'store'),
        params=params_from_jax(reference['params'], _cfg()), device='cpu')
    assert server.engine.paged_block_size == 0
    assert server.engine.decode_kernel == 'xla'
    assert server.prewarm_from_store() is None
    server.warmup()
    http = BackgroundServer(server)
    try:
        prompts = reference['first'][:3]
        status, body = _post(http.url + '/generate',
                             {'prompt_ids': prompts,
                              'max_new_tokens': _MAX_NEW})
        assert status == 200
        assert json.loads(body)['token_ids'] == reference['outputs'][:3]
        status, raw = _post(http.url + '/generate',
                            {'prompt_ids': [prompts[1]],
                             'max_new_tokens': _MAX_NEW, 'stream': True})
        events = [json.loads(line[len('data: '):])
                  for line in raw.decode().splitlines()
                  if line.startswith('data: ')]
        assert [e['token_id'] for e in events if 'token_id' in e] == \
            reference['outputs'][1]
        assert events[-1]['done']
    finally:
        http.close()
        server.engine.drain(timeout=60)
    assert not server._can_export_prefixes()  # pylint: disable=protected-access
    with pytest.raises(ValueError, match='requires paged_block_size'):
        InferenceServer(_cfg(), paged_block_size=0, prefix_cache=4,
                        tier='prefill', device='cpu')
