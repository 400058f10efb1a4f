"""Multi-tenant serving in the port against the JAX package: resident
multi-LoRA adapters, mixed-adapter batches, int8 KV, the adapter pool and
its HTTP surface.

- The port's engine (test-tiny, fp32, paged 8, max_adapters 3, rank 4,
  alpha 8, targets 'q,v', with and without int8 KV): one mixed batch of
  base + 3 adapters gives each request the greedy tokens of the JAX
  oracles of tests/test_multitenant.py (`references`: a plain base engine
  and one dedicated LoRA engine per adapter) and of the JAX multi-LoRA
  engine in the same configuration. All seven targets: the same against a
  dedicated JAX LoRA engine.
- The port's AdapterPool against the reference's under the same operation
  sequences (the reference's TestAdapterPool scenarios); npz archives
  cross-read both ways.
- Error paths on the engine: unknown adapter, unload while pinned, pool
  exhaustion, LRU eviction and reload giving the same tokens, a device
  write that fails leaving residency consistent, construction refusals.
- The HTTP routes and their status codes.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from skypilot_tpu import exceptions as jax_exceptions
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.inference import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.serve import tenancy as jax_tenancy
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.serve import tenancy
from skypilot_tpu_torch.serve.server import BackgroundServer, InferenceServer

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
LORA_KW = dict(adapter_rank=4, adapter_alpha=8.0, adapter_targets='q,v')
ALL_TARGETS = 'q,k,v,o,gate,up,down'
PROMPT = list(range(1, 11))


def _jcfg(**kw):
    return dataclasses.replace(jax_get_config('test-tiny'), **_KW, **kw)


def _tcfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


def _random_trees(targets, names, seed0):
    """Random adapter trees in the reference's models/lora layout (the
    lora leaves of a LoRA model's init, redrawn from jax.random)."""
    lora_cfg = _jcfg(lora_rank=4, lora_alpha=8.0, lora_targets=targets,
                     decode=True)
    shapes = nn.unbox(jax.eval_shape(lambda: JaxTransformer(lora_cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
        jnp.zeros((1, 8), jnp.int32))))
    template = jax_tenancy.adapter_tree_from_lora_params(shapes['params'])
    leaves, treedef = jax.tree.flatten(template)

    def rand(seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
        return jax.tree.unflatten(treedef, [
            np.asarray(jax.random.normal(k, leaf.shape, jnp.float32)) * 0.05
            for k, leaf in zip(keys, leaves)])

    return {name: rand(seed0 + i) for i, name in enumerate(names)}


def _overlay(params, sub):
    out = dict(params)
    for key, value in sub.items():
        out[key] = (_overlay(params[key], value)
                    if isinstance(value, dict) else value)
    return out


def _dedicated(base_params, targets, tree):
    """Greedy tokens of a dedicated single-adapter JAX engine."""
    lora_cfg = _jcfg(lora_rank=4, lora_alpha=8.0, lora_targets=targets)
    engine = JaxEngine(lora_cfg, params=_overlay(base_params, tree),
                       num_slots=4)
    try:
        return engine.generate(PROMPT, max_new_tokens=8)[0]
    finally:
        engine.stop()


@pytest.fixture(scope='module')
def adapter_trees():
    return _random_trees('q,v', [f'ad{i}' for i in range(3)], 100)


@pytest.fixture(scope='module')
def references(adapter_trees):
    """The reference's oracles: a plain base engine and one dedicated
    LoRA engine per adapter (tests/test_multitenant.py `references`)."""
    plain = JaxEngine(_jcfg(), num_slots=4)
    base_params = jax.device_get(plain.params)
    refs = {'base': plain.generate(PROMPT, max_new_tokens=8)[0]}
    plain.stop()
    for name, tree in adapter_trees.items():
        refs[name] = _dedicated(base_params, 'q,v', tree)
    return base_params, refs


def _port_engine(base_params, **kw):
    cfg = _tcfg()
    kw.setdefault('num_slots', 4)
    kw.setdefault('paged_block_size', 8)
    return ContinuousBatchingEngine(cfg, params=params_from_jax(base_params,
                                                                cfg),
                                    device='cpu', **kw)


def _mixed(engine, trees):
    for name, tree in trees.items():
        engine.load_adapter(name, tree)
    futures = [engine.submit(PROMPT, max_new_tokens=8)]
    futures += [engine.submit(PROMPT, max_new_tokens=8, adapter=name)
                for name in trees]
    return [f.result(timeout=120)[0] for f in futures]


# ------------------------------------------------ mixed-adapter batches

@pytest.mark.parametrize('kv_quant', [None, 'int8'], ids=['paged',
                                                          'paged_int8'])
def test_mixed_batch_equals_dedicated_and_multi_lora_engines(
        kv_quant, adapter_trees, references):
    base_params, refs = references
    jax_engine = JaxEngine(_jcfg(), params=base_params, num_slots=4,
                           max_adapters=3, paged_block_size=8,
                           kv_quant=kv_quant, **LORA_KW)
    try:
        jax_out = _mixed(jax_engine, adapter_trees)
    finally:
        jax_engine.stop()
    engine = _port_engine(base_params, max_adapters=3, kv_quant=kv_quant,
                          **LORA_KW)
    try:
        outs = _mixed(engine, adapter_trees)
        assert engine.tick_stats['dispatches'] < 4 * 8   # shared steps
    finally:
        assert engine.drain(timeout=60)
    assert outs == jax_out
    assert outs[0] == refs['base']
    for i, name in enumerate(adapter_trees):
        assert outs[1 + i] == refs[name], name
    assert len({tuple(o) for o in outs}) > 1      # adapters matter
    engine._pool.check()  # pylint: disable=protected-access
    assert all(a['refs'] == 0 for a in engine.adapters_info()['adapters'])


def test_all_seven_targets_equal_dedicated_engine(references):
    base_params, refs = references
    tree = _random_trees(ALL_TARGETS, ['all'], 300)['all']
    oracle = _dedicated(base_params, ALL_TARGETS, tree)
    engine = _port_engine(base_params, max_adapters=1, adapter_rank=4,
                          adapter_alpha=8.0, adapter_targets=ALL_TARGETS,
                          kv_quant='int8')
    try:
        outs = _mixed(engine, {'all': tree})
    finally:
        engine.stop()
    assert outs == [refs['base'], oracle]
    assert oracle != refs['base']


# ---------------------------------------------------------- adapter pool

def _lru_eviction_order(mod, errors):
    pool = mod.AdapterPool(2)
    for i in range(3):
        pool.register(f'a{i}', {'w': np.zeros(1)})
    trace = [pool.acquire_for_load('a0', pin=False)[::2],
             pool.acquire_for_load('a1', pin=False)[::2],
             pool.acquire_for_load('a0', pin=False)[::2],
             pool.acquire_for_load('a2', pin=False)[::2]]
    return trace + [pool.resident_names(), dict(pool.stats)]


def _refcount_pin_blocks_eviction(mod, errors):
    pool = mod.AdapterPool(2)
    for i in range(3):
        pool.register(f'a{i}', {'w': np.zeros(1)})
    pool.acquire_for_load('a0', pin=True)
    pool.acquire_for_load('a1', pin=True)
    trace = []
    try:
        pool.acquire_for_load('a2', pin=False)
    except errors.AdapterPoolExhaustedError as e:
        trace.append(('exhausted', isinstance(e,
                                              errors.EngineOverloadedError)))
    trace.append(pool.stats['exhausted'])
    pool.release('a0')
    trace.append(pool.acquire_for_load('a2', pin=False)[::2])
    return trace + [pool.info()]


def _pin_if_resident_fast_path(mod, errors):
    pool = mod.AdapterPool(2)
    pool.register('a0', {'w': np.zeros(1)})
    trace = [pool.pin_if_resident('a0')]
    pool.acquire_for_load('a0', pin=False)
    trace += [pool.pin_if_resident('a0'), pool.refcount('a0')]
    try:
        pool.pin_if_resident('nope')
    except errors.UnknownAdapterError:
        trace.append('unknown')
    return trace


def _unregister_refuses_while_pinned(mod, errors):
    pool = mod.AdapterPool(2)
    pool.register('a0', {'w': np.zeros(1)})
    pool.acquire_for_load('a0', pin=True)
    trace = []
    try:
        pool.unregister('a0')
    except errors.AdapterInUseError:
        trace.append('in use')
    pool.release('a0')
    pool.unregister('a0')
    try:
        pool.unregister('a0')
    except errors.UnknownAdapterError:
        trace.append('unknown')
    return trace + [pool.registered_names(), dict(pool.stats)]


def _fresh_keeps_registry_resets_residency(mod, errors):
    pool = mod.AdapterPool(2)
    for i in range(3):
        pool.register(f'a{i}', {'w': np.zeros(1)})
    pool.acquire_for_load('a0', pin=True)
    successor = pool.fresh()
    pool.release('a0')
    return [successor.registered_names(), successor.resident_names(),
            successor.refcount('a0'), pool.refcount('a0')]


def _abort_load_rolls_back(mod, errors):
    pool = mod.AdapterPool(1)
    for i in range(2):
        pool.register(f'a{i}', {'w': np.zeros(1)})
    pool.acquire_for_load('a0', pin=False)
    trace = [pool.acquire_for_load('a1', pin=True)[::2]]
    pool.abort_load('a1', pinned=True)
    return trace + [pool.resident_names(), pool.refcount('a1'), pool.info()]


def _name_validation(mod, errors):
    trace = []
    for name in ('ok-name_1.v2', 'bad name!', '', '-lead', 'x' * 65, 7):
        try:
            trace.append(mod.validate_adapter_name(name))
        except ValueError:
            trace.append('invalid')
    return trace


def _adapter_tree_extraction(mod, errors):
    params = {'embed': {'w': np.zeros(1)},
              'layers': {'q_proj': {'kernel': np.zeros(2),
                                    'lora_a': np.ones(2),
                                    'lora_b': np.zeros(2)}}}
    tree = mod.adapter_tree_from_lora_params(params)
    trace = [sorted(tree), sorted(tree['layers']['q_proj'])]
    try:
        mod.adapter_tree_from_lora_params({'embed': {}})
    except ValueError:
        trace.append('no lora leaves')
    return trace


_POOL_SCENARIOS = [_lru_eviction_order, _refcount_pin_blocks_eviction,
                   _pin_if_resident_fast_path,
                   _unregister_refuses_while_pinned,
                   _fresh_keeps_registry_resets_residency,
                   _abort_load_rolls_back, _name_validation,
                   _adapter_tree_extraction]


@pytest.mark.parametrize('scenario', _POOL_SCENARIOS,
                         ids=lambda f: f.__name__.strip('_'))
def test_adapter_pool_matches_reference(scenario):
    ours = scenario(tenancy, exceptions)
    ref = scenario(jax_tenancy, jax_exceptions)
    assert ours == ref


def test_exceptions_keep_the_reference_hierarchy():
    assert issubclass(exceptions.AdapterPoolExhaustedError,
                      exceptions.EngineOverloadedError)
    for name in ('AdapterPoolExhaustedError', 'UnknownAdapterError',
                 'AdapterInUseError'):
        ours, ref = getattr(exceptions, name), getattr(jax_exceptions, name)
        assert [c.__name__ for c in ours.__mro__] == [
            c.__name__ for c in ref.__mro__]


@pytest.mark.parametrize('writer,reader', [(tenancy, jax_tenancy),
                                           (jax_tenancy, tenancy)],
                         ids=['port_writes', 'reference_writes'])
def test_npz_archives_cross_read(tmp_path, adapter_trees, writer, reader):
    tree = adapter_trees['ad1']
    path = str(tmp_path / 'ad.npz')
    writer.save_adapter_npz(tree, path)
    loaded = reader.load_adapter_npz(path)
    assert jax.tree.structure(loaded) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- error paths

def test_unknown_adapter_and_poolless_engine(references):
    base_params, _ = references
    engine = _port_engine(base_params, num_slots=2)
    try:
        with pytest.raises(exceptions.UnknownAdapterError):
            engine.submit(PROMPT, adapter='nope')
        with pytest.raises(exceptions.UnknownAdapterError):
            engine.load_adapter('x', {})
        assert engine.adapters_info() == {'capacity': 0, 'resident': 0,
                                          'adapters': []}
    finally:
        engine.stop()
    engine = _port_engine(base_params, num_slots=2, max_adapters=2,
                          **LORA_KW)
    try:
        with pytest.raises(exceptions.UnknownAdapterError):
            engine.submit(PROMPT, adapter='unregistered')
        with pytest.raises(ValueError, match='adapter layout'):
            engine.load_adapter('bad', {'junk': np.zeros(3)})
        with pytest.raises(ValueError, match='invalid adapter name'):
            engine.load_adapter('bad name', {})
    finally:
        engine.stop()


def test_lru_eviction_reload_and_pins(adapter_trees, references):
    _, refs = references
    engine = _port_engine(references[0], num_slots=2, max_adapters=1,
                          **LORA_KW)
    try:
        engine.load_adapter('ad0', adapter_trees['ad0'])
        engine.load_adapter('ad1', adapter_trees['ad1'])   # evicts ad0
        pool = engine._adapter_pool  # pylint: disable=protected-access
        assert pool.resident_names() == ['ad1'] and \
            pool.stats['evictions'] == 1
        # ad0 reloads on demand at submit and serves the same tokens.
        assert engine.generate(PROMPT, max_new_tokens=8,
                               adapter='ad0')[0] == refs['ad0']
        assert pool.resident_names() == ['ad0']
        # A slow request pins ad1: unload refuses, a load of another
        # adapter sheds retryably, and the pin drops at completion.
        started = threading.Event()
        future = engine.submit(PROMPT, max_new_tokens=30, adapter='ad1',
                               on_token=lambda _t: started.set())
        assert started.wait(timeout=60)
        with pytest.raises(exceptions.AdapterInUseError):
            engine.unload_adapter('ad1')
        with pytest.raises(exceptions.AdapterPoolExhaustedError):
            engine.load_adapter('ad2', adapter_trees['ad2'])
        with pytest.raises(exceptions.AdapterPoolExhaustedError):
            engine.submit(PROMPT, adapter='ad0')
        assert engine.tenancy_stats['adapter_sheds'] == 2
        out, _ = future.result(timeout=120)
        assert out[:8] == refs['ad1']
        assert pool.refcount('ad1') == 0
        engine.unload_adapter('ad1')
        # The shed load still registered ad2 (it loads on demand later).
        assert pool.registered_names() == ['ad0', 'ad2']
        with pytest.raises(exceptions.UnknownAdapterError):
            engine.unload_adapter('ad1')
    finally:
        engine.stop()


def test_failed_device_write_rolls_back_residency(adapter_trees,
                                                  references, monkeypatch):
    _, refs = references
    engine = _port_engine(references[0], num_slots=2, max_adapters=1,
                          **LORA_KW)
    try:
        engine.load_adapter('ad0', adapter_trees['ad0'])
        pool = engine._adapter_pool  # pylint: disable=protected-access
        real = engine._write_adapter  # pylint: disable=protected-access

        def broken(slot, host):
            raise RuntimeError('device write failed')

        monkeypatch.setattr(engine, '_write_adapter', broken)
        with pytest.raises(RuntimeError, match='device write failed'):
            engine.load_adapter('ad1', adapter_trees['ad1'])
        # ad1 never reads resident and holds no pin; ad0 was evicted.
        assert pool.resident_names() == [] and pool.refcount('ad1') == 0
        monkeypatch.setattr(engine, '_write_adapter', real)
        assert engine.generate(PROMPT, max_new_tokens=8,
                               adapter='ad1')[0] == refs['ad1']
    finally:
        engine.stop()


def test_construction_refusals(references):
    base_params, _ = references
    with pytest.raises(ValueError, match='adapter_rank'):
        _port_engine(base_params, max_adapters=2)
    with pytest.raises(ValueError, match='lora_targets token'):
        _port_engine(base_params, max_adapters=2, adapter_rank=4,
                     adapter_targets='q,bogus')
    with pytest.raises(ValueError, match='kv_quant'):
        _port_engine(base_params, kv_quant='fp8')


# ------------------------------------------------------------------ HTTP

def _call(url, method='GET', body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b'{}')


def test_http_adapter_routes(tmp_path, adapter_trees, references):
    base_params, refs = references
    cfg = _tcfg()
    server = InferenceServer(cfg, num_slots=2, paged_block_size=8,
                             params=params_from_jax(base_params, cfg),
                             max_adapters=1, kv_quant='int8', device='cpu',
                             **LORA_KW)
    server.warmup()
    http = BackgroundServer(server)
    url = http.url
    try:
        for name in ('ad0', 'ad1'):
            jax_tenancy.save_adapter_npz(adapter_trees[name],
                                         str(tmp_path / f'{name}.npz'))
        assert _call(url + '/adapters/load', 'POST',
                     {'name': 'ad0', 'path': str(tmp_path / 'ad0.npz')}) == \
            (200, {'ok': True, 'name': 'ad0', 'slot': 1})
        assert _call(url + '/health') == (
            200, {'status': 'ok', 'tier': 'monolithic',
                  'adapters': {'capacity': 1, 'resident': 1},
                  'tier_load': {'interactive': 0, 'standard': 0,
                                'batch': 0}})
        status, body = _call(url + '/adapters')
        assert status == 200 and body['adapters'] == [
            {'name': 'ad0', 'resident': True, 'slot': 1, 'refs': 0}]
        status, body = _call(url + '/generate', 'POST',
                             {'prompt_ids': [PROMPT], 'max_new_tokens': 8,
                              'adapter': 'ad0'})
        assert status == 200 and body['token_ids'] == [refs['ad0']]
        for bad in ({'prompt_ids': [PROMPT], 'adapter': 'nope'},
                    {'prompt_ids': [PROMPT], 'adapter': 3},
                    {'prompt_ids': [PROMPT], 'priority': 'gold'}):
            assert _call(url + '/generate', 'POST', bad)[0] == 400, bad
        assert _call(url + '/adapters/load', 'POST', {'name': 'x'})[0] == 400
        assert _call(url + '/adapters/load', 'POST',
                     {'name': 'x', 'path': str(tmp_path / 'none.npz')}
                     )[0] == 400
        # ad0 pinned by an in-flight request: DELETE is 409, and loading
        # ad1 into the one slot sheds with 503 + Retry-After.
        engine = server.engine
        started = threading.Event()
        future = engine.submit(PROMPT, max_new_tokens=40, adapter='ad0',
                               on_token=lambda _t: started.set())
        assert started.wait(timeout=60)
        assert _call(url + '/adapters/ad0', 'DELETE')[0] == 409
        assert _call(url + '/adapters/load', 'POST',
                     {'name': 'ad1', 'path': str(tmp_path / 'ad1.npz')}
                     )[0] == 503
        future.result(timeout=120)
        assert _call(url + '/adapters/ad0', 'DELETE') == (
            200, {'ok': True, 'name': 'ad0'})
        assert _call(url + '/adapters/ad0', 'DELETE')[0] == 404
    finally:
        http.close()
        server.engine.drain(timeout=60)


def _engine_samples(url):
    from skypilot_tpu_torch.observability.exposition import (
        parse_prometheus_text)
    with urllib.request.urlopen(url + '/metrics', timeout=60) as resp:
        families = parse_prometheus_text(resp.read().decode())
    return {name: families[name]['samples'][(name, ())] for name in (
        'skytpu_engine_adapter_slots', 'skytpu_engine_adapter_resident',
        'skytpu_engine_adapter_loads_total',
        'skytpu_engine_adapter_evictions_total',
        'skytpu_engine_adapter_shed_total', 'skytpu_engine_decode_kernel',
        'skytpu_engine_decode_fused_bytes')}


def test_adapter_metrics_move_one_a_load_eviction_and_shed(tmp_path,
                                                          adapter_trees,
                                                          references):
    """The reference's multi-tenant families on a one-slot server's
    /metrics: a load, an eviction and a shed each move their counter by
    exactly one (the registry is process-wide: deltas), the pool gauges
    follow, and the decode-kernel gauges read the paged kernel's route."""
    base_params, _ = references
    cfg = _tcfg()
    server = InferenceServer(cfg, num_slots=2, paged_block_size=8,
                             params=params_from_jax(base_params, cfg),
                             max_adapters=1, device='cpu', **LORA_KW)
    server.warmup()
    http = BackgroundServer(server)
    url = http.url
    keys = ('skytpu_engine_adapter_loads_total',
            'skytpu_engine_adapter_evictions_total',
            'skytpu_engine_adapter_shed_total')

    def moved(before, after):
        return tuple(after[k] - before[k] for k in keys)

    try:
        for name in ('ad0', 'ad1'):
            jax_tenancy.save_adapter_npz(adapter_trees[name],
                                         str(tmp_path / f'{name}.npz'))
        start = _engine_samples(url)
        assert _call(url + '/adapters/load', 'POST',
                     {'name': 'ad0', 'path': str(tmp_path / 'ad0.npz')}
                     )[0] == 200
        loaded = _engine_samples(url)
        assert moved(start, loaded) == (1, 0, 0)
        assert loaded['skytpu_engine_adapter_slots'] == 1
        assert loaded['skytpu_engine_adapter_resident'] == 1
        assert _call(url + '/adapters/load', 'POST',
                     {'name': 'ad1', 'path': str(tmp_path / 'ad1.npz')}
                     )[0] == 200                       # evicts ad0
        evicted = _engine_samples(url)
        assert moved(loaded, evicted) == (1, 1, 0)
        assert evicted['skytpu_engine_adapter_resident'] == 1
        engine = server.engine
        started = threading.Event()
        future = engine.submit(PROMPT, max_new_tokens=40, adapter='ad1',
                               on_token=lambda _t: started.set())
        assert started.wait(timeout=60)
        assert _call(url + '/generate', 'POST',
                     {'prompt_ids': [PROMPT], 'adapter': 'ad0'})[0] == 503
        shed = _engine_samples(url)
        assert moved(evicted, shed) == (0, 0, 1)
        future.result(timeout=120)
        # The paged kernel's route (1, the reference's 'pallas'), and the
        # fused bytes of the last tick's pool by the reference's formula.
        end = _engine_samples(url)
        assert end['skytpu_engine_decode_kernel'] == 1
        assert end['skytpu_engine_decode_fused_bytes'] > 0
        assert engine.fused_bytes_per_step() == engine._pool.used * (  # pylint: disable=protected-access
            2 * 8 * cfg.num_kv_heads * cfg.head_dim * 4) * cfg.num_layers
    finally:
        http.close()
        server.engine.drain(timeout=60)


def test_fused_bytes_formula_is_the_references():
    from skypilot_tpu.ops.paged_attention import (
        fused_hbm_bytes_per_step as reference)
    from skypilot_tpu_torch.ops.paged_attention import (
        fused_hbm_bytes_per_step)
    for args in [(blocks, bs, kv, d, layers, size, quant)
                 for blocks in (0, 1, 37) for bs in (8, 16)
                 for kv in (1, 8) for d in (64, 128) for layers in (2, 32)
                 for size, quant in ((2, False), (4, False), (1, True))]:
        assert fused_hbm_bytes_per_step(*args) == reference(*args), args
