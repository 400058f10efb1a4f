"""The port's SLO tiers on the CPU: serve/tenancy/scheduling.py (its own
copy of the reference's), the engine's tier-ordered queue, batch-slot
preemption and deadline-aware admission in
skypilot_tpu_torch/models/inference.py, and the server's priority field,
429 shed, /health tier_load and POST /preempt.

  - TierQueue: the reference's TestTierQueue (tests/test_multitenant.py),
    run on the port's copy and on the reference's alike;
  - a preempted batch request's tokens equal its uninterrupted run's and
    the JAX engine's, at async depth 0 and 1 and through the prefix cache
    (tests/test_multitenant.py
    `test_batch_preemption_continuation_bit_identity`), also when the
    starvation floor readmits it into the slot it just left in the same
    tick, with dispatches in flight;
  - interactive overtakes a batch backlog; an unmeetable deadline sheds
    at submit, and as a 429 with Retry-After on /generate and
    /v1/completions;
  - /preempt: 400 on a bad deadline_s, drained, then already-draining;
    /health turns 503 + Retry-After; /health's tier_load once tiered
    traffic exists; the tier and preemption metrics.
"""
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import pytest

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.inference import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.serve.tenancy import scheduling as jax_scheduling
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.serve import tenancy
from skypilot_tpu_torch.serve.tenancy import scheduling
from skypilot_tpu_torch.serve.server import BackgroundServer, InferenceServer

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
BATCH_PROMPT = list(range(1, 21))   # past the prefix cache's 16-token floor
INT_PROMPT = [5, 6, 7]
STD_PROMPT = [9, 8, 7, 6]
IMPLS = {'port': scheduling, 'reference': jax_scheduling}


def _tcfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


# ------------------------------------------------------------ TierQueue

class _FakeReq:

    def __init__(self, tier, tag):
        self.tier = tier
        self.tag = tag


@pytest.mark.parametrize('impl', sorted(IMPLS))
def test_tier_order_fifo_within(impl):
    q = IMPLS[impl].TierQueue(floor=100)
    for tag, tier in enumerate(['batch', 'standard', 'interactive',
                                'standard', 'interactive']):
        q.put(_FakeReq(tier, tag))
    assert [q.get_nowait().tag for _ in range(5)] == [2, 4, 1, 3, 0]


@pytest.mark.parametrize('impl', sorted(IMPLS))
def test_starvation_floor_is_deterministic(impl):
    q = IMPLS[impl].TierQueue(floor=2)
    q.put(_FakeReq('batch', 'b0'))
    for i in range(4):
        q.put(_FakeReq('interactive', f'i{i}'))
    assert [q.get_nowait().tag for _ in range(4)] == ['i0', 'i1', 'b0',
                                                      'i2']


@pytest.mark.parametrize('impl', sorted(IMPLS))
def test_requeue_front_is_head_of_tier(impl):
    q = IMPLS[impl].TierQueue(floor=100)
    q.put(_FakeReq('batch', 'b0'))
    q.put(_FakeReq('batch', 'b1'))
    q.requeue_front(_FakeReq('batch', 'pre'))
    assert q.get_nowait().tag == 'pre'
    assert q.qsize() == 2


@pytest.mark.parametrize('impl', sorted(IMPLS))
def test_depths_and_header_round_trip(impl):
    mod = IMPLS[impl]
    q = mod.TierQueue()
    for tag, tier in enumerate(['batch', 'interactive', 'standard']):
        q.put(_FakeReq(tier, tag))
    depths = q.tier_depths()
    assert depths == {'interactive': 1, 'standard': 1, 'batch': 1}
    assert [q.depth_at_or_above(t) for t in mod.TIERS] == [1, 2, 3]
    header = mod.render_tier_load_header(depths)
    assert mod.parse_tier_load_header(header) == depths
    assert mod.parse_tier_load_header('garbage') is None
    assert mod.parse_tier_load_header('evil=1') is None


@pytest.mark.parametrize('impl', sorted(IMPLS))
def test_validate_tier_and_projected_wait(impl, monkeypatch):
    mod = IMPLS[impl]
    assert mod.validate_tier(None) == 'standard'
    assert mod.validate_tier('batch') == 'batch'
    with pytest.raises(ValueError):
        mod.validate_tier('platinum')
    assert mod.projected_wait(9, 4, 0.5) == 1.5
    monkeypatch.setenv('SKYTPU_TIER_STARVATION_FLOOR', '3')
    assert mod.starvation_floor() == 3
    monkeypatch.setenv('SKYTPU_TIER_STARVATION_FLOOR', 'x')
    assert mod.starvation_floor() == 8


def test_port_queue_sequences_equal_the_reference():
    """A seeded stream of puts, gets and requeues over all three tiers
    gives the same pop order from both queues."""
    import random
    rng = random.Random(0)
    queues = [mod.TierQueue(floor=3) for mod in (scheduling, jax_scheduling)]
    orders = [[], []]
    for step in range(300):
        op = rng.random()
        tier = rng.choice(tenancy.TIERS)
        for q, order in zip(queues, orders):
            if op < 0.5:
                q.put(_FakeReq(tier, step))
            elif op < 0.9 and not q.empty():
                order.append(q.get_nowait().tag)
            elif op >= 0.9:
                q.requeue_front(_FakeReq('batch', -step))
    assert orders[0] == orders[1] and len(orders[0]) > 50


# ---------------------------------------------------- engine preemption

@pytest.fixture(scope='module')
def reference():
    """The JAX engine's uninterrupted tokens and its weights."""
    engine = JaxEngine(dataclasses.replace(jax_get_config('test-tiny'),
                                           **_KW), num_slots=1)
    try:
        return {'params': jax.device_get(engine.params),
                'batch': engine.generate(BATCH_PROMPT,
                                         max_new_tokens=24)[0],
                'interactive': engine.generate(INT_PROMPT,
                                               max_new_tokens=4)[0],
                'standard': engine.generate(STD_PROMPT,
                                            max_new_tokens=6)[0]}
    finally:
        engine.stop()


def _engine(reference, **kw):
    kw.setdefault('num_slots', 1)
    kw.setdefault('paged_block_size', 8)
    kw.setdefault('prefill_chunk', 16)
    return ContinuousBatchingEngine(
        _tcfg(), params=params_from_jax(reference['params'], _tcfg()),
        device='cpu', **kw)


@pytest.mark.parametrize('kw', [dict(async_depth=0), dict(async_depth=1),
                                dict(async_depth=1, prefix_cache=4),
                                dict(async_depth=1, speculative=3)],
                         ids=['depth0', 'depth1', 'depth1-prefix',
                              'depth1-spec'])
def test_batch_preemption_continuation_bit_identity(reference, kw):
    """A batch request preempted by an interactive arrival re-queues and
    continues: its tokens equal the uninterrupted run's."""
    engine = _engine(reference, **kw)
    try:
        started = threading.Event()
        fut_batch = engine.submit(BATCH_PROMPT, max_new_tokens=24,
                                  priority='batch',
                                  on_token=lambda _t: started.set())
        assert started.wait(timeout=60)
        fut_int = engine.submit(INT_PROMPT, max_new_tokens=4,
                                priority='interactive')
        assert fut_int.result(timeout=120)[0] == reference['interactive']
        out, stats = fut_batch.result(timeout=120)
        assert out == reference['batch']
        assert stats['new_tokens'] == 24
        assert engine.tenancy_stats['slot_preempts'] >= 1
        deadline = time.monotonic() + 30
        while engine._busy() and time.monotonic() < deadline:  # pylint: disable=protected-access
            time.sleep(0.01)
        if kw.get('prefix_cache'):
            # The continuation re-admitted through the cache.
            assert engine.prefix_stats['hits'] >= 1
            for _ in range(len(engine._prefix_entries)):  # pylint: disable=protected-access
                _key, blocks = engine._prefix_entries.pop_lru()  # pylint: disable=protected-access
                engine._pool.release(blocks)  # pylint: disable=protected-access
        engine._pool.check()  # pylint: disable=protected-access
        assert engine._pool.used == 1  # pylint: disable=protected-access
    finally:
        engine.stop()


@pytest.mark.parametrize('async_depth', [1, 2])
def test_preempted_request_readmitted_same_tick(reference, monkeypatch,
                                                async_depth):
    """The starvation floor can hand a just-preempted batch request its
    own slot back in the same tick. Its pipelined columns must land
    before its context is folded, never into the re-prefilling request.

    Batch `a` decodes in slot 0 and standard `x` in slot 1 while batch
    `c` waits (one skip, so the floor of 1 is reached). Interactive `i`
    arrives as `x`'s last column is in flight: it preempts `a`, the
    floor readmits `a` at once, and `x`'s finish frees a slot for `i`,
    so `a` is not preempted again and its own prefill emits next."""
    monkeypatch.setenv('SKYTPU_TIER_STARVATION_FLOOR', '1')
    engine = _engine(reference, num_slots=2, async_depth=async_depth)
    try:
        futs = {}
        x_tokens = []

        def on_a(_token):
            # On the engine thread: `c` and `x` queue together.
            if 'c' not in futs:
                futs['c'] = engine.submit(BATCH_PROMPT, max_new_tokens=24,
                                          priority='batch')
                futs['x'] = engine.submit(STD_PROMPT, max_new_tokens=6,
                                          on_token=on_x)

        def on_x(token):
            x_tokens.append(token)
            if len(x_tokens) == 6 - async_depth:
                futs['i'] = engine.submit(INT_PROMPT, max_new_tokens=4,
                                          priority='interactive')

        futs['a'] = engine.submit(BATCH_PROMPT, max_new_tokens=24,
                                  priority='batch', on_token=on_a)
        assert futs['a'].result(timeout=120)[0] == reference['batch']
        assert futs['c'].result(timeout=120)[0] == reference['batch']
        assert futs['x'].result(timeout=120)[0] == reference['standard']
        assert futs['i'].result(timeout=120)[0] == reference['interactive']
        assert engine.tenancy_stats['slot_preempts'] == 1
        deadline = time.monotonic() + 30
        while engine._busy() and time.monotonic() < deadline:  # pylint: disable=protected-access
            time.sleep(0.01)
        engine._pool.check()  # pylint: disable=protected-access
        assert engine._pool.used == 1  # pylint: disable=protected-access
    finally:
        engine.stop()


def test_interactive_overtakes_batch_backlog(reference):
    engine = _engine(reference)
    try:
        order, lock = [], threading.Lock()

        def track(tag):
            def done(_fut):
                with lock:
                    order.append(tag)
            return done

        futures = []
        for i in range(4):
            fut = engine.submit([1, 2, 3 + i], max_new_tokens=12,
                                priority='batch')
            fut.add_done_callback(track(f'b{i}'))
            futures.append(fut)
        fut = engine.submit([9, 9, 9], max_new_tokens=4,
                            priority='interactive')
        fut.add_done_callback(track('int'))
        futures.append(fut)
        for fut in futures:
            fut.result(timeout=120)
        assert order.index('int') < len(order) - 1
        assert engine.tier_load() == {'interactive': 0, 'standard': 0,
                                      'batch': 0}
        assert engine.queue_load() == 0
    finally:
        engine.stop()


def test_deadline_unmeetable_sheds_at_submit(reference):
    engine = _engine(reference)
    try:
        engine.ttft_estimate = 5.0
        for i in range(4):
            engine.submit([1, 2, 3 + i], max_new_tokens=16,
                          priority='interactive')
        with pytest.raises(exceptions.TierDeadlineUnmeetableError):
            engine.submit([7, 7, 7], max_new_tokens=4,
                          priority='interactive',
                          deadline=time.time() + 0.25)
        assert engine.tenancy_stats['deadline_sheds'] == 1
        assert issubclass(exceptions.TierDeadlineUnmeetableError,
                          exceptions.EngineOverloadedError)
        with pytest.raises(ValueError):
            engine.submit([1], priority='gold')
    finally:
        engine.stop()


def test_ttft_estimate_follows_first_tokens(reference):
    engine = _engine(reference)
    try:
        assert engine.ttft_estimate is None
        engine.generate([1, 2, 3], max_new_tokens=2)
        first = engine.ttft_estimate
        assert first is not None and first > 0
        engine.generate([4, 5, 6], max_new_tokens=2)
        assert engine.ttft_estimate != first
    finally:
        engine.stop()


# ----------------------------------------------------------- the server

def _call(url, method='GET', body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


@pytest.fixture()
def live(reference):
    server = InferenceServer(
        _tcfg(), num_slots=1, paged_block_size=8,
        params=params_from_jax(reference['params'], _tcfg()), device='cpu')
    server.warmup()
    http = BackgroundServer(server)
    try:
        yield server, http.url
    finally:
        http.close()
        server.engine.drain(timeout=60)


def test_deadline_shed_maps_to_429(live):
    server, url = live
    engine = server.engine
    engine.ttft_estimate = 30.0
    # The engine thread is held while the routes are called, so the four
    # requests stay queued ahead of them however the threads are
    # scheduled.
    held, go = threading.Event(), threading.Event()
    holder = threading.Thread(target=lambda: engine._run_in_tick(  # pylint: disable=protected-access
        lambda: (held.set(), go.wait(60)), timeout=120))
    holder.start()
    assert held.wait(60)
    futures = [engine.submit([1, 2, 3 + i], max_new_tokens=16,
                             priority='interactive') for i in range(4)]
    try:
        body = {'max_new_tokens': 4, 'priority': 'interactive',
                'timeout_s': 0.5}
        for route, payload in (
                ('/generate', {'prompt_ids': [[9, 9, 9]], **body}),
                ('/generate', {'prompt_ids': [[9, 9, 9]], 'stream': True,
                               **body}),
                ('/v1/completions', {'prompt': [9, 9, 9], 'max_tokens': 4,
                                     'priority': 'interactive',
                                     'timeout_s': 0.5})):
            status, headers, _ = _call(url + route, 'POST', payload)
            assert status == 429, route
            assert headers['Retry-After'], route
        assert engine.tenancy_stats['deadline_sheds'] == 3
    finally:
        go.set()
        holder.join(60)
        for fut in futures:
            fut.cancel()


def test_health_tier_load_and_tier_metrics(live):
    server, url = live
    status, _, body = _call(url + '/health')
    assert (status, body) == (200, {'status': 'ok', 'tier': 'monolithic'})
    status, _, body = _call(url + '/generate', 'POST', {
        'prompt_ids': [[1, 2, 3]], 'max_new_tokens': 4,
        'priority': 'interactive'})
    assert status == 200
    assert body['token_ids'][0] == _call(url + '/generate', 'POST', {
        'prompt_ids': [[1, 2, 3]], 'max_new_tokens': 4})[2]['token_ids'][0]
    status, _, body = _call(url + '/health')
    assert status == 200
    assert body['tier_load'] == {'interactive': 0, 'standard': 0,
                                 'batch': 0}
    assert _call(url + '/generate', 'POST', {
        'prompt_ids': [[1, 2, 3]], 'priority': 'gold'})[0] == 400
    with urllib.request.urlopen(url + '/metrics', timeout=30) as resp:
        text = resp.read().decode()
    assert 'skytpu_engine_tier_requests_total{tier="interactive"}' in text
    assert 'skytpu_engine_tier_ttft_seconds_count{tier="interactive"}' \
        in text
    assert server.engine.tiers_active


def test_preempt_drains_then_refuses(live):
    server, url = live
    for bad in (0, -1, 'soon', [1]):
        assert _call(url + '/preempt', 'POST', {'deadline_s': bad})[0] == \
            400, bad
    assert _call(url + '/preempt', 'POST', [1])[0] == 400
    started = threading.Event()
    future = server.engine.submit([1, 2, 3], max_new_tokens=40,
                                  on_token=lambda _t: started.set())
    assert started.wait(timeout=60)
    status, _, body = _call(url + '/preempt', 'POST', {'deadline_s': 30})
    assert (status, body) == (200, {'status': 'drained', 'drained': True,
                                    'export': None})
    # The in-flight request finished before the drain answered.
    assert len(future.result(timeout=1)[0]) == 40
    assert _call(url + '/preempt', 'POST', {})[2] == {
        'status': 'already-draining'}
    status, headers, body = _call(url + '/health')
    assert (status, body) == (503, {'status': 'draining'})
    assert headers['Retry-After'] == '5'
    status, headers, _ = _call(url + '/generate', 'POST', {
        'prompt_ids': [[1, 2]], 'max_new_tokens': 2})
    assert status == 503 and headers['Retry-After']
    with urllib.request.urlopen(url + '/metrics', timeout=30) as resp:
        text = resp.read().decode()
    assert 'skytpu_server_preempt_notices_total' in text
    assert 'skytpu_server_draining 1' in text
