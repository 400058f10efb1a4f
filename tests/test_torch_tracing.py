"""The port's request tracing (skypilot_tpu_torch/observability/tracing.py)
against the reference's (tests/test_tracing.py, tests/test_chaos.py
`TestDisaggHandoff`), on test-tiny fp32 weights (a seeded JAX init carried
across with params_from_jax) on the CPU:

  - the two tracers speak one wire format: a header minted by either
    parses in the other, and `perfetto_events`, `render_trace_tree` and
    `render_flight_record` give the same output for the same spans;
  - with tracing off a whole generation never reads the tracer's clock
    nor records a span; enabled, an untraced request records nothing;
  - one request through the JAX engine and the port's under one root
    span: the same span names, parent links and attribute keys, and the
    same tokens; the TTFT histogram's exemplar is the request's trace id;
  - a handoff between two port servers (POST /kv/prefill, the chunk
    stream to /kv/ingest, then /generate on the decode tier) gives the
    span tree the same handoff gives between two reference servers; a
    port prefill tier pushing to a reference decode tier joins one trace;
  - GET /traces answers skytpu-traces/1 with the ring and the exemplars
    (?window_s= filters; 400 on a non-number), and an untraced GET
    records nothing;
  - a preemption notice records server.preempt_notice with its
    engine.preempt_export child and a flight record.
"""
import dataclasses
import json
import os
import urllib.error
import urllib.request

import jax
import pytest

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.observability import tracing as jax_tracing
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.observability import exposition
from skypilot_tpu_torch.observability import metrics as obs
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve.server import BackgroundServer, InferenceServer

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_ENGINE_KW = dict(num_slots=2, paged_block_size=8, prefill_chunk=8,
                  prefix_cache=6)
_NEW = 4
PROMPT = list(range(20, 44))        # 24 tokens: 3 blocks of 8


@pytest.fixture(autouse=True)
def _tracers_off():
    """Each test starts and ends with both tracers off and empty."""
    for mod in (tracing, jax_tracing):
        mod.disable()
        mod.reset()
    yield
    for mod in (tracing, jax_tracing):
        mod.disable()
        mod.reset()


def _cfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


@pytest.fixture(scope='module')
def reference():
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    engine = jax_inference.ContinuousBatchingEngine(jcfg, rng_seed=0,
                                                    **_ENGINE_KW)
    engine.generate([1, 2, 3], max_new_tokens=2, timeout=300)
    yield {'engine': engine, 'params': jax.device_get(engine.params),
           'jcfg': jcfg}
    engine.stop()


def _port_engine(reference, **kw):
    for key, value in _ENGINE_KW.items():
        kw.setdefault(key, value)
    return ContinuousBatchingEngine(
        _cfg(), params=params_from_jax(reference['params'], _cfg()),
        device='cpu', **kw)


def _root():
    """A root context neither tracer recorded (the caller's)."""
    return tracing.SpanContext(os.urandom(16).hex(), os.urandom(8).hex())


def _tree(spans, root_id):
    """The trace's shape: (name, parent's name or 'root', attribute keys)
    per span, sorted; parents outside the spans other than the root are
    named '?'."""
    names = {s['span_id']: s['name'] for s in spans}
    names[root_id] = 'root'
    return sorted((s['name'], names.get(s['parent_id'], '?'),
                   tuple(sorted(s['attrs']))) for s in spans)


# ---------------------------------------------------------------------
# one wire format, one rendering
# ---------------------------------------------------------------------


def test_headers_cross_parse():
    tracing.enable()
    jax_tracing.enable()
    with tracing.span('server.request') as ours:
        theirs = jax_tracing.parse_header(tracing.header_value(ours.ctx))
    assert (theirs.trace_id, theirs.span_id) == (ours.ctx.trace_id,
                                                 ours.ctx.span_id)
    with jax_tracing.span('lb.request') as ref:
        back = tracing.parse_header(jax_tracing.header_value(ref.ctx))
    assert (back.trace_id, back.span_id) == (ref.ctx.trace_id,
                                             ref.ctx.span_id)
    assert tracing.TRACE_HEADER == jax_tracing.TRACE_HEADER


@pytest.mark.parametrize('garbage', [
    None, '', 'nonsense', '00-xyz-abc-01',
    '00-' + 'a' * 31 + '-' + 'b' * 16 + '-01',
    '00-' + 'a' * 32 + '-' + 'g' * 16 + '-01',
    '00-' + 'a' * 32 + '-' + 'b' * 16,
])
def test_garbage_header_parses_to_none_in_both(garbage):
    assert tracing.parse_header(garbage) is None
    assert jax_tracing.parse_header(garbage) is None


def _sample_spans():
    tracing.enable()
    root = tracing.start_span('server.request', attrs={'route': '/x'})
    with tracing.activate(root.ctx):
        tracing.record_span('engine.queue_wait', tracing.now() - 0.002,
                            tracing.now(), attrs={'prompt_tokens': 3})
        with tracing.span('server.kv_push', attrs={'stream': 's'}):
            tracing.record_span('engine.ingest_chunk',
                                tracing.now() - 0.001, tracing.now(),
                                attrs={'seq': 0, 'ratio': 0.123456789})
    root.end(status=200)
    return tracing.snapshot()


def test_exports_and_renderings_equal_the_reference():
    spans = _sample_spans()
    assert len(spans) == 4
    assert tracing.perfetto_events(spans) == \
        jax_tracing.perfetto_events(spans)
    assert tracing.render_trace_tree(spans) == \
        jax_tracing.render_trace_tree(spans)
    assert tracing.render_trace_tree(spans, grep='kv_push') == \
        jax_tracing.render_trace_tree(spans, grep='kv_push')
    record = {'trigger': 'wedge_recovery', 'pid': 1, 'window_s': 30.0,
              'spans': spans, 'extra': {'why': 'x', 'generation': 1,
                                        'step_log': [[1, [0]],
                                                     ['prefill', [1]]]}}
    assert tracing.render_flight_record(record) == \
        jax_tracing.render_flight_record(record)


# ---------------------------------------------------------------------
# the disabled fast path
# ---------------------------------------------------------------------


def _poisoned(*_a, **_k):
    raise AssertionError('disabled-path tracing touched the tracer')


def test_disabled_generation_reads_no_tracer_clock(reference, monkeypatch):
    engine = _port_engine(reference)
    try:
        engine.generate([1, 2, 3], max_new_tokens=2, timeout=60)
        assert not tracing.enabled()
        monkeypatch.setattr(tracing, '_now', _poisoned)
        monkeypatch.setattr(tracing, '_record', _poisoned)
        out, stats = engine.generate(PROMPT, max_new_tokens=_NEW,
                                     timeout=60)
        assert len(out) == _NEW and stats['ttft_s'] >= 0
        assert tracing.span('engine.prefill') is tracing.NULL_SPAN
    finally:
        engine.stop()
    assert tracing.snapshot() == []


def test_untraced_requests_record_nothing_while_enabled(reference):
    engine = _port_engine(reference)
    try:
        tracing.enable()
        engine.generate([40, 41, 42], max_new_tokens=2, timeout=60)
        assert tracing.snapshot() == []
    finally:
        engine.stop()


# ---------------------------------------------------------------------
# engine spans against the reference's
# ---------------------------------------------------------------------


def _engine_trace(engine, mod, root):
    mod.enable()
    mod.reset()
    ctx = mod.SpanContext(root.trace_id, root.span_id)
    with mod.activate(ctx):
        out, stats = engine.generate(PROMPT, max_new_tokens=_NEW,
                                     timeout=300)
    spans = [s for s in mod.snapshot() if s['trace_id'] == root.trace_id]
    mod.disable()
    return out, stats, spans


def test_engine_spans_equal_the_reference(reference):
    engine = _port_engine(reference)
    try:
        root = _root()
        want, _, jax_spans = _engine_trace(reference['engine'],
                                           jax_tracing, root)
        out, stats, spans = _engine_trace(engine, tracing, root)
    finally:
        engine.stop()
    assert out == want
    assert _tree(spans, root.span_id) == _tree(jax_spans, root.span_id)
    assert {s['name'] for s in spans} == {
        'engine.queue_wait', 'engine.prefill', 'engine.decode'}
    by_name = {s['name']: s for s in spans}
    assert by_name['engine.prefill']['attrs']['prompt_tokens'] == 24
    assert by_name['engine.prefill']['attrs']['ttft_s'] == pytest.approx(
        stats['ttft_s'], rel=0.5, abs=0.01)
    assert by_name['engine.decode']['attrs']['new_tokens'] == _NEW
    for span in spans:
        assert span['dur_us'] >= 0


def test_ttft_exemplar_links_to_the_trace(reference, monkeypatch):
    engine = _port_engine(reference)
    # The latest traced sample wins, whatever ran before in the process.
    monkeypatch.setattr(obs, 'EXEMPLAR_WINDOW_S', -1.0)
    obs.enable()
    try:
        tracing.enable()
        root = tracing.start_span('server.request')
        with tracing.activate(root.ctx):
            engine.generate([30, 31, 32], max_new_tokens=2, timeout=60)
        root.end()
        exemplar = exposition.collect_exemplars()[
            'skytpu_engine_ttft_seconds']
        assert exemplar['trace_id'] == root.ctx.trace_id
        assert exemplar['value'] > 0
    finally:
        obs.disable()
        engine.stop()


# ---------------------------------------------------------------------
# the handoff over HTTP, port pair against reference pair
# ---------------------------------------------------------------------


def _jax_server(engine, tier):
    """A reference InferenceServer around a JAX engine (the idiom of its
    own tests: no model or tokenizer bring-up)."""
    from skypilot_tpu.serve.server import InferenceServer as JaxServer
    server = JaxServer.__new__(JaxServer)
    server.engine = engine
    server.tokenizer_kind = 'byte'
    server._hf_tokenizer = None  # pylint: disable=protected-access
    server.ready = True
    server.request_timeout = 0.0
    server.draining = False
    server.tier = tier
    return server


@pytest.fixture(scope='module')
def tiers(reference):
    """Live prefill and decode tiers: two port servers and two reference
    servers on the same weights."""
    port, jax_tiers, https = {}, {}, []
    for tier in ('prefill', 'decode'):
        server = InferenceServer(
            _cfg(), params=params_from_jax(reference['params'], _cfg()),
            tier=tier, device='cpu', **_ENGINE_KW)
        server.warmup()
        https.append(BackgroundServer(server))
        port[tier] = (server, https[-1].url)
        engine = jax_inference.ContinuousBatchingEngine(
            reference['jcfg'], rng_seed=0, tier=tier, **_ENGINE_KW)
        engine.generate([1, 2, 3], max_new_tokens=2, timeout=300)
        https.append(BackgroundServer(_jax_server(engine, tier)))
        jax_tiers[tier] = (engine, https[-1].url)
    yield {'port': port, 'jax': jax_tiers}
    for http in https:
        http.close()
    for server, _ in port.values():
        server.engine.stop()
    for engine, _ in jax_tiers.values():
        engine.stop()


def _post(url, body, header):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json',
                                          tracing.TRACE_HEADER: header})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _handoff(pre_url, dec_url, ids, stream_id, root):
    header = tracing.header_value(root)
    pushed = _post(pre_url + '/kv/prefill',
                   {'prompt_ids': ids, 'target': dec_url,
                    'stream_id': stream_id, 'chunk_blocks': 1}, header)
    assert pushed['ok'] and pushed['chunks'] == 3, pushed
    out = _post(dec_url + '/generate', {'prompt_ids': [ids],
                                        'max_new_tokens': _NEW}, header)
    return out['token_ids'][0]


def _traced(mod, root):
    return [s for s in mod.snapshot() if s['trace_id'] == root.trace_id]


def test_handoff_span_tree_equals_the_reference_pair(tiers):
    ids = list(range(60, 84))
    root = _root()
    tracing.enable()
    jax_tracing.enable()
    jax_out = _handoff(tiers['jax']['prefill'][1], tiers['jax']['decode'][1],
                       ids, 'trace-jax', root)
    port_out = _handoff(tiers['port']['prefill'][1],
                        tiers['port']['decode'][1], ids, 'trace-port', root)
    assert port_out == jax_out
    ours, theirs = _traced(tracing, root), _traced(jax_tracing, root)
    assert _tree(ours, root.span_id) == _tree(theirs, root.span_id)
    names = [s['name'] for s in ours]
    assert names.count('engine.ingest_chunk') == 3
    assert names.count('engine.ingest_publish') == 1
    assert {'server.request', 'server.kv_push', 'engine.queue_wait',
            'engine.prefill', 'engine.decode'} <= set(names)
    # The decode tier's publish chains back to the root through the
    # prefill tier's kv_push and request spans.
    by_id = {s['span_id']: s for s in ours}
    span = next(s for s in ours if s['name'] == 'engine.ingest_publish')
    chain = []
    while span is not None:
        chain.append(span['name'])
        span = by_id.get(span['parent_id'])
    assert chain == ['engine.ingest_publish', 'server.kv_push',
                     'server.request']
    tiers['port']['decode'][0].engine._pool.check()  # pylint: disable=protected-access


def test_port_prefill_to_reference_decode_joins_one_trace(tiers):
    ids = list(range(90, 114))
    root = _root()
    tracing.enable()
    jax_tracing.enable()
    out = _handoff(tiers['port']['prefill'][1], tiers['jax']['decode'][1],
                   ids, 'trace-mixed', root)
    assert out == tiers['jax']['decode'][0].generate(
        ids, max_new_tokens=_NEW, timeout=120)[0]
    spans = _traced(tracing, root) + _traced(jax_tracing, root)
    ids_seen = {s['span_id'] for s in spans} | {root.span_id}
    assert all(s['parent_id'] in ids_seen for s in spans)
    push = next(s for s in _traced(tracing, root)
                if s['name'] == 'server.kv_push')
    theirs = _traced(jax_tracing, root)
    ingest = [s for s in theirs if s['name'].startswith('engine.ingest')]
    assert len(ingest) == 4
    assert all(s['parent_id'] == push['span_id'] for s in ingest)
    assert sum(s['name'] == 'server.request' and
               s['parent_id'] == push['span_id'] for s in theirs) == 3


# ---------------------------------------------------------------------
# GET /traces and the preemption notice
# ---------------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_traces_endpoint(tiers):
    _, url = tiers['port']['decode']
    tracing.enable()
    req = urllib.request.Request(
        url + '/generate', data=json.dumps(
            {'prompt_ids': [[60, 61, 62]], 'max_new_tokens': 2}).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
    status, data = _get(url + '/traces')
    assert status == 200
    assert data['schema'] == 'skytpu-traces/1'
    assert data['enabled'] is True
    assert isinstance(data['exemplars'], dict)
    names = {s['name'] for s in data['spans']}
    # A header-less POST minted its own trace on the server.
    assert {'server.request', 'engine.queue_wait', 'engine.prefill',
            'engine.decode'} <= names
    assert any(s['attrs'].get('route') == '/generate'
               for s in data['spans'] if s['name'] == 'server.request')
    # GETs without a header (this one, /health) record nothing.
    before = len(tracing.snapshot())
    assert _get(url + '/health')[0] == 200
    assert len(tracing.snapshot()) == before
    status, data = _get(url + '/traces?window_s=0.000001')
    assert status == 200 and data['spans'] == []
    status, data = _get(url + '/traces?window_s=soon')
    assert status == 400 and 'window_s' in data['error']


def test_preempt_notice_spans_and_flight_record(reference, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv('SKYTPU_FLIGHT_DIR', str(tmp_path / 'flight'))
    server = InferenceServer(
        _cfg(), params=params_from_jax(reference['params'], _cfg()),
        prefix_store=str(tmp_path / 'store'), device='cpu', **_ENGINE_KW)
    server.warmup()
    http = BackgroundServer(server)
    try:
        tracing.enable()
        server.engine.generate(PROMPT, max_new_tokens=_NEW, timeout=60)
        req = urllib.request.Request(
            http.url + '/preempt', data=json.dumps({'deadline_s': 30}
                                                   ).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            result = json.loads(resp.read())
        assert result['drained'] and result['export']['exported'] >= 1
    finally:
        http.close()
        server.engine.stop()
    spans = tracing.snapshot()
    notice = next(s for s in spans if s['name'] == 'server.preempt_notice')
    export = next(s for s in spans if s['name'] == 'engine.preempt_export')
    assert export['parent_id'] == notice['span_id']
    assert notice['attrs']['drained'] is True
    assert export['attrs']['exported'] == result['export']['exported']
    (path,) = (tmp_path / 'flight').glob('flight-preempt_notice-*.json')
    with open(path, encoding='utf-8') as f:
        record = json.load(f)
    assert record['extra']['budget_s'] == 30
