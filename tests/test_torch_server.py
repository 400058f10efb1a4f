"""The port's HTTP server over live localhost HTTP: /generate returns the
same greedy tokens as the port's in-process engine and as the JAX engine
on the same test-tiny fp32 weights, plain and as server-sent events
(text deltas concatenate to the plain text); /health answers; bad input
is a 400, and before any stream opens; a client leaving a stream frees
its slot; /metrics parses and names the reference's metrics; a text
prompt goes through the byte tokenizer; without device= the server
refuses to start on a machine without CUDA."""
import dataclasses
import http.client
import importlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.observability.exposition import parse_prometheus_text
from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                             InferenceServer, byte_decode,
                                             byte_encode)

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_MAX_NEW = 6


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope='module')
def live():
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 512, n).tolist() for n in (4, 13, 21)]
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    jax_engine = jax_inference.ContinuousBatchingEngine(
        jcfg, num_slots=2, paged_block_size=8, prefill_chunk=8, rng_seed=0)
    try:
        jax_out = [jax_engine.generate(p, max_new_tokens=_MAX_NEW)[0]
                   for p in prompts]
    finally:
        jax_engine.drain(timeout=60)
    cfg = dataclasses.replace(get_config('test-tiny'), **_KW)
    server = InferenceServer(
        cfg, num_slots=2, paged_block_size=8, prefill_chunk=8,
        params=params_from_jax(jax.device_get(jax_engine.params), cfg),
        device='cpu')
    server.warmup()
    http = BackgroundServer(server)
    try:
        yield {'url': http.url, 'server': server, 'prompts': prompts,
               'jax_out': jax_out}
    finally:
        http.close()
        server.engine.drain(timeout=60)


def test_health(live):
    with urllib.request.urlopen(live['url'] + '/health', timeout=30) as r:
        assert r.status == 200
        assert json.loads(r.read()) == {'status': 'ok', 'tier': 'monolithic'}


def test_generate_equals_engine_and_reference(live):
    status, body = _post(live['url'] + '/generate',
                         {'prompt_ids': live['prompts'],
                          'max_new_tokens': _MAX_NEW})
    assert status == 200
    assert body['token_ids'] == live['jax_out']
    engine_out = [live['server'].engine.generate(
        p, max_new_tokens=_MAX_NEW)[0] for p in live['prompts']]
    assert body['token_ids'] == engine_out
    assert [s['new_tokens'] for s in body['stats']] == [_MAX_NEW] * 3
    assert [s['prompt_tokens'] for s in body['stats']] == [4, 13, 21]
    assert body['text'] == [byte_decode(t) for t in body['token_ids']]


def test_text_prompt_uses_byte_tokenizer(live):
    status, body = _post(live['url'] + '/generate',
                         {'prompt': 'hi there', 'max_new_tokens': 3})
    assert status == 200
    tokens, _ = live['server'].engine.generate(byte_encode('hi there'),
                                               max_new_tokens=3)
    assert body['token_ids'] == [tokens]


@pytest.mark.parametrize('body', [{'max_new_tokens': 2},
                                  {'prompt_ids': 5},
                                  {'prompt_ids': [[1, 2]],
                                   'max_new_tokens': 'many'},
                                  {'prompt_ids': [[]]}])
def test_bad_requests_are_400(live, body):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(live['url'] + '/generate', body)
    assert err.value.code == 400


@pytest.mark.parametrize('stream', [True, False])
def test_stream_equals_plain_answer(live, stream):
    """stream=true answers with server-sent events whose tokens are the
    plain answer's; stream=false is the plain answer."""
    body = {'prompt_ids': [[1, 2, 3]], 'max_new_tokens': 3, 'stream': stream}
    tokens, _ = live['server'].engine.generate([1, 2, 3], max_new_tokens=3)
    if not stream:
        status, out = _post(live['url'] + '/generate', body)
        assert status == 200 and out['token_ids'] == [tokens]
        return
    events = _sse(live['url'] + '/generate', body)
    assert [e['token_id'] for e in events[:-1]] == tokens
    assert events[-1]['done'] is True
    assert events[-1]['stats']['new_tokens'] == 3


def _sse(url, body, timeout=60):
    """POST `body` and read the server-sent events: the JSON payload of
    each `data:` line ('[DONE]' as is)."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.status == 200
        assert resp.headers['Content-Type'].startswith('text/event-stream')
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith('data: '):
                data = line[len('data: '):]
                events.append(data if data == '[DONE]' else json.loads(data))
    return events


def test_sse_tokens_equal_reference_and_deltas_concatenate(live):
    """Each prompt streamed alone: its tokens are the JAX engine's (the
    plain answer's), and the text deltas concatenate to the plain
    answer's text."""
    for prompt, want in zip(live['prompts'], live['jax_out']):
        events = _sse(live['url'] + '/generate',
                      {'prompt_ids': [prompt], 'max_new_tokens': _MAX_NEW,
                       'stream': True})
        assert [e['token_id'] for e in events[:-1]] == want
        assert events[-1]['stats']['prompt_tokens'] == len(prompt)
        text = ''.join(e['text_delta'] for e in events)
        assert text == byte_decode(want)
    status, body = _post(live['url'] + '/generate',
                         {'prompt': 'caf\u00e9 \u20ac', 'max_new_tokens': 8})
    events = _sse(live['url'] + '/generate',
                  {'prompt': 'caf\u00e9 \u20ac', 'max_new_tokens': 8,
                   'stream': True})
    assert status == 200
    assert [e['token_id'] for e in events[:-1]] == body['token_ids'][0]
    assert ''.join(e['text_delta'] for e in events) == body['text'][0]


@pytest.mark.parametrize('body', [
    {'prompt_ids': [[1, 2], [3, 4]], 'stream': True},
    {'prompt_ids': [[1, 2]], 'max_new_tokens': 'many', 'stream': True},
    {'prompt_ids': [[]], 'stream': True},
    {'prompt_ids': [[1, 2]], 'timeout_s': -1, 'stream': True},
    {'prompt_ids': [[1, 2]], 'priority': 'gold', 'stream': True}])
def test_stream_refusals_come_before_the_stream(live, body):
    """The reference's 400s (more than one prompt, bad fields) are JSON
    answers: no stream opens."""
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(live['url'] + '/generate', body)
    assert err.value.code == 400
    assert err.value.headers['Content-Type'].startswith('application/json')
    assert json.loads(err.value.read())['error']


def test_disconnected_stream_frees_its_slot(live, monkeypatch):
    """A client that leaves mid-stream cancels its request: the engine
    frees the slot before the generation would have ended."""
    server, engine = live['server'], live['server'].engine
    futures = []
    real = server._submit_one  # pylint: disable=protected-access

    def submit(*args, **kw):
        futures.append(real(*args, **kw))
        return futures[-1]

    monkeypatch.setattr(server, '_submit_one', submit)
    gate = threading.Event()
    body = json.dumps({'prompt_ids': [[5, 6, 7]], 'max_new_tokens': 50,
                       'stream': True}).encode()
    conn = http.client.HTTPConnection('127.0.0.1', int(
        live['url'].rsplit(':', 1)[1]), timeout=30)
    conn.request('POST', '/generate', body,
                 {'Content-Type': 'application/json'})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.readline().startswith(b'data: ')
    # Hold the engine between ticks, then leave.
    holder = threading.Thread(target=engine._run_in_tick,  # pylint: disable=protected-access
                              args=(lambda: gate.wait(30),))
    holder.start()
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    time.sleep(0.5)
    gate.set()
    holder.join(timeout=30)
    deadline = time.monotonic() + 30
    while engine._busy() and time.monotonic() < deadline:  # pylint: disable=protected-access
        time.sleep(0.01)
    assert not engine._busy()  # pylint: disable=protected-access
    assert futures[0].cancelled()
    engine._pool.check()  # pylint: disable=protected-access
    assert engine._pool.used == 1  # pylint: disable=protected-access


# Every metric the port records, with the reference module defining it.
PORTED_METRICS = {
    'skypilot_tpu.models.inference': (
        'skytpu_engine_ttft_seconds', 'skytpu_engine_tpot_seconds',
        'skytpu_engine_queue_depth', 'skytpu_engine_active_slots',
        'skytpu_engine_tokens_generated_total',
        'skytpu_engine_requests_finished_total',
        'skytpu_engine_admission_rejects_total',
        'skytpu_engine_prefix_cache_total',
        'skytpu_engine_prefix_tokens_reused_total',
        'skytpu_engine_paged_blocks_capacity',
        'skytpu_engine_paged_blocks_used',
        'skytpu_engine_tp_size', 'skytpu_engine_tp_collectives',
        'skytpu_engine_tp_allreduce_bytes',
        'skytpu_engine_paged_blocks_used_per_device',
        'skytpu_engine_paged_pool_bytes_per_device',
        'skytpu_engine_paged_blocks_reused_total',
        'skytpu_engine_paged_cow_copies_total',
        'skytpu_engine_chunked_prefill_ticks_total',
        'skytpu_engine_paged_int8_bytes_saved',
        'skytpu_engine_dispatch_ahead_depth',
        'skytpu_engine_tick_host_gap_seconds',
        'skytpu_engine_dispatch_ahead',
        'skytpu_engine_spec_drafted_total',
        'skytpu_engine_spec_accepted_total',
        'skytpu_engine_spec_paged_accepted_total',
        'skytpu_engine_tier_queue_depth',
        'skytpu_engine_tier_ttft_seconds',
        'skytpu_engine_tier_requests_total',
        'skytpu_engine_tier_deadline_shed_total',
        'skytpu_engine_slot_preempts_total',
        'skytpu_engine_wedge_recoveries_total',
        'skytpu_prefix_export_blocks_total',
        'skytpu_prefix_prewarm_blocks_total',
        'skytpu_prefix_prewarm_hit_total',
        'skytpu_handoff_export_chunks_total',
        'skytpu_handoff_export_bytes_total',
        'skytpu_handoff_ingest_chunks_total',
        'skytpu_handoff_ingest_streams_total',
        'skytpu_handoff_ingest_blocks_total'),
    'skypilot_tpu.serve.server': (
        'skytpu_server_request_seconds', 'skytpu_server_requests_total',
        'skytpu_server_shed_total', 'skytpu_server_draining',
        'skytpu_server_preempt_notices_total',
        'skytpu_server_preempt_drain_seconds'),
    'skypilot_tpu.observability.tracing': (
        'skytpu_trace_spans_recorded_total',
        'skytpu_trace_spans_dropped_total',
        'skytpu_trace_flight_records_total'),
    'skypilot_tpu.train.metrics': (
        'skytpu_train_step_seconds', 'skytpu_train_tokens_per_sec',
        'skytpu_train_mfu', 'skytpu_train_steps_timed_total',
        'skytpu_train_opt_state_bytes',
        'skytpu_train_opt_state_bytes_per_device',
        'skytpu_train_step_collectives'),
    'skypilot_tpu.train.checkpoints': (
        'skytpu_train_checkpoint_save_seconds',
        'skytpu_train_checkpoint_restore_fallbacks_total'),
    'skypilot_tpu.train.elastic': (
        'skytpu_train_preemptions_total',
        'skytpu_train_elastic_resizes_total'),
}


def test_metrics_parse_and_names_equal_the_reference(live):
    """/metrics parses with the port's strict parser; its families are
    exactly the ported list (each module and its port imported: the
    registry is process-wide), each defined in the reference under the
    same name, kind, labels and buckets; the counts follow the
    traffic."""
    from skypilot_tpu.observability import metrics as jax_obs
    from skypilot_tpu_torch.observability import metrics as obs
    for module in PORTED_METRICS:
        importlib.import_module(module)
        importlib.import_module(module.replace('skypilot_tpu.',
                                               'skypilot_tpu_torch.', 1))
    _post(live['url'] + '/generate', {'prompt_ids': live['prompts'],
                                      'max_new_tokens': _MAX_NEW})
    with urllib.request.urlopen(live['url'] + '/metrics', timeout=30) as r:
        assert r.status == 200
        families = parse_prometheus_text(r.read().decode())
    names = sorted(n for names in PORTED_METRICS.values() for n in names)
    assert sorted(families) == names
    for name in names:
        ours, theirs = obs.REGISTRY.get(name), jax_obs.REGISTRY.get(name)
        assert theirs is not None, name
        assert (ours.kind, ours.labelnames, ours.help) == (
            theirs.kind, theirs.labelnames, theirs.help), name
        assert getattr(ours, 'buckets', None) == getattr(
            theirs, 'buckets', None), name
        assert families[name]['kind'] == ours.kind
    ttft = families['skytpu_engine_ttft_seconds']['samples']
    assert ttft[('skytpu_engine_ttft_seconds_count', ())] >= 3
    ok = families['skytpu_server_requests_total']['samples']
    assert ok[('skytpu_server_requests_total',
               (('route', '/generate'), ('status', '200')))] >= 1
    assert families['skytpu_engine_paged_blocks_capacity']['samples'][
        ('skytpu_engine_paged_blocks_capacity', ())] == \
        live['server'].engine.cfg.paged_num_blocks


def test_server_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        InferenceServer(dataclasses.replace(get_config('test-tiny'), **_KW),
                        paged_block_size=8)
