"""KV portability on the port's HTTP server, on the CPU, over live
localhost HTTP (skypilot_tpu_torch/serve/server.py):

  - fault 6's pin: every response not yet on the wire carries the
    reference's fleet headers (X-SkyTPU-Queue-Depth, -Tier, -Tokenizer,
    -Prefix-Digest, -Tier-Load, -Adapters), a draining /health and every
    draining shed carry X-SkyTPU-Draining: 1, and /health names the tier;
  - the /kv/* status-code contract (the reference's
    tests/test_disagg.py TestIngestEndpoint), the tier gating of the
    routes, and the push's retry budget through the transport seam;
  - POST /preempt exports the prefix cache to --prefix-store and a new
    server pre-warms from it before /health is ready, with `prewarm` on
    /health and the JAX engine's tokens on the next turn; SIGTERM exports
    too, and a second process on the same store starts warm;
  - the reference's SkyServeLoadBalancer in front of a prefill-tier and a
    decode-tier port server (its tests/test_chaos.py TestDisaggHandoff):
    it learns the tiers from the servers' headers, a long prompt takes the
    handoff and returns the JAX engine's tokens, and a kv.stream fault
    mid-stream falls back to monolithic with the decode pool back at
    refcount 0.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import pytest

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch.models import kv_cache as kv
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.serve import server as server_lib
from skypilot_tpu_torch.serve.server import BackgroundServer, InferenceServer
from skypilot_tpu_torch.utils import fault_injection

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_ENGINE_KW = dict(num_slots=2, paged_block_size=8, prefix_cache=6)
_NEW = 4
_FLEET_HEADERS = ('X-SkyTPU-Queue-Depth', 'X-SkyTPU-Tier',
                  'X-SkyTPU-Tokenizer', 'X-SkyTPU-Prefix-Digest',
                  'X-SkyTPU-Tier-Load', 'X-SkyTPU-Adapters')


def _cfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


def _call(url, method='GET', body=None, data=None, timeout=60):
    """(status, headers, body bytes) of one request, any status."""
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _generate(url, ids, max_new=_NEW):
    status, headers, body = _call(url + '/generate', 'POST', {
        'prompt_ids': [ids], 'max_new_tokens': max_new})
    assert status == 200, body
    return json.loads(body)['token_ids'][0], headers


@pytest.fixture(scope='module')
def reference():
    engine = jax_inference.ContinuousBatchingEngine(
        dataclasses.replace(jax_get_config('test-tiny'), **_KW),
        rng_seed=0, **_ENGINE_KW)
    yield {'engine': engine, 'params': jax.device_get(engine.params)}
    engine.stop()


def _want(reference, ids):
    return reference['engine'].generate(ids, max_new_tokens=_NEW)[0]


def _server(reference, **kw):
    for key, value in _ENGINE_KW.items():
        kw.setdefault(key, value)
    server = InferenceServer(
        _cfg(), params=params_from_jax(reference['params'], _cfg()),
        device='cpu', **kw)
    return server


def _live(server):
    server.warmup()
    return BackgroundServer(server)


# ---------------------------------------------------------------------
# fault 6: the fleet headers and X-SkyTPU-Draining
# ---------------------------------------------------------------------


def test_fleet_headers_and_draining_marks(reference):
    server = _server(reference, max_adapters=1, adapter_rank=4)
    http = _live(server)
    try:
        ids = list(range(1, 21))
        _tokens, headers = _generate(http.url, ids)
        for name in _FLEET_HEADERS:
            assert name in headers, name
        assert headers['X-SkyTPU-Tier'] == 'monolithic'
        assert headers['X-SkyTPU-Tokenizer'] == 'byte'
        assert headers['X-SkyTPU-Queue-Depth'] == '0'
        assert headers['X-SkyTPU-Adapters'] == ''
        assert headers['X-SkyTPU-Tier-Load'] == \
            'interactive=0,standard=0,batch=0'
        digest = headers['X-SkyTPU-Prefix-Digest']
        assert digest == server.engine.prefix_digest()
        assert kv.prefix_route_hash(ids[:16]) in digest.split(':')[3]
        status, headers, body = _call(http.url + '/health')
        assert status == 200 and 'X-SkyTPU-Queue-Depth' in headers
        assert json.loads(body)['tier'] == 'monolithic'
        server.draining = True
        status, headers, body = _call(http.url + '/health')
        assert (status, json.loads(body)) == (503, {'status': 'draining'})
        assert headers['X-SkyTPU-Draining'] == '1'
        assert headers['Retry-After'] == '5'
        for route, payload in (
                ('/generate', {'prompt_ids': [[1, 2]]}),
                ('/v1/completions', {'prompt': 'hi'}),
                ('/kv/prefill', {'prompt_ids': [1, 2],
                                 'target': 'http://127.0.0.1:1'})):
            status, headers, _ = _call(http.url + route, 'POST', payload)
            assert status == 503, route
            assert headers['X-SkyTPU-Draining'] == '1', route
            assert headers['Retry-After'], route
            assert 'X-SkyTPU-Queue-Depth' in headers, route
    finally:
        http.close()
        server.engine.stop()


def test_reference_flags_parse():
    args = server_lib.build_parser().parse_args(
        ['--prefix-store', '/tmp/store', '--tier', 'decode',
         '--prefix-cache', '4'])
    assert (args.prefix_store, args.tier) == ('/tmp/store', 'decode')
    assert server_lib.build_parser().parse_args([]).tier == 'monolithic'
    with pytest.raises(SystemExit):
        server_lib.build_parser().parse_args(['--tier', 'gpu'])


# ---------------------------------------------------------------------
# the /kv/* routes
# ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def tiers(reference):
    """A prefill-tier and a decode-tier server, live."""
    servers = {tier: _server(reference, tier=tier)
               for tier in ('prefill', 'decode')}
    https = {tier: _live(server) for tier, server in servers.items()}
    yield {tier: (servers[tier], https[tier].url) for tier in servers}
    fault_injection.disarm_all()
    for tier, http in https.items():
        http.close()
        servers[tier].engine.stop()


def test_ingest_status_code_contract(tiers):
    pre, _ = tiers['prefill']
    dec, url = tiers['decode']
    ids = list(range(250, 270))
    pre.engine.prefill_prefix(ids)
    chunks = pre.engine.export_prefix_chunks(ids, 'http-1', chunk_blocks=1)
    status, _, body = _call(url + '/kv/ingest', 'POST', data=chunks[1])
    assert status == 409 and json.loads(body)['expected'] == 0
    bad = bytearray(chunks[0])
    bad[-1] ^= 0xFF
    assert _call(url + '/kv/ingest', 'POST', data=bytes(bad))[0] == 400
    assert _call(url + '/kv/ingest', 'POST', data=b'')[0] == 400
    used = dec.engine._pool.used  # pylint: disable=protected-access
    status, headers, _ = _call(url + '/kv/ingest', 'POST', data=chunks[0])
    assert status == 200 and headers['X-SkyTPU-Tier'] == 'decode'
    assert dec.engine._pool.used == used + 1  # pylint: disable=protected-access
    status, _, body = _call(url + '/kv/abort', 'POST',
                            {'stream_id': 'http-1'})
    assert status == 200 and json.loads(body)['aborted']
    assert dec.engine._pool.used == used  # pylint: disable=protected-access
    dec.engine._pool.check()  # pylint: disable=protected-access
    assert _call(url + '/kv/abort', 'POST', {'nope': 1})[0] == 400
    status, _, body = _call(url + '/health')
    assert json.loads(body)['tier'] == 'decode'
    dec.engine._draining = True  # pylint: disable=protected-access
    try:
        status, headers, _ = _call(url + '/kv/ingest', 'POST',
                                   data=chunks[0])
        assert status == 503 and headers['X-SkyTPU-Draining'] == '1'
    finally:
        dec.engine._draining = False  # pylint: disable=protected-access


def test_routes_are_gated_by_tier(tiers):
    _, pre_url = tiers['prefill']
    _, dec_url = tiers['decode']
    status, _, body = _call(dec_url + '/kv/prefill', 'POST', {
        'prompt_ids': [1, 2, 3], 'target': pre_url})
    assert status == 400 and b'decode-tier' in body
    status, _, body = _call(pre_url + '/kv/ingest', 'POST', data=b'x')
    assert status == 400 and b'prefill-tier' in body
    for payload in ({'prompt_ids': [], 'target': dec_url},
                    {'prompt_ids': [1, 'a'], 'target': dec_url},
                    {'prompt_ids': [1, 2], 'target': 'ftp://x'},
                    {'prompt_ids': [1, 2], 'target': dec_url,
                     'chunk_blocks': 'many'},
                    {'prompt_ids': [1, 2], 'target': dec_url,
                     'chunk_blocks': server_lib.MAX_CHUNK_BLOCKS + 1}):
        assert _call(pre_url + '/kv/prefill', 'POST', payload)[0] == 400


def test_prefill_route_hands_off(reference, tiers):
    _, pre_url = tiers['prefill']
    dec, dec_url = tiers['decode']
    ids = list(range(40, 64))
    status, _, body = _call(pre_url + '/kv/prefill', 'POST', {
        'prompt_ids': ids, 'target': dec_url, 'stream_id': 'pf-1',
        'chunk_blocks': 2})
    assert status == 200, body
    result = json.loads(body)
    assert (result['chunks'], result['blocks']) == (2, 3)
    assert result['push_retries'] == 0 and result['handoff_s'] > 0
    hits = dec.engine.prewarm_stats['hits']
    assert _generate(dec_url, ids)[0] == _want(reference, ids)
    assert dec.engine.prewarm_stats['hits'] == hits + 1


class _Transport:
    """Stand-in for server.post_bytes: each seq's first attempt fails in
    transport (fail_each_once), or one seq fails for ever (wedge_seq), or
    one seq answers a 409 naming an earlier seq once (resume_at)."""

    def __init__(self, fail_each_once=True, wedge_seq=None,
                 resume_at=None):
        self.fail_each_once = fail_each_once
        self.wedge_seq = wedge_seq
        self.resume_at = resume_at
        self.attempts = {}
        self.seq = 0

    def __call__(self, url, data, headers, timeout):
        del url, headers, timeout
        seq = int(data[1:])
        n = self.attempts[seq] = self.attempts.get(seq, 0) + 1
        if self.wedge_seq == seq:
            raise ConnectionResetError(f'seq {seq} wedged')
        if self.fail_each_once and n == 1:
            raise urllib.error.URLError(f'transient on seq {seq}')
        if self.resume_at is not None and seq == self.resume_at[0] \
                and n == 1:
            return 409, json.dumps(
                {'expected': self.resume_at[1]}).encode()
        return 200, b'{"ok": true}'


@pytest.mark.parametrize('transport,pushed,retries', [
    (dict(fail_each_once=True), 6, 6),
    (dict(fail_each_once=False, resume_at=(4, 2)), 8, 1),
], ids=['retry-each-chunk', 'resume-at-409'])
def test_push_retry_budget(tiers, monkeypatch, transport, pushed,
                           retries):
    server, _ = tiers['prefill']
    fake = _Transport(**transport)
    monkeypatch.setattr(server_lib, 'post_bytes', fake)
    chunks = [b'c%d' % i for i in range(6)]
    result = server._push_stream('http://d', chunks)  # pylint: disable=protected-access
    assert (result['chunks'], result['retries']) == (pushed, retries)


def test_push_gives_up_on_a_chunk_failing_twice(tiers, monkeypatch):
    server, _ = tiers['prefill']
    monkeypatch.setattr(server_lib, 'post_bytes',
                        _Transport(fail_each_once=False, wedge_seq=2))
    with pytest.raises(server_lib._HandoffPushError) as exc:  # pylint: disable=protected-access
        server._push_stream('http://d', [b'c%d' % i for i in range(6)])  # pylint: disable=protected-access
    assert exc.value.pushed == 2


# ---------------------------------------------------------------------
# the preemption rescue: export on /preempt and SIGTERM, pre-warm
# ---------------------------------------------------------------------


def test_preempt_exports_and_a_new_server_prewarms(reference, tmp_path):
    store = str(tmp_path / 'store')
    turn1 = list(range(70, 90))
    old = _server(reference, prefix_store=store)
    http = _live(old)
    try:
        reply, _ = _generate(http.url, turn1)
        turn2 = turn1 + reply + [5, 6, 7]
        hot, _ = _generate(http.url, turn2)
        assert old.engine.prefix_stats['hits'] == 1
        status, _, body = _call(http.url + '/preempt', 'POST',
                                {'deadline_s': 30})
        result = json.loads(body)
        assert status == 200 and result['drained'], result
        export = result['export']
        assert export['exported'] == 3 and export['key'].endswith('.skypfx')
        assert os.listdir(store) == [export['key']]
    finally:
        http.close()
    new = _server(reference, prefix_store=store)
    prewarm = new.prewarm_from_store()
    assert prewarm == {'status': 'ok', 'key': export['key'],
                       'imported': 3, 'blocks': export['blocks'],
                       'skipped_corrupt': 0, 'partial': False}
    assert not new.ready
    http = _live(new)
    try:
        status, _, body = _call(http.url + '/health')
        assert status == 200 and json.loads(body)['prewarm'] == prewarm
        turn3 = turn2 + hot + [8, 9]
        assert _generate(http.url, turn2)[0] == hot == \
            _want(reference, turn2)
        # Turn 2 re-published its prefix locally, so turn 3's hit is no
        # longer the pre-warm's.
        assert _generate(http.url, turn3)[0] == _want(reference, turn3)
        assert new.engine.prewarm_stats['hits'] == 1
        assert new.engine.prefix_stats['hits'] == 2
    finally:
        http.close()
        new.engine.stop()


def test_prewarm_outcomes_without_an_artifact(reference, tmp_path):
    assert _server(reference).prewarm_from_store() is None
    server = _server(reference, prefix_store=str(tmp_path / 'empty'))
    assert server.prewarm_from_store() == {'status': 'no-artifact'}
    junk = tmp_path / 'junk'
    junk.mkdir()
    (junk / 'prefix-1.skypfx').write_bytes(b'not an artifact')
    server = _server(reference, prefix_store=str(junk))
    got = server.prewarm_from_store()
    assert got['status'] == 'rejected' and got['key'] == 'prefix-1.skypfx'
    server = _server(reference, prefix_store='s3://bucket')
    assert server.prewarm_from_store()['status'] == 'failed'


def test_preempt_kill_fault_publishes_nothing(reference, tmp_path):
    store = str(tmp_path / 'store')
    server = _server(reference, prefix_store=store)
    server.engine.generate(list(range(1, 21)), max_new_tokens=2)
    fault_injection.arm('replica.preempt_kill', 'fail:1')
    try:
        result = server._drain_and_export(10.0)  # pylint: disable=protected-access
    finally:
        fault_injection.disarm_all()
    assert result['drained'] and result['export'] is None
    assert result['error'].startswith('killed mid-export')
    assert not os.path.exists(store) or not os.listdir(store)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _start(port, store):
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.server',
         '--model', 'test-tiny', '--device', 'cpu', '--port', str(port),
         '--max-seq-len', '128', '--num-slots', '2', '--prefix-cache',
         '4', '--paged-block-size', '8', '--prefix-store', store],
        cwd=_REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    url = f'http://127.0.0.1:{port}'
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f'server exited {proc.returncode}: '
                                 f'{proc.stderr.read()[-2000:]!r}')
        try:
            if _call(url + '/health', timeout=5)[0] == 200:
                return proc, url
        except OSError:
            pass
        time.sleep(0.1)
    proc.kill()
    raise AssertionError('server did not come up')


def test_sigterm_exports_and_the_next_process_starts_warm(tmp_path):
    store = str(tmp_path / 'store')
    ids = list(range(100, 130))
    procs = []
    try:
        proc, url = _start(_free_port(), store)
        procs.append(proc)
        want, _ = _generate(url, ids)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        (key,) = os.listdir(store)
        proc, url = _start(_free_port(), store)
        procs.append(proc)
        body = json.loads(_call(url + '/health')[2])
        assert body['prewarm']['status'] == 'ok'
        assert body['prewarm']['key'] == key
        assert body['prewarm']['imported'] >= 1
        assert _generate(url, ids)[0] == want
        metrics = _call(url + '/metrics')[2].decode()
        assert 'skytpu_prefix_prewarm_hit_total 1' in metrics
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


# ---------------------------------------------------------------------
# the reference's load balancer in front of port tiers
# ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def fleet(reference):
    from skypilot_tpu.serve.load_balancer import SkyServeLoadBalancer
    from skypilot_tpu.serve.load_balancing_policies import \
        PrefixAwarePolicy
    env = {'SKYTPU_SERVE_LB_DISAGG_THRESHOLD': '16',
           'SKYTPU_SERVE_HANDOFF_CHUNK_BLOCKS': '1'}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    servers = {tier: _server(reference, tier=tier)
               for tier in ('prefill', 'decode')}
    https = {tier: _live(server) for tier, server in servers.items()}
    urls = {tier: http.url for tier, http in https.items()}
    policy = PrefixAwarePolicy()
    lb_port = _free_port()
    lb = SkyServeLoadBalancer('http://127.0.0.1:1', lb_port,
                              policy_name='prefix_aware')
    lb.policy = policy
    policy.set_ready_replicas(list(urls.values()))
    # The tiers are learned in band, from what the port's servers send.
    for url in urls.values():
        policy.observe_response(url, _call(url + '/health')[1])
    lb.start_in_thread()
    lb_url = f'http://127.0.0.1:{lb_port}'
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            _call(lb_url + '/metrics', timeout=2)
            break
        except OSError:
            time.sleep(0.1)
    yield {'servers': servers, 'urls': urls, 'policy': policy,
           'lb_url': lb_url}
    fault_injection.disarm_all()
    for tier, http in https.items():
        http.close()
        servers[tier].engine.stop()
    for key, value in saved.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def test_lb_learns_the_port_tiers(fleet):
    assert fleet['policy'].replica_tiers() == {
        url: tier for tier, url in fleet['urls'].items()}


def test_lb_hands_a_long_prompt_off(reference, fleet):
    ids = list(range(1, 25))
    dec = fleet['servers']['decode'].engine
    out, _ = _generate(fleet['lb_url'], ids)
    assert out == _want(reference, ids)
    assert fleet['policy'].stats['handoff'] >= 1
    assert dec.ingest_stats['streams_completed'] == 1
    assert dec.ingest_stats['chunks_ok'] == 3
    assert dec.prewarm_stats['hits'] == 1
    dec._pool.check()  # pylint: disable=protected-access


def test_lb_survives_a_kv_stream_fault_mid_stream(reference, fleet,
                                                  monkeypatch):
    """The prefill replica dies after the first chunk landed: the load
    balancer aborts the partial ingest, finds no other prefill replica
    and the decode replica serves the request itself, with the JAX
    engine's tokens and its pool back at refcount 0."""
    ids = list(range(130, 154))
    dec = fleet['servers']['decode'].engine
    completed = dec.ingest_stats['streams_completed']
    used = dec._pool.used  # pylint: disable=protected-access
    pushes = []
    real_post = server_lib.post_bytes

    def post_then_die(url, data, headers, timeout):
        answer = real_post(url, data, headers, timeout)
        pushes.append(answer[0])
        fault_injection.arm('kv.stream', 'fail:1')
        return answer

    monkeypatch.setattr(server_lib, 'post_bytes', post_then_die)
    try:
        out, _ = _generate(fleet['lb_url'], ids)
        trips = fault_injection.trip_count('kv.stream')
    finally:
        fault_injection.disarm_all()
    assert pushes == [200] and trips == 1
    assert out == _want(reference, ids)
    assert dec.ingest_stats['streams_completed'] == completed
    assert dec.ingest_stats['streams_aborted'] >= 1
    assert not dec._ingest_sessions  # pylint: disable=protected-access
    # The request's own prompt is now cached on the decode replica (it
    # prefilled it); nothing else holds a block.
    assert dec._pool.used == used + 3  # pylint: disable=protected-access
    dec._pool.check()  # pylint: disable=protected-access
