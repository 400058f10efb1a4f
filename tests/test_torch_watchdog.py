"""The port's serving engine fails cleanly and recovers, as the reference's
does (tests/test_chaos.py `TestEngineWatchdog`,
tests/test_tracing.py `TestFlightRecorder`), on test-tiny fp32 weights (a
seeded JAX init carried across with params_from_jax) on the CPU:

  - a wedged `engine.decode` answers /generate with 503, Retry-After and
    "watchdog" within the 1x allowance, then the same server serves again
    in generation 1; the abandoned thread, once released, exits and emits
    nothing, and the pool tensors and step graphs are the engine's own;
  - `fail:1` fails the in-flight request with InjectedFault in the tick
    and keeps the generation;
  - deadlines: a passed deadline fails queued and in flight; timeout_s
    answers 504; --request-timeout caps timeout_s;
  - the flight record of a recovery parses, with the wedged slot and the
    step log;
  - the JAX engine and the port's give the untouched run's greedy tokens
    before and after a recovery;
  - every fault point is inert disarmed and fires armed at its place
    (`engine.slot_preempt`, `tenant.adapter_load`, `tenant.evict`,
    `train.save` included), and an adapter survives a recovery (the
    successor zeroes the stacks and re-loads it on demand);
  - `python -m skypilot_tpu_torch.serve.server` starts on the reference's
    command line (fault 7's flags).

Every wait has its own timeout and every test disarms its faults in a
`finally` and waits for the thread it wedged to exit.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.utils import fault_injection as jax_faults
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import adapter_layout, params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve.server import BackgroundServer, InferenceServer
from skypilot_tpu_torch.utils import fault_injection

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_WATCHDOG = 1.0
# The watchdog polls every timeout / 4; a wedged request's error comes
# within the 1x allowance plus a poll, and this much for the HTTP and
# CPU-load jitter of a loaded test machine.
_SLACK_S = 5.0
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5])
_NEW = 6


def _cfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


@pytest.fixture(scope='module')
def reference():
    """Test-tiny JAX weights and the JAX engine's untouched greedy
    tokens."""
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    engine = jax_inference.ContinuousBatchingEngine(
        jcfg, num_slots=2, paged_block_size=8, prefill_chunk=8, rng_seed=0)
    try:
        tokens = [engine.generate(p, max_new_tokens=_NEW)[0]
                  for p in PROMPTS]
    finally:
        engine.drain(timeout=60)
    return {'params': jax.device_get(engine.params), 'tokens': tokens,
            'jcfg': jcfg}


def _engine(reference, **kw):
    kw.setdefault('num_slots', 2)
    kw.setdefault('paged_block_size', 8)
    kw.setdefault('prefill_chunk', 8)
    return ContinuousBatchingEngine(
        _cfg(), params=params_from_jax(reference['params'], _cfg()),
        device='cpu', **kw)


def _wait(predicate, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f'timed out waiting for {what}')
        time.sleep(0.01)


def _released(engine, stale: int) -> None:
    """Disarm every fault and wait for the abandoned engine threads to
    exit: a wedged thread never outlives its test."""
    fault_injection.disarm_all()
    _wait(lambda: engine.watchdog_stats['stale_exits'] >= stale, 30.0,
          'the abandoned engine thread to exit')


@pytest.fixture(scope='module')
def wd(reference):
    """One warmed watchdog-enabled engine behind live HTTP, shared by the
    engine-chaos tests."""
    server = InferenceServer(
        _cfg(), num_slots=2, paged_block_size=8, prefill_chunk=8,
        params=params_from_jax(reference['params'], _cfg()),
        watchdog_timeout=_WATCHDOG, device='cpu')
    server.warmup()
    http = BackgroundServer(server)
    try:
        yield server, http.url
    finally:
        fault_injection.disarm_all()
        http.close()
        server.engine.stop()


def _post(url: str, body: dict, timeout: float = 60.0) -> tuple:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


class TestEngineWatchdog:

    def test_wedged_engine_fails_inflight_cleanly_and_server_recovers(
            self, wd, reference):
        server, url = wd
        engine = server.engine
        gen0 = engine._generation  # pylint: disable=protected-access
        stale0 = engine.watchdog_stats['stale_exits']
        pools = (engine._k_pool, engine._v_pool)  # pylint: disable=protected-access
        steps = engine._steps  # pylint: disable=protected-access
        fault_injection.arm('engine.decode', 'wedge')
        try:
            t0 = time.monotonic()
            status, headers, body = _post(
                url + '/generate', {'prompt_ids': [PROMPTS[0]],
                                    'max_new_tokens': _NEW})
            waited = time.monotonic() - t0
            assert status == 503, body
            assert 'watchdog' in body['error']
            assert headers.get('Retry-After') == '2'
            assert waited < _WATCHDOG + _SLACK_S
            assert engine._generation == gen0 + 1  # pylint: disable=protected-access
            decode_steps = engine.tick_stats['decode_steps']
        finally:
            _released(engine, stale0 + 1)
        # The abandoned thread exited without a dispatch.
        assert engine.tick_stats['decode_steps'] == decode_steps
        status, _, body = _post(url + '/generate',
                                {'prompt_ids': [PROMPTS[0]],
                                 'max_new_tokens': _NEW})
        assert status == 200, body
        assert body['token_ids'] == [reference['tokens'][0]]
        assert engine.watchdog_stats['recoveries'] >= 1
        # The recovery kept the pool tensors and the step graphs.
        assert all(a is b for a, b in zip(  # pylint: disable=protected-access
            (engine._k_pool, engine._v_pool), pools))
        assert engine._steps is steps  # pylint: disable=protected-access

    def test_stale_thread_emits_nothing(self, wd):
        server, _ = wd
        engine = server.engine
        stale0 = engine.watchdog_stats['stale_exits']
        events = []
        fault_injection.arm('engine.decode', 'wedge')
        try:
            future = engine.submit(PROMPTS[1], max_new_tokens=_NEW,
                                   on_token=events.append)
            with pytest.raises(exceptions.EngineWedgedError,
                               match='watchdog'):
                future.result(timeout=_WATCHDOG + _SLACK_S)
            # The first token came from the prefill; the wedge held the
            # first decode dispatch.
            assert len(events) == 2 and events[-1] is None
        finally:
            _released(engine, stale0 + 1)
        assert len(events) == 2

    def test_decode_fault_fails_inflight_then_engine_recovers(
            self, wd, reference):
        server, _ = wd
        engine = server.engine
        gen_before = engine._generation  # pylint: disable=protected-access
        fault_injection.arm('engine.decode', 'fail:1')
        try:
            future = engine.submit(PROMPTS[0], max_new_tokens=_NEW)
            with pytest.raises(fault_injection.InjectedFault):
                future.result(timeout=60)
            assert fault_injection.trip_count('engine.decode') == 1
        finally:
            fault_injection.disarm_all()
        tokens, _ = engine.generate(PROMPTS[0], max_new_tokens=_NEW,
                                    timeout=60)
        assert tokens == reference['tokens'][0]
        # No watchdog involvement: the tick healed itself.
        assert engine._generation == gen_before  # pylint: disable=protected-access

    def test_request_deadline(self, wd):
        server, url = wd
        future = server.engine.submit(PROMPTS[0], max_new_tokens=_NEW,
                                      deadline=time.time() - 1.0)
        with pytest.raises(exceptions.RequestDeadlineExceededError):
            future.result(timeout=60)
        status, _, body = _post(url + '/generate',
                                {'prompt': 'hi', 'max_new_tokens': 4,
                                 'timeout_s': 1e-9})
        assert status == 504, body
        assert 'expired' in body['error']

    def test_request_timeout_caps_timeout_s(self, wd):
        server, url = wd
        try:
            server.request_timeout = 0.5
            now = time.time()
            for data in ({'timeout_s': 60}, {}):
                deadline = server._deadline_for(data)  # pylint: disable=protected-access
                assert now + 0.4 < deadline < now + 1.5
            deadline = server._deadline_for({'timeout_s': 0.1})  # pylint: disable=protected-access
            assert deadline < now + 0.4
            server.request_timeout = 1e-9
            status, _, body = _post(url + '/generate',
                                    {'prompt': 'hi', 'max_new_tokens': 4,
                                     'timeout_s': 60})
            assert status == 504, body
        finally:
            server.request_timeout = 0.0
        assert server._deadline_for({}) is None  # pylint: disable=protected-access
        with pytest.raises(ValueError):
            server._deadline_for({'timeout_s': 0})  # pylint: disable=protected-access


class TestFlightRecorder:

    def test_wedge_recovery_dumps_postmortem(self, wd, tmp_path,
                                             monkeypatch):
        server, _ = wd
        engine = server.engine
        monkeypatch.setenv('SKYTPU_FLIGHT_DIR', str(tmp_path))
        tracing.enable()
        tracing.reset()
        stale0 = engine.watchdog_stats['stale_exits']
        fault_injection.arm('engine.decode', 'wedge')
        try:
            future = engine.submit(PROMPTS[0], max_new_tokens=_NEW)
            with pytest.raises(exceptions.EngineWedgedError):
                future.result(timeout=_WATCHDOG + _SLACK_S)
        finally:
            _released(engine, stale0 + 1)
            tracing.disable()
        records = sorted(tmp_path.glob('flight-wedge_recovery-*.json'))
        assert len(records) == 1, list(tmp_path.iterdir())
        with open(records[0], encoding='utf-8') as f:
            record = json.load(f)
        assert record['schema'] == tracing.FLIGHT_SCHEMA
        assert record['trigger'] == 'wedge_recovery'
        extra = record['extra']
        assert 'no progress' in extra['why']
        assert extra['generation'] == engine._generation  # pylint: disable=protected-access
        assert extra['step_log'], 'the ticks before the wedge are missing'
        assert ['prefill', [0]] in extra['step_log']
        assert extra['active_slots'] == [0]      # the wedged request
        assert isinstance(record['spans'], list)
        assert not list(tmp_path.glob('*.tmp'))  # atomic publish
        names = [s['name'] for s in tracing.snapshot()]
        assert 'engine.wedge_recovery' in names
        lines = tracing.render_flight_record(record)
        assert any('trigger=wedge_recovery' in line for line in lines)
        tracing.reset()

    def test_tick_failure_dumps_postmortem(self, wd, tmp_path, monkeypatch):
        server, _ = wd
        engine = server.engine
        monkeypatch.setenv('SKYTPU_FLIGHT_DIR', str(tmp_path))
        fault_injection.arm('engine.decode', 'fail:1')
        try:
            with pytest.raises(fault_injection.InjectedFault):
                engine.generate(PROMPTS[0], max_new_tokens=_NEW, timeout=60)
        finally:
            fault_injection.disarm_all()
        (path,) = tmp_path.glob('flight-tick_failure-*.json')
        with open(path, encoding='utf-8') as f:
            record = json.load(f)
        assert record['spans'] == []   # tracing off: engine state only
        assert 'InjectedFault' in record['extra']['why']

    def test_flight_record_without_tracing_or_dir_is_noop(self,
                                                          monkeypatch):
        monkeypatch.delenv('SKYTPU_FLIGHT_DIR', raising=False)
        assert not tracing.enabled()
        assert tracing.flight_record('tick_failure') is None

    def test_flight_record_unwritable_dir_degrades(self, tmp_path,
                                                   monkeypatch):
        blocker = tmp_path / 'file'
        blocker.write_text('')
        monkeypatch.setenv('SKYTPU_FLIGHT_DIR', str(blocker / 'below'))
        assert tracing.flight_record('tick_failure',
                                     extra={'why': 'x'}) is None


def _wedge_and_recover(engine, faults, submit_timeout: float):
    """Wedge `engine` (its framework's fault module `faults`) on one
    request, wait for the watchdog's EngineWedgedError, release."""
    faults.arm('engine.decode', 'wedge')
    try:
        future = engine.submit(PROMPTS[1], max_new_tokens=_NEW)
        with pytest.raises(Exception) as info:
            future.result(timeout=submit_timeout)
        assert type(info.value).__name__ == 'EngineWedgedError'
    finally:
        faults.disarm_all()


def test_both_engines_serve_the_untouched_tokens_after_a_recovery(
        reference):
    """The reference's engine and the port's, each warm and recovered
    from one wedge: their greedy tokens before and after equal the
    untouched run's."""
    jax_engine = jax_inference.ContinuousBatchingEngine(
        reference['jcfg'], num_slots=2, paged_block_size=8,
        prefill_chunk=8, rng_seed=0)
    port = _engine(reference)
    try:
        for engine, faults in ((jax_engine, jax_faults),
                               (port, fault_injection)):
            before = [engine.generate(p, max_new_tokens=_NEW,
                                      timeout=300)[0] for p in PROMPTS]
            # Warm (the JAX engine compiled its steps): the watchdog
            # starts with the next submit.
            engine.watchdog_timeout = _WATCHDOG
            _wedge_and_recover(engine, faults, _WATCHDOG + _SLACK_S)
            after = [engine.generate(p, max_new_tokens=_NEW,
                                     timeout=120)[0] for p in PROMPTS]
            assert before == after == reference['tokens']
            assert engine._generation == 1  # pylint: disable=protected-access
        _wait(lambda: port.watchdog_stats['stale_exits'] == 1, 30.0,
              'the abandoned engine thread to exit')
        port._pool.check()  # pylint: disable=protected-access
    finally:
        jax_faults.disarm_all()
        fault_injection.disarm_all()
        jax_engine.stop()
        port.stop()


def test_recoveries_racing_submits_resolve_every_request(reference):
    """Recoveries forced while the engine thread ticks (a slow tick the
    watchdog mistook for a wedge) race submits from more threads than
    cores, with a short switch interval: every request resolves, either
    with the untouched tokens or with EngineWedgedError, and the current
    world's pool balances back to the scratch block."""
    engine = _engine(reference)
    futures, lock = [], threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submit_some(k):
            for i in range(3):
                future = engine.submit(PROMPTS[(k + i) % 2],
                                       max_new_tokens=_NEW)
                with lock:
                    futures.append(((k + i) % 2, future))

        def recover_some():
            for _ in range(4):
                time.sleep(0.005)
                engine._recover_from_wedge('forced by the test')  # pylint: disable=protected-access

        threads = [threading.Thread(target=submit_some, args=(k,))
                   for k in range((os.cpu_count() or 4) + 2)]
        threads.append(threading.Thread(target=recover_some))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    try:
        assert futures
        for which, future in futures:
            try:
                tokens, _ = future.result(timeout=60)
            except exceptions.EngineWedgedError:
                continue
            assert tokens == reference['tokens'][which]
        assert engine._generation == 4  # pylint: disable=protected-access
        tokens, _ = engine.generate(PROMPTS[0], max_new_tokens=_NEW,
                                    timeout=60)
        assert tokens == reference['tokens'][0]
        _wait(lambda: not engine._busy(), 30.0, 'the engine to idle')  # pylint: disable=protected-access
        engine._pool.check()  # pylint: disable=protected-access
        assert engine._pool.used == 1  # pylint: disable=protected-access
    finally:
        engine.stop()


# ---------------------------------------------------------------------
# fault points
# ---------------------------------------------------------------------


def test_injection_points_inert_when_disarmed():
    """Disarmed (the default) every point is a no-op: nothing armed,
    nothing raised, nothing counted."""
    assert not fault_injection.armed()
    for name in fault_injection.KNOWN_POINTS:
        fault_injection.point(name)
        assert fault_injection.trip_count(name) == 0
    fault_injection.arm('engine.decode', 'fail:1')
    assert fault_injection.armed()
    fault_injection.disarm_all()
    assert not fault_injection.armed()
    fault_injection.point('engine.decode')
    assert fault_injection.trip_count('engine.decode') == 0


def test_slot_preempt_point_fires_in_the_preemption(reference):
    """`engine.slot_preempt` fires as an interactive arrival takes a
    batch slot: an armed failure fails the tick's in-flight work, and the
    engine serves on."""
    engine = _engine(reference, num_slots=1)
    fault_injection.arm('engine.slot_preempt', 'fail:1')
    try:
        started = []
        batch = engine.submit(PROMPTS[0], max_new_tokens=40,
                              priority='batch', on_token=started.append)
        _wait(lambda: len(started) >= 2, 60.0, 'the batch request')
        interactive = engine.submit(PROMPTS[1], max_new_tokens=_NEW,
                                    priority='interactive')
        for future in (batch, interactive):
            with pytest.raises(fault_injection.InjectedFault):
                future.result(timeout=60)
        assert fault_injection.trip_count('engine.slot_preempt') == 1
    finally:
        fault_injection.disarm_all()
    try:
        tokens, _ = engine.generate(PROMPTS[1], max_new_tokens=_NEW,
                                    timeout=60)
        assert tokens == reference['tokens'][1]
    finally:
        engine.stop()


def _random_adapter(cfg, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.standard_normal(v) * 0.05).astype(np.float32))
                for k, v in sorted(node.items())}
    return walk(adapter_layout(cfg))


@pytest.fixture()
def tenant_engine(reference):
    engine = _engine(reference, max_adapters=1, adapter_rank=4,
                     adapter_alpha=8.0, adapter_targets='q,v',
                     watchdog_timeout=_WATCHDOG)
    try:
        yield engine
    finally:
        fault_injection.disarm_all()
        engine.stop()


def test_adapter_load_point_fires_before_the_write(tenant_engine):
    engine = tenant_engine
    fault_injection.arm('tenant.adapter_load', 'fail:1')
    with pytest.raises(fault_injection.InjectedFault):
        engine.load_adapter('a0', _random_adapter(engine.cfg, 0))
    assert fault_injection.trip_count('tenant.adapter_load') == 1
    # Nothing claims residency for weights that did not land.
    assert engine.adapters_info()['resident'] == 0
    fault_injection.disarm_all()
    assert engine.load_adapter('a0', _random_adapter(engine.cfg, 0)) == 1
    assert engine.adapters_info()['resident'] == 1


def test_evict_point_fires_on_lru_eviction_and_unload(tenant_engine):
    engine = tenant_engine
    engine.load_adapter('a0', _random_adapter(engine.cfg, 0))
    fault_injection.arm('tenant.evict', 'fail:1')
    with pytest.raises(fault_injection.InjectedFault):
        engine.load_adapter('a1', _random_adapter(engine.cfg, 1))
    assert fault_injection.trip_count('tenant.evict') == 1
    fault_injection.arm('tenant.evict', 'fail:1')
    with pytest.raises(fault_injection.InjectedFault):
        engine.unload_adapter('a0')
    assert 'a0' in [a['name'] for a in engine.adapters_info()['adapters']]
    fault_injection.disarm_all()
    engine.unload_adapter('a0')
    assert 'a0' not in [a['name']
                        for a in engine.adapters_info()['adapters']]


def test_adapter_survives_a_recovery(tenant_engine):
    """A recovery drops residency and zeroes the stacks (the successor,
    before its first tick); a request naming the adapter re-loads it and
    decodes as before."""
    engine = tenant_engine
    engine.load_adapter('a0', _random_adapter(engine.cfg, 3))
    before, _ = engine.generate(PROMPTS[0], max_new_tokens=_NEW,
                                adapter='a0', timeout=60)
    _wedge_and_recover(engine, fault_injection, _WATCHDOG + _SLACK_S)
    _wait(lambda: engine.watchdog_stats['stale_exits'] == 1, 30.0,
          'the abandoned engine thread to exit')
    assert engine.adapters_info()['resident'] == 0
    base, _ = engine.generate(PROMPTS[1], max_new_tokens=_NEW, timeout=60)
    for _, _, stack in engine._lora_stacks:  # pylint: disable=protected-access
        assert not bool(stack.a[1:].any()) and not bool(stack.b[1:].any())
    del base
    after, _ = engine.generate(PROMPTS[0], max_new_tokens=_NEW,
                               adapter='a0', timeout=60)
    assert after == before
    assert engine.adapters_info()['resident'] == 1


def test_train_save_point_fires_before_anything_is_written(tmp_path):
    from skypilot_tpu_torch.train import checkpoints
    from skypilot_tpu_torch.train.trainer import (TrainConfig,
                                                  create_train_state)
    cfg = dataclasses.replace(get_config('test-tiny'), dtype='float32',
                              param_dtype='float32', remat=False)
    state = create_train_state(cfg, TrainConfig(total_steps=2), seed=0,
                               device='cpu')
    manager = checkpoints.CheckpointManager(str(tmp_path / 'ck'))
    fault_injection.arm('train.save', 'fail:1')
    try:
        with pytest.raises(fault_injection.InjectedFault):
            manager.save(1, state, force=True)
        assert fault_injection.trip_count('train.save') == 1
    finally:
        fault_injection.disarm_all()
    assert manager.all_steps() == []
    assert manager.save(1, state, force=True)
    assert manager.all_steps() == [1]


# ---------------------------------------------------------------------
# the command line (fault 7)
# ---------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def test_reference_command_line_starts_a_port_server():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.server',
         '--model', 'test-tiny', '--device', 'cpu', '--tokenizer', 'byte',
         '--paged-num-blocks', '64', '--request-timeout', '30',
         '--watchdog-timeout', '120', '--port', str(port)],
        cwd=_REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    url = f'http://127.0.0.1:{port}'
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            try:
                with urllib.request.urlopen(url + '/health',
                                            timeout=5) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, 'server did not come up'
            time.sleep(0.1)
        status, _, body = _post(url + '/generate',
                                {'prompt': 'hi', 'max_new_tokens': 3})
        assert status == 200 and len(body['token_ids'][0]) == 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
