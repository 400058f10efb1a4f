"""The port's server drains on SIGTERM as the reference's does
(skypilot_tpu/serve/server.py `main`, its SIGTERM handler; contract
tests/test_chaos.py `test_graceful_drain_finishes_inflight_then_refuses`).

A subprocess serves test-tiny on the CPU. Once a long streamed request is
in flight it gets SIGTERM: /health answers 503 with Retry-After at once, a
new /generate is shed with 503, the in-flight request streams on to its
end with status 200, and the process exits 0. A second SIGTERM during the
drain waits for the drain's outcome and exits too. Every wait has its own
timeout, so the test can never hang the suite.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_START_S = 40.0       # process start, model build and warmup
_NEW_TOKENS = 500     # the in-flight request: seconds of CPU decode


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _get(url: str) -> tuple:
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _post(url: str, body: dict, timeout: float = 5):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    return urllib.request.urlopen(req, timeout=timeout)


def _start_server(port: int) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.server',
         '--model', 'test-tiny', '--device', 'cpu', '--port', str(port),
         '--max-seq-len', '1024', '--num-slots', '2', '--drain-timeout',
         '60'], cwd=_REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    deadline = time.monotonic() + _START_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f'server exited {proc.returncode}: '
                                 f'{proc.stderr.read()[-2000:]!r}')
        try:
            if _get(f'http://127.0.0.1:{port}/health')[0] == 200:
                return proc
        except OSError:
            pass
        time.sleep(0.1)
    proc.kill()
    raise AssertionError('server did not come up')


def _drain_case(second_sigterm: bool) -> None:
    port = _free_port()
    url = f'http://127.0.0.1:{port}'
    proc = _start_server(port)
    try:
        stream = _post(url + '/generate', {
            'prompt_ids': [[1, 2, 3]], 'max_new_tokens': _NEW_TOKENS,
            'stream': True}, timeout=30)
        assert stream.status == 200
        assert stream.readline().startswith(b'data: ')   # in flight
        proc.send_signal(signal.SIGTERM)
        status, headers, body = _get(url + '/health')
        assert (status, body) == (503, {'status': 'draining'})
        assert headers['Retry-After'] == '5'
        try:
            _post(url + '/generate', {'prompt_ids': [[4, 5]],
                                      'max_new_tokens': 4})
            raise AssertionError('a new request was admitted while draining')
        except urllib.error.HTTPError as e:
            assert e.code == 503 and e.headers['Retry-After']
        if second_sigterm:
            proc.send_signal(signal.SIGTERM)
        events = [json.loads(line[len(b'data: '):])
                  for line in stream.read().splitlines() if line]
        assert events[-1]['done'] is True
        assert events[-1]['stats']['new_tokens'] == _NEW_TOKENS
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_sigterm_drains_inflight_then_exits_zero():
    _drain_case(second_sigterm=False)


def test_second_sigterm_waits_for_the_drain_then_exits():
    _drain_case(second_sigterm=True)
