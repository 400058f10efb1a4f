"""Tensor-parallel serving on the port (parallel/mesh.decode_group, the
engines' `mesh=`, the server's --tp) on the CPU: tp=2 over two gloo
processes, test-tiny with 2 layers in fp32.

One driver subprocess (tests/torch_tp_driver.py) runs every engine check
and prints one JSON line; the tests below read it, as the reference's
TestShardedComposition reads tests/sharded_driver.py. The reference's
tp=2 cells are red in this sandbox, so the oracle is the JAX package's
single-device engine on the same seeded weights: for each of the
reference's eight cells, tp=2 greedy tokens must equal tp=1's and the
JAX engine's. The server and the follower life-cycle run in subprocesses
of their own here.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DRIVER_S = 280
# fp32 test-tiny: tp=2 sums each row-parallel product in two halves, so
# its logits and KV differ from tp=1's by rounding only (observed ~2e-6).
LOGIT_TOL = 1e-5
KV_TOL = 1e-5
CELLS = ('contig', 'paged', 'int8', 'paged-int8', 'spec', 'async3',
         'chunkedprefill', 'pallas-paged')
_NEXT_ITEM = 'ROADMAP.md §1 item 6'


@pytest.fixture(scope='module')
def driver():
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS='cpu')
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, 'tests', 'torch_tp_driver.py')],
        capture_output=True, text=True, timeout=_DRIVER_S, env=env,
        cwd=_REPO, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.deadline(60)
@pytest.mark.parametrize('cell', CELLS)
def test_tp2_tokens_equal_tp1_and_the_jax_engine(driver, cell):
    got = driver['cells'][cell]
    assert got['new_tokens'] == 16
    assert got['tp2'] == got['tp1'] == got['jax'], got


@pytest.mark.deadline(60)
def test_tp2_logits_and_kv_match_tp1_and_jax(driver):
    model = driver['model']
    assert model['tp2_vs_tp1'] <= LOGIT_TOL, model
    assert model['tp2_vs_jax'] <= LOGIT_TOL, model
    assert model['tp1_vs_jax'] <= LOGIT_TOL, model
    # Each rank's pool is tp=1's pool's slice of its KV heads.
    assert model['pool_vs_slice'] <= KV_TOL, model


@pytest.mark.deadline(60)
def test_a_forward_makes_two_allreduces_a_layer_and_two_more(driver):
    """o_proj and down_proj a layer, the embedding and the logits."""
    model = driver['model']
    assert model['collectives_per_two_forwards'] == \
        2 * (2 * model['layers'] + 2)
    gauges = driver['gauges']
    assert gauges['skytpu_engine_tp_collectives'] == 2 * model['layers'] + 2


@pytest.mark.deadline(60)
def test_async3_chains_and_steps_run_eagerly(driver):
    assert driver['cells']['async3']['chained'] > 0
    assert all(c['eager'] == 1 for c in driver['cells'].values())


@pytest.mark.deadline(60)
@pytest.mark.parametrize('trip', ['tp2_to_tp2', 'tp2_to_tp1', 'tp1_to_tp2'])
def test_prefix_artifact_round_trips_across_tp(driver, trip):
    rt = driver['roundtrip']
    assert rt['exported'] == 1 and rt['tp1_equals_tp2_cold']
    # The global block: the same bytes an artifact holds at any tp.
    assert rt['block_bytes'][0] == rt['block_bytes'][1]
    assert rt['artifact_sizes_equal']
    assert rt[trip] == {'imported': 1, 'blocks': 4, 'prewarm_hits': 1,
                        'match': True}


@pytest.mark.deadline(60)
def test_decode_chunk_and_a_slot_preemption_under_tp(driver):
    got = driver['compositions']
    assert got['chunk4_tp2'] == got['chunk4_tp1']
    assert got['chunk4_steps_tp2'] == got['chunk4_steps_tp1']
    batch, interactive, preempts = got['tiers_tp2']
    assert preempts >= 1 and len(batch) == 24
    assert got['tiers_tp2'] == got['tiers_tp1']
    assert interactive == driver['cells']['paged']['tp1'][:4]


@pytest.mark.deadline(60)
def test_contiguous_prefix_hit_and_recovery_reset_under_tp(driver):
    got = driver['contig_prefix']
    assert got['hits_before_recovery'] == 1
    # The recovery's fresh world: the third request misses again.
    assert got['stats']['hits'] == 1 and got['stats']['misses'] == 2
    assert got['equal']


@pytest.mark.deadline(60)
def test_per_device_weights_and_kv_at_most_055_of_tp1(driver):
    mem = driver['memory']
    assert mem['frac'] <= 0.55, mem
    assert mem['global_bytes'] == mem['single_device_bytes']


@pytest.mark.deadline(60)
def test_tp_gauges_survive_a_late_exporter(driver):
    gauges = driver['gauges']
    assert gauges['skytpu_engine_tp_size'] == 2
    assert gauges['skytpu_engine_tp_collectives'] > 0
    assert gauges['skytpu_engine_tp_allreduce_bytes'] > 0
    for device in ('0', '1'):
        assert gauges['skytpu_engine_paged_blocks_used_per_device'
                      f'{{device="{device}"}}'] >= 1
        assert gauges['skytpu_engine_paged_pool_bytes_per_device'
                      f'{{device="{device}"}}'] > 0


@pytest.mark.deadline(60)
def test_every_rank_makes_the_same_collectives(driver):
    for counts in (driver['counts'], driver['counts_after']):
        assert len(counts) == 2 and counts[0] == counts[1]
        assert counts[0]['collectives'] > 0


@pytest.mark.deadline(60)
def test_get_engine_serves_tp2(driver):
    got = driver['get_engine']
    assert got['tp'] == 2 and got['tokens'] == got['tp1']
    assert len(got['tokens'][0]) == 4


@pytest.mark.deadline(60)
@pytest.mark.parametrize('case,needle', [
    ('training', _NEXT_ITEM),
    ('lora_training', _NEXT_ITEM),
    ('tp_not_dividing', 'tp=3 does not divide'),
    ('more_cards_than_present', 'decode_mesh: tp=2 needs 1..0 local'),
    ('one_card_twice_on_nccl', "only backend='gloo'"),
])
def test_each_refusal_names_its_item(driver, case, needle):
    assert needle in (driver['refusals'][case] or ''), driver['refusals']
    if case in ('training', 'lora_training'):
        # A serving group does not train: a training model takes its
        # TrainGroup's tensor group.
        assert 'train_group(tp=)' in driver['refusals'][case]
    # A refusal sends nothing: the group serves the next engine.
    assert driver['after_refusals']


@pytest.mark.deadline(60)
def test_followers_import_no_jax_and_exit_with_the_group(driver):
    # Rank 0 is the test's driver (it runs the JAX oracle); the follower
    # imported nothing of jax, flax or the JAX package.
    assert driver['model']['follower_reference_modules'][1] == 0
    assert driver['followers_exited'] == [0]
    assert driver['jax_errors'] == []


# ------------------------------------------------------------- processes

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _children(pid: int) -> list:
    """Pids whose parent is `pid` (read from /proc)."""
    found = []
    for entry in os.listdir('/proc'):
        if not entry.isdigit():
            continue
        try:
            with open(f'/proc/{entry}/stat', encoding='utf-8') as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(')', 1)[1].split()[1]) == pid:
            found.append(int(entry))
    return found


def _alive(pid: int) -> bool:
    try:
        with open(f'/proc/{pid}/stat', encoding='utf-8') as f:
            return f.read().rsplit(')', 1)[1].split()[0] != 'Z'
    except OSError:
        return False


def _wait_gone(pids, timeout: float) -> list:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        left = [p for p in pids if _alive(p)]
        if not left:
            return []
        time.sleep(0.1)
    return [p for p in pids if _alive(p)]


@pytest.mark.deadline(150)
def test_server_tp2_answers_with_tp1_tokens_and_leaves_no_process():
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    port = _free_port()
    url = f'http://127.0.0.1:{port}'
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.server',
         '--model', 'test-tiny', '--device', 'cpu', '--port', str(port),
         '--max-seq-len', '128', '--num-slots', '2', '--tp', '2',
         '--drain-timeout', '30'], cwd=_REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    followers = []
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.stderr.read()[-3000:]
            assert time.monotonic() < deadline, 'server did not come up'
            try:
                with urllib.request.urlopen(url + '/health',
                                            timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            time.sleep(0.2)
        followers = _children(proc.pid)
        assert len(followers) == 1, followers
        prompt = [5, 17, 3, 99, 250, 7, 7, 31, 64, 2, 11]
        req = urllib.request.Request(
            url + '/generate', data=json.dumps({
                'prompt_ids': [prompt], 'max_new_tokens': 12}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())['token_ids'][0]
        with urllib.request.urlopen(url + '/metrics', timeout=10) as r:
            metrics = r.read().decode()
        assert 'skytpu_engine_tp_size 2' in metrics
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert _wait_gone(followers, 20) == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        for pid in followers:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
    # The same weights at tp=1 (the server's seed 0 and layout).
    engine = ContinuousBatchingEngine('test-tiny', max_seq_len=128,
                                      num_slots=2, paged_block_size=16,
                                      device='cpu')
    try:
        want, _ = engine.generate(prompt, max_new_tokens=12)
    finally:
        engine.stop()
    assert got == want


_TORCHRUN = '''
import json, os
import numpy as np
from skypilot_tpu_torch.models.inference import get_engine
engine = get_engine('test-tiny', max_seq_len=64, device='cpu')
rank = int(os.environ['RANK'])
# Every rank calls generate; rank 0's prompt is the one that runs.
prompt = np.ones((1, 4), np.int64) * (1 if rank == 0 else 7)
tokens, _ = engine.generate(prompt, max_new_tokens=4)
print(json.dumps({'rank': rank, 'tp': engine._tp,
                  'tokens': tokens.tolist()}), flush=True)
'''


@pytest.mark.deadline(90)
def test_get_engine_under_torchrun_takes_the_jobs_ranks(driver, tmp_path):
    script = tmp_path / 'serve_tp.py'
    script.write_text(_TORCHRUN)
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc-per-node',
         '2', '--master-port', str(_free_port()), str(script)],
        capture_output=True, text=True, timeout=80, env=env, cwd=_REPO,
        check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    decoder, text, found = json.JSONDecoder(), proc.stdout, []
    start = text.find('{')
    while start >= 0:
        obj, end = decoder.raw_decode(text, start)
        found.append(obj)
        start = text.find('{', end)
    want = driver['get_engine']['tp1']
    assert sorted(o['rank'] for o in found) == [0, 1]
    assert all(o['tp'] == 2 and o['tokens'] == want for o in found)


_ORPHAN = '''
import sys, time
from skypilot_tpu_torch.parallel.mesh import decode_group
group = decode_group(2, device='cpu', timeout_seconds=60)
print(group.processes[0].pid, flush=True)
time.sleep(600)
'''


@pytest.mark.deadline(90)
def test_a_follower_exits_when_rank0_is_killed():
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.Popen([sys.executable, '-c', _ORPHAN], cwd=_REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    follower = None
    try:
        follower = int(proc.stdout.readline())
        assert _alive(follower)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        assert _wait_gone([follower], 20) == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        if follower is not None and _alive(follower):
            os.kill(follower, signal.SIGKILL)
