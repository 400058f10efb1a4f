"""Data-parallel training on the port (`--dp`): the mesh and the group,
the dp train step against the JAX package's single-device train step, and
`train.run --dp` in its two launch forms.

- parallel/mesh.py: `infer_mesh_config` with dp (a remainder the
  reference would send to fsdp is refused, naming fsdp), `train_group`'s
  refusals and its group of one.
- The dp step: tests/torch_dp_driver.py trains test-tiny (fp32, attention
  through the plain pair, clipping active) from the JAX init's weights on
  masked batches of B 8 × S 32, 3 steps at dp 2 and dp 4, grad_accum 1 and
  2, ZeRO-1 off and on, in gloo processes on the CPU. Every step's loss
  and grad_norm are within test_torch_train's 2e-5 relative of the JAX
  single-device `make_train_step` (no mesh needed), ZeRO-1 on and off
  bit-identical, and a step makes one gradient collective, not one per
  microbatch.
- train.run: `--dp 2 --zero1 --probe-hlo` started from one process (it
  starts rank 1) against the same command in two processes joined by
  torchrun's variables: the same history and the same checkpoint, bit for
  bit; the parse-time refusals; the spawned rank runs in the caller's
  working directory (a relative --checkpoint-dir is one directory).
- A group marked broken refuses every collective.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.parallel import mesh
from skypilot_tpu_torch.train import run
from test_torch_train import _KW, _TC, _jax_run

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_B, _S = 8, 32


def test_infer_mesh_config_with_dp():
    assert mesh.infer_mesh_config(2, dp=2) == mesh.MeshConfig(dp=2)
    assert mesh.infer_mesh_config(4, dp=2, sp=2) == mesh.MeshConfig(dp=2,
                                                                     sp=2)
    assert str(mesh.MeshConfig(dp=2)) == 'MeshConfig(dp=2)'
    with pytest.raises(ValueError, match=r'fsdp=2\); the port has no fsdp '
                       r'axis \(ROADMAP.md §1 item 6: fsdp'):
        mesh.infer_mesh_config(4, dp=2)
    with pytest.raises(ValueError, match="axes {'sp': None, 'dp': 3} do "
                       "not divide 4"):
        mesh.infer_mesh_config(4, dp=3)


def test_train_group_refusals_and_a_group_of_one():
    with pytest.raises(ValueError, match='dp=0'):
        mesh.train_group(0, device='cpu')
    with pytest.raises(ValueError, match="names one card twice, which only "
                       "backend='gloo' runs"):
        mesh.train_group(2, devices=['cuda:0', 'cuda:0'], backend='nccl')
    with pytest.raises(ValueError, match='needs the target'):
        mesh.train_group(2, device='cpu')
    one = mesh.train_group(1, device='cpu')
    assert (one.dp, one.rank, one.device) == (1, 0, torch.device('cpu'))
    assert one.any(True) and not one.any(False)
    assert one.gather_object('x') == ['x']
    assert one.counts() == dict.fromkeys(mesh.STEP_COLLECTIVES, 0)


def _masked_batches(n=3, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, 512, (_B, _S + 1)).astype(np.int32)
        mask = np.ones((_B, _S), np.int32)
        mask[:, :rng.randint(3, 12)] = 0
        mask[5] = 0                       # a row with no loss at all
        out.append({'inputs': tokens[:, :-1], 'targets': tokens[:, 1:],
                    'mask': mask})
    return out


@pytest.fixture(scope='module')
def dp_runs(tmp_path_factory):
    """(the JAX runs by grad_accum, the driver's row)."""
    tmp = tmp_path_factory.mktemp('dp')
    batches = _masked_batches()
    ref = {}
    for accum in (1, 2):
        params0, metrics, _ = _jax_run(batches, accum)
        ref[accum] = metrics
    cfg = get_config('test-tiny', **_KW)
    torch.save(params_from_jax(params0, cfg, dtype='float32'),
               tmp / 'params.pt')
    np.savez(tmp / 'batches.npz', **{f'{k}{i}': v for i, b in
                                     enumerate(batches) for k, v in b.items()})
    spec = {'cfg': _KW, 'tc': _TC, 'params': str(tmp / 'params.pt'),
            'batches': str(tmp / 'batches.npz')}
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, 'tests', 'torch_dp_driver.py'),
         'jax', json.dumps(spec)], capture_output=True, text=True,
        timeout=240, env=dict(os.environ, PYTHONPATH=_REPO), cwd=_REPO,
        check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ref, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('dp', [2, 4])
@pytest.mark.parametrize('accum', [1, 2])
def test_dp_steps_match_the_jax_train_step(dp_runs, dp, accum):
    ref, row = dp_runs
    plain, plain_probe = row[str(dp)][f'{accum}/0']
    zero, zero_probe = row[str(dp)][f'{accum}/1']
    assert plain == zero
    for i, ((loss, norm), (ref_loss, ref_norm)) in enumerate(
            zip(plain, ref[accum])):
        assert norm > _TC['grad_clip_norm']              # clipping active
        np.testing.assert_allclose(loss, ref_loss, rtol=2e-5,
                                   err_msg=f'loss, step {i}')
        np.testing.assert_allclose(norm, ref_norm, rtol=2e-5,
                                   err_msg=f'grad_norm, step {i}')
    # One gradient collective a step, whatever grad_accum is.
    assert plain_probe['all_reduce'] == 1
    assert zero_probe['partition_scatter'] == zero_probe['all_gather'] == 1


# ---------------------------------------------------------- train.run

_RUN_WORKER = r'''
import json, sys
from skypilot_tpu_torch.train import run
history = []
assert run.main(json.loads(sys.argv[1]), history=history) == 0
with open(sys.argv[2], 'w') as f:
    json.dump(history, f)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _args(tmp_path, name):
    return ['--model', 'test-tiny', '--batch', '4', '--seq', '32',
            '--steps', '3', '--dp', '2', '--zero1', '--probe-hlo',
            '--device', 'cpu', '--warmup-steps', '1', '--learning-rate',
            '1e-3', '--checkpoint-dir', str(tmp_path / name),
            '--checkpoint-every', '100']


def _saved(tmp_path, name):
    step = os.path.join(tmp_path, name, '3')
    return (torch.load(os.path.join(step, 'state.pt'), weights_only=True),
            sorted(os.listdir(step)))


def test_spawned_and_torchrun_ranks_train_the_same(tmp_path):
    # One intra-op thread a process: the four processes share the CPU, and
    # a multi-threaded CPU kernel may then split a bf16 sum differently
    # from run to run (seen once in ten runs at 8 threads), which no
    # launch form controls.
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS='1')
    spawned = subprocess.Popen(
        [sys.executable, '-c', _RUN_WORKER,
         json.dumps(_args(tmp_path, 'spawned')),
         str(tmp_path / 'spawned.json')], env=env, cwd=_REPO)
    port = _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, '-c', _RUN_WORKER,
         json.dumps(_args(tmp_path, 'ranks')),
         str(tmp_path / f'rank{rank}.json')],
        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE='2',
                 MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port)), cwd=_REPO)
        for rank in range(2)]
    for proc in [spawned] + ranks:
        assert proc.wait(timeout=180) == 0
    runs = {name: json.loads((tmp_path / f'{name}.json').read_text())
            for name in ('spawned', 'rank0', 'rank1')}
    strip = [{k: v for k, v in h.items() if k != 'step_s'}
             for h in runs['spawned']]
    assert strip == [{k: v for k, v in h.items() if k != 'step_s'}
                     for h in runs['rank0']]
    assert [h['loss'] for h in runs['rank1']] == [h['loss'] for h in strip]
    first = strip[0]
    assert first['step_collectives'] == {
        'all_reduce': 0, 'all_gather': 1, 'reduce_scatter': 0,
        'partition_scatter': 1, 'reduce_scatter_effective': 1}
    assert first['opt_state_bytes_per_device'] <= \
        (1 / 2 + 0.05) * first['opt_state_bytes']
    (spawned_state, files), (ranks_state, ranks_files) = (
        _saved(tmp_path, 'spawned'), _saved(tmp_path, 'ranks'))
    assert files == ranks_files == ['moments-0-of-2.pt', 'moments-1-of-2.pt',
                                    'state.pt']
    assert spawned_state['zero1'] == ranks_state['zero1']
    for name, value in spawned_state['model'].items():
        assert torch.equal(value, ranks_state['model'][name]), name


def test_spawned_ranks_share_the_callers_relative_paths(tmp_path):
    # The spawned rank runs in the caller's working directory, so a
    # relative --checkpoint-dir names one directory on both ranks.
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.run', '--model',
         'test-tiny', '--batch', '4', '--seq', '32', '--steps', '2',
         '--device', 'cpu', '--dp', '2', '--zero1', '--checkpoint-dir',
         'ckpt', '--checkpoint-every', '1'],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS='1'),
        check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / 'ckpt' / '2')) == [
        'moments-0-of-2.pt', 'moments-1-of-2.pt', 'state.pt']
    assert not os.path.exists(os.path.join(_REPO, 'ckpt'))


def test_a_broken_group_refuses_collectives():
    group = mesh.TrainGroup(2, 0, torch.device('cpu'),
                            broken='a save outlived its deadline')
    for call in (group.barrier, lambda: group.any(True),
                 lambda: group.all_reduce(torch.ones(2)),
                 lambda: group.gather_object(1), lambda: group.split(1)):
        with pytest.raises(RuntimeError, match='outlived its deadline'):
            call()


_BASE = ['--model', 'test-tiny', '--seq', '32', '--steps', '1', '--device',
         'cpu']


@pytest.mark.parametrize('extra,message', [
    (['--batch', '4', '--zero1'], r'--zero1 shards the optimizer state over '
     r'the dp axis, but the mesh is MeshConfig\(1 device\) \(dp=1\)'),
    (['--batch', '4', '--elastic', '--dp', '2'],
     '--elastic requires --checkpoint-dir'),
    (['--batch', '4', '--elastic', '--checkpoint-dir', 'x'],
     '--elastic requires an explicit --dp'),
    (['--batch', '4', '--elastic', '--dp', '2', '--checkpoint-dir', 'x',
      '--grad-accum', '2'], '--elastic composes with dp/ZeRO-1 only'),
    (['--batch', '4', '--elastic', '--dp', '2', '--checkpoint-dir', 'x',
      '--lora-rank', '4'], '--elastic composes with dp/ZeRO-1 only'),
    (['--batch', '4', '--dp', '2', '--sp', '2'],
     r'--dp with --sp is not ported \(ROADMAP.md §1 item 6'),
    (['--batch', '6', '--grad-accum', '2', '--dp', '2'],
     r'per-accumulation batch 3 \(--batch 6 / --grad-accum 2\) must be '
     r'divisible by dp = 2'),
    (['--batch', '4', '--dp', '0'], '--dp must be >= 1'),
], ids=['zero1-dp1', 'elastic-no-dir', 'elastic-no-dp', 'elastic-accum',
        'elastic-lora', 'dp-sp', 'batch', 'dp0'])
def test_run_refusals(extra, message):
    with pytest.raises(SystemExit, match=message):
        run.main(_BASE + extra)


def test_torchrun_without_an_axis_is_refused_naming_fsdp(monkeypatch):
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(SystemExit, match=r'2 processes need --sp 2 or --dp '
                       r'2: .*no fsdp axis'):
        run.main(_BASE + ['--batch', '4'])
