"""Preemption-native elastic training on the port (train/elastic.py, the
extent-invariant step, `train.run --elastic`).

- In-process: surviving_extent, the preemption notice (SIGTERM, the lost
  `train.notice` fault, the remaining budget), the elastic.json sidecar
  and extent revalidation (the reference's unit tests' cases).
- The port's elastic step at dp=1 against the JAX package's
  `make_elastic_train_step` on a one-device mesh (canonical extent 4,
  test-tiny fp32, clipping active, attention 'xla' on both sides: the
  step's grouping and combine are under test, test_torch_train holds the
  flash path): loss and grad_norm within test_torch_train's 2e-5
  relative for 3 steps (the JAX step is not bit-comparable to the
  port's; each is bit-identical across its own extents).
- tests/torch_elastic_driver.py: the reference's storm (six
  incarnations dp 4 → 2 → 2 → 2 → 2 → 4 with its notices and faults) over
  gloo processes on the CPU: the extents, frontiers and lineage, every
  captured step bit-identical to the unpreempted run, the torn newest
  checkpoint's fallback, the gauges.
- `train.run --elastic --dp 2` in its own process: SIGTERM to rank 0
  alone stops both ranks at one step, which is saved, and exits 75; the
  relaunch at dp 1 resumes there and records the resize; a live extent
  that does not divide the canonical one is refused.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.parallel import train_mesh
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.observability import metrics as obs
from skypilot_tpu_torch.observability.exposition import (
    generate_latest, parse_prometheus_text)
from skypilot_tpu_torch.train import elastic, trainer
from skypilot_tpu_torch.train.checkpoints import CheckpointManager
from skypilot_tpu_torch.utils import fault_injection

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ the substrate

def test_surviving_extent():
    assert elastic.surviving_extent(4, 8) == 4
    assert elastic.surviving_extent(4, 3) == 2
    assert elastic.surviving_extent(4, 1) == 1
    assert elastic.surviving_extent(6, 5) == 3
    assert elastic.surviving_extent(8, 7) == 4
    for bad in ((4, 0), (0, 4)):
        with pytest.raises(ValueError):
            elastic.surviving_extent(*bad)


def test_notice_deliver_clear_and_budget(monkeypatch):
    notice = elastic.PreemptionNotice()
    assert not notice.pending() and notice.remaining_budget(30.0) == 30.0
    notice.deliver()
    assert notice.pending() and 29.0 < notice.remaining_budget(30.0) <= 30.0
    notice.clear()
    assert not notice.pending()
    monkeypatch.setenv('SKYTPU_TRAIN_PREEMPT_NOTICE_BUDGET', '7.5')
    assert elastic.notice_budget_seconds() == 7.5
    monkeypatch.setenv('SKYTPU_TRAIN_PREEMPT_NOTICE_BUDGET', 'soon')
    assert elastic.notice_budget_seconds() == 30.0


def test_sigterm_sets_the_flag_and_a_lost_notice_does_not():
    prev = signal.getsignal(signal.SIGTERM)
    try:
        notice = elastic.PreemptionNotice()
        notice.install_sigterm()
        fault_injection.arm('train.notice', 'fail:1')
        os.kill(os.getpid(), signal.SIGTERM)     # lost in delivery
        time.sleep(0.05)
        assert not notice.pending()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not notice.pending() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert notice.pending()
    finally:
        fault_injection.disarm_all()
        signal.signal(signal.SIGTERM, prev)


def test_sidecar_and_revalidation(tmp_path):
    ckpt = str(tmp_path)
    assert elastic.ElasticMeta.load(ckpt) is None
    meta = elastic.revalidate_extent(ckpt, 4, 4, 0)
    assert (meta.canonical_dp, meta.dp, meta.lineage) == (4, 4, [])
    # A rank other than the coordinator validates and writes nothing.
    elastic.revalidate_extent(ckpt, 4, 2, 3, coordinator=False)
    assert elastic.ElasticMeta.load(ckpt).dp == 4
    obs.enable()
    meta = elastic.revalidate_extent(ckpt, 4, 2, 3)
    meta = elastic.revalidate_extent(ckpt, 4, 4, 9)
    on_disk = elastic.ElasticMeta.load(ckpt)
    assert [(e['step'], e['from_dp'], e['to_dp']) for e in on_disk.lineage] \
        == [(3, 4, 2), (9, 2, 4)]
    with pytest.raises(ValueError, match='canonical extent 4, not 2'):
        elastic.revalidate_extent(ckpt, 2, 2, 10)
    with open(elastic.ElasticMeta.path(ckpt), 'w', encoding='utf-8') as f:
        f.write('{"canonical_dp": 4')              # torn
    assert elastic.ElasticMeta.load(ckpt) is None
    samples = parse_prometheus_text(generate_latest())[
        'skytpu_train_elastic_resizes_total']['samples']
    assert samples[('skytpu_train_elastic_resizes_total',
                    (('direction', 'down'),))] >= 1


# ------------------------------------------------- the step against JAX's

_KW = dict(dtype='float32', param_dtype='float32', remat=False,
           attention_impl='xla')
_TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
           grad_clip_norm=0.05)


def test_elastic_step_matches_the_jax_elastic_step():
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(3):
        tokens = rng.randint(0, 512, (8, 33)).astype(np.int32)
        mask = np.ones((8, 32), np.int32)
        mask[:, :rng.randint(3, 12)] = 0
        batches.append({'inputs': tokens[:, :-1], 'targets': tokens[:, 1:],
                        'mask': mask})
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    mesh = train_mesh(1)
    jstate, shardings = jtrainer.create_sharded_state(
        jcfg, mesh, jax.random.PRNGKey(0), jtrainer.TrainConfig(**_TC))
    params0 = jax.device_get(jstate.params)
    jstep = jtrainer.make_elastic_train_step(jcfg, mesh, shardings, 4)
    ref = []
    for batch in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        ref.append((float(m['loss']), float(m['grad_norm'])))
    cfg = get_config('test-tiny', **_KW)
    model = Transformer(cfg, device='cpu')
    model.load_state_dict(params_from_jax(params0, cfg, dtype='float32'))
    state = trainer.TrainState(model, trainer.TrainConfig(**_TC))
    step = trainer.make_elastic_train_step(4)
    for i, (batch, (ref_loss, ref_norm)) in enumerate(zip(batches, ref)):
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m['grad_norm']) > _TC['grad_clip_norm']
        np.testing.assert_allclose(float(m['loss']), ref_loss, rtol=2e-5,
                                   err_msg=f'loss, step {i}')
        np.testing.assert_allclose(float(m['grad_norm']), ref_norm,
                                   rtol=2e-5, err_msg=f'grad_norm, step {i}')
    with pytest.raises(ValueError, match='canonical_dp must be >= 1'):
        trainer.make_elastic_train_step(0)
    with pytest.raises(ValueError, match='not divisible by canonical_dp=3'):
        trainer.make_elastic_train_step(3)(
            state, {k: torch.from_numpy(v) for k, v in batches[0].items()})


# ----------------------------------------------------------- the storm

@pytest.fixture(scope='module')
def storm():
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, 'tests',
                                      'torch_elastic_driver.py')],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=_REPO), cwd=_REPO, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_storm_resumes_at_each_extent_and_frontier(storm):
    assert storm['clip_active'] and storm['dp_survive'] == 2
    assert [inc['dp'] for inc in storm['incarnations']] == [4, 2, 2, 4]
    assert all(inc['committed'] for inc in storm['incarnations'])
    assert storm['frontiers'] == [3, 5, 6, 8, 10, 12]
    assert storm['faults'] == {'killed_at_2': True, 'killed_at_3': True,
                               'notice_lost': True}
    assert storm['lineage'] == [[4, 2], [2, 4]] and storm['canonical'] == 4


def test_storm_loss_series_is_bit_identical_to_the_unpreempted_run(storm):
    assert storm['captured_steps'] == [0, 1, 2, 3, 4, 8, 9, 10, 11]
    assert storm['mismatches'] == [] and storm['final_parity']


def test_torn_newest_checkpoint_falls_back(storm):
    kept = storm['kept_steps']
    assert len(kept) >= 2 and storm['fallback_step'] in kept
    assert 0 < storm['fallback_step'] < kept[-1]


def test_storm_gauges(storm):
    assert storm['preemptions'] == 3.0
    assert storm['resizes_down'] == storm['resizes_up'] == 1.0
    assert storm['save_count'] >= 3.0 and storm['fallbacks'] >= 1.0


# ------------------------------------------------------------- train.run

def _run(ckpt, dp, steps):
    return [sys.executable, '-m', 'skypilot_tpu_torch.train.run',
            '--model', 'test-tiny', '--batch', '8', '--seq', '32',
            '--steps', str(steps), '--device', 'cpu', '--warmup-steps', '1',
            '--log-every', '1', '--elastic', '--dp', str(dp),
            '--checkpoint-dir', ckpt, '--checkpoint-every', '1000'] + (
                ['--zero1'] if dp > 1 else [])


def test_run_exits_75_on_sigterm_and_resumes_at_another_extent(tmp_path):
    ckpt = str(tmp_path / 'ckpt')
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.Popen(_run(ckpt, 2, 400), stderr=subprocess.PIPE,
                            text=True, env=env, cwd=_REPO)
    lines = []
    for line in proc.stderr:
        lines.append(line)
        if 'step 3/400' in line:
            proc.send_signal(signal.SIGTERM)       # rank 0 alone
            break
    lines += proc.stderr.readlines()
    assert proc.wait(timeout=120) == 75, ''.join(lines[-30:])
    log = ''.join(lines)
    step = CheckpointManager(ckpt).latest_step()
    assert step >= 4
    assert f'preempted at step {step}: checkpoint committed' in log
    assert sorted(os.listdir(os.path.join(ckpt, str(step)))) == [
        'moments-0-of-2.pt', 'moments-1-of-2.pt', 'state.pt']
    # The relaunch at the surviving extent resumes at the saved step.
    resumed = subprocess.run(_run(ckpt, 1, step + 2), capture_output=True,
                             text=True, env=env, cwd=_REPO, timeout=120,
                             check=False)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert f'resumed from step {step}' in resumed.stderr
    meta = elastic.ElasticMeta.load(ckpt)
    assert meta.canonical_dp == 2 and [
        (e['step'], e['from_dp'], e['to_dp']) for e in meta.lineage] == [
            (step, 2, 1)]
    assert CheckpointManager(ckpt).latest_step() == step + 2
    # A live extent that does not divide the canonical one.
    refused = subprocess.run(_run(ckpt, 4, step + 4), capture_output=True,
                             text=True, env=env, cwd=_REPO, timeout=120,
                             check=False)
    assert refused.returncode == 1
    assert "live dp=4 must divide the run's canonical extent 2" in \
        refused.stderr
