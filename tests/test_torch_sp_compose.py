"""The sequence ring composed with the other training axes on the port:
`--dp` x `--sp`, `--sp` beside fsdp (the long-context recipe's layout),
MoE and LoRA under `--sp`, and the MoE routing groups of a sharded
batch, against the JAX package's single-device train step.

- The step: tests/torch_sp_compose_driver.py trains test-tiny (fp32,
  clipping active) from the JAX init's weights on masked batches of
  B 8 x S 32, 3 steps at dp 2 x sp 2 and sp 2 x fsdp 2 (each also with
  grad_accum 2), ZeRO-1 at dp 2 x sp 2, LoRA on q,v and on all seven
  targets under sp 2, and test-tiny-moe at capacity factor 0.5 (its
  assignments drop) under sp 2, dp 2 x sp 2, dp 2 and fsdp 2, in gloo
  processes on the CPU: every step's loss and grad_norm within 2e-5
  relative of the JAX single-device `make_train_step` (the port's ring
  against the reference's flash attention: fp32 sums in other orders).
  The reference groups a MoE batch over its whole batch in global token
  order; a rank that grouped only its own rows or columns would drop
  other assignments and miss by far more than 2e-5.
- The per-rank ring over a dp 2 x sp 2 group's `ring` equals the
  one-process ring on the rank's rows bit for bit (output, dq, dk, dv),
  its hops counted as 'collective_permute'.
- The collectives of one step at L layers, A microbatches: per
  microbatch a ring of sp rotates K/V sp times a layer forward and sp
  times (K/V and their gradients) backward, again in a remat recompute:
      collective_permute = A L sp (2 + remat)    (0 off the ring)
  beside the group's sums (one all-reduce; fsdp: its gathers and
  reduce-scatters as tests/test_torch_fsdp.py counts them, the peers'
  sum and the whole group's) and a MoE model's routing: one all-gather
  of the top-k indices a MoE layer each forward.
- Checkpoints: saved at dp 2 x sp 2 under ZeRO-1 and at sp 2 x fsdp 2
  (one writer per (dp, fsdp) index), restored at sp 2 x fsdp 2, dp 2 x
  sp 2, dp 2 and on one rank, each holding the saved params bit for bit
  and continuing within 2e-5 of the unbroken run.
- train.run: four processes joined by torchrun's variables with `--sp 2`
  train on sp 2 x fsdp 2 (the remainder on fsdp, as the reference's
  mesh puts it); the refusals that stay keep the reference's messages.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.parallel import MeshConfig, build_mesh
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.parallel import mesh
from skypilot_tpu_torch.train import metrics as metrics_lib
from skypilot_tpu_torch.train import run
from test_torch_dp import _masked_batches
from test_torch_train import _KW, _TC

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOL = 2e-5
_LORA = dict(lora_rank=4, lora_alpha=8.0, lora_targets='q,v')
_LORA_ALL = dict(_LORA, lora_targets='q,k,v,o,gate,up,down')
_MOE = dict(moe_capacity_factor=0.5)
# The JAX inits by name (model, config overrides), and the JAX runs by
# name (init, grad_accum).
_WEIGHTS = {'plain': ('test-tiny', {}), 'lora': ('test-tiny', _LORA),
            'lora_all': ('test-tiny', _LORA_ALL),
            'moe': ('test-tiny-moe', _MOE)}
_RUNS = {'plain': ('plain', 1), 'accum2': ('plain', 2), 'lora': ('lora', 1),
         'lora_all': ('lora_all', 1), 'moe': ('moe', 1)}


def _drops(cfg, state, batch) -> int:
    """Assignments the reference's capacity drops in the first layer's
    MoE block on `batch`, grouped over the whole batch."""
    model = Transformer(cfg, device='cpu')
    model.load_state_dict(state)
    seen = []
    model.layers[0].moe.register_forward_pre_hook(
        lambda _, args: seen.append(args[0]))
    with torch.no_grad():
        model(torch.from_numpy(batch['inputs']))
    x = seen[0]
    idx, _ = moe.route(x, model.layers[0].moe.router,
                       cfg.experts_per_token)
    g = idx.shape[0] * idx.shape[1]
    gs = moe.group_size(g)
    cap = moe.capacity(gs, cfg.experts_per_token, cfg.num_experts,
                       cfg.moe_capacity_factor)
    pos = moe.positions(idx.reshape(g // gs, gs, -1), cfg.num_experts)
    return int((pos >= cap).sum())


def _jax_init(model, over):
    """The JAX single-device train state of test_torch_train's config
    (`over` on top), its mesh and shardings."""
    jcfg = dataclasses.replace(jax_get_config(model), **_KW, **over)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    state, shardings = jtrainer.create_sharded_state(
        jcfg, mesh, jax.random.PRNGKey(0), jtrainer.TrainConfig(**_TC))
    return jcfg, mesh, state, shardings


def _jax_steps(init, batches, grad_accum):
    """(loss, grad_norm) of the JAX step on each batch from `init` (a
    copy of its state: the step donates its input)."""
    jcfg, mesh, state, shardings = init
    state = jax.tree.map(jnp.copy, state)
    step = jtrainer.make_train_step(jcfg, mesh, shardings,
                                    grad_accum=grad_accum)
    metrics = []
    with mesh:
        for batch in batches:
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            metrics.append((float(m['loss']), float(m['grad_norm'])))
    return metrics


@pytest.fixture(scope='module')
def compose_row(tmp_path_factory):
    """(the JAX runs by name, the MoE weights' drops, the driver's row).
    The driver trains from the JAX inits' weights while the JAX steps
    run here."""
    tmp = tmp_path_factory.mktemp('sp_compose')
    batches = _masked_batches()
    inits, weights, configs = {}, {}, {}
    for name, (model, over) in _WEIGHTS.items():
        inits[name] = _jax_init(model, over)
        cfg = get_config(model, **_KW, **over)
        path = tmp / f'{name}.pt'
        torch.save(params_from_jax(jax.device_get(inits[name][2].params),
                                   cfg, dtype='float32'), path)
        weights[name], configs[name] = str(path), (model, {**_KW, **over})
    np.savez(tmp / 'batches.npz', **{f'{k}{i}': v for i, b in
                                     enumerate(batches) for k, v in b.items()})
    os.makedirs(tmp / 'ckpt')
    spec = {'weights': weights, 'configs': configs, 'tc': _TC,
            'batches': str(tmp / 'batches.npz'), 'ckpt': str(tmp / 'ckpt')}
    proc = subprocess.Popen(
        [sys.executable, os.path.join(_REPO, 'tests',
                                      'torch_sp_compose_driver.py'),
         json.dumps(spec)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=_REPO), cwd=_REPO)
    try:
        ref = {name: _jax_steps(inits[weights_of], batches, accum)
               for name, (weights_of, accum) in _RUNS.items()}
        moe_cfg = get_config('test-tiny-moe', **_KW, **_MOE)
        drops = _drops(moe_cfg, torch.load(weights['moe'],
                                           weights_only=True), batches[0])
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return ref, drops, json.loads(out.strip().splitlines()[-1])


_REFS = {'dp2xsp2': 'plain', 'dp2xsp2/accum2': 'accum2',
         'sp2xfsdp2': 'plain', 'sp2xfsdp2/accum2': 'accum2',
         'dp2xsp2/zero1': 'plain', 'sp2/lora': 'lora',
         'sp2/lora-all': 'lora_all', 'sp2/moe': 'moe', 'dp2xsp2/moe': 'moe'}


def _hold(ranks, ref):
    series = ranks[0]['series']
    assert all(r['series'] == series for r in ranks), 'ranks disagree'
    for i, ((loss, norm), (ref_loss, ref_norm)) in enumerate(
            zip(series, ref)):
        assert norm > _TC['grad_clip_norm']              # clipping active
        np.testing.assert_allclose(loss, ref_loss, rtol=_TOL,
                                   err_msg=f'loss, step {i}')
        np.testing.assert_allclose(norm, ref_norm, rtol=_TOL,
                                   err_msg=f'grad_norm, step {i}')


@pytest.mark.parametrize('case', sorted(_REFS))
def test_composed_steps_match_the_jax_train_step(compose_row, case):
    ref, drops, row = compose_row
    if 'moe' in case:
        assert drops > 0
    _hold(row['steps'][case], ref[_REFS[case]])


@pytest.mark.parametrize('case', ['dp2/moe', 'fsdp2/moe'])
def test_moe_groups_span_the_ranks_as_the_reference_s(compose_row, case):
    """A MoE model under --dp and under fsdp routes over the
    whole batch (the reference's groups and capacity), not over each
    rank's rows; at capacity factor 0.5 assignments drop, so per-rank
    groups would keep others."""
    ref, drops, row = compose_row
    assert drops > 0
    _hold(row['steps'][case], ref['moe'])
    for rank in row['steps'][case]:
        # One all-gather of the top-k indices a MoE layer (no remat).
        assert rank['probe']['all_gather'] >= rank['layers']


@pytest.mark.parametrize('case,accum,sp,fsdp,dp,zero1', [
    ('dp2xsp2', 1, 2, 1, 2, False), ('dp2xsp2/accum2', 2, 2, 1, 2, False),
    ('sp2xfsdp2', 1, 2, 2, 1, False), ('sp2xfsdp2/accum2', 2, 2, 2, 1,
                                       False),
    ('dp2xsp2/zero1', 1, 2, 1, 2, True), ('dp2/moe', 1, 1, 1, 2, False)])
def test_collectives_follow_the_formula(compose_row, case, accum, sp, fsdp,
                                        dp, zero1):
    for rank in compose_row[2]['steps'][case]:
        layers = rank['layers']
        probe = rank['probe']
        assert probe['collective_permute'] == (
            accum * layers * sp * 2 if sp > 1 else 0)
        if 'moe' in case:
            continue
        if fsdp > 1:
            assert probe['all_gather'] == accum * (2 * layers + 2)
            assert probe['reduce_scatter'] == accum * (layers + 2)
            # The peers' sum of the slices, then the whole group's.
            assert probe['all_reduce'] == 2
        else:
            # One sum over the whole group (ZeRO-1: its partition
            # scatter, then the params' all-gather over the dp row).
            assert probe['all_reduce'] == (0 if zero1 else 1)
            assert probe['partition_scatter'] == (1 if zero1 else 0)
            assert probe['all_gather'] == (1 if zero1 else 0)
            assert probe['reduce_scatter'] == 0


def test_per_rank_ring_is_the_one_process_ring_bit_for_bit(compose_row):
    ranks = compose_row[2]['ring']['ranks']
    assert len(ranks) == 4
    for rank in ranks:
        assert rank['equal'] == [True] * 4
        # sp 2: two rotations forward, two backward.
        assert rank['hops'] == 4


@pytest.mark.parametrize('saved,target', [
    (s, t) for s in ('zero1', 'fsdp')
    for t in ('sp2xfsdp2', 'dp2xsp2/zero1', 'dp2', 'one')])
def test_checkpoints_restore_across_layouts(compose_row, saved, target):
    ckpt = compose_row[2]['ckpt']
    got = ckpt[f'{saved}->{target}']
    assert got['params_equal'] and got['count'] == 1
    unbroken = ckpt[f'{saved}/unbroken']
    if (saved, target) in (('zero1', 'dp2xsp2/zero1'),
                           ('fsdp', 'sp2xfsdp2')):
        assert got['series'] == unbroken            # the saved layout
    np.testing.assert_allclose(got['series'], unbroken, rtol=_TOL)


def test_one_writer_per_dp_and_fsdp_index(compose_row):
    ckpt = compose_row[2]['ckpt']
    assert ckpt['zero1/files'] == ['moments-0-of-2.pt', 'moments-1-of-2.pt',
                                   'state.pt']
    assert ckpt['fsdp/files'] == ['shard-0-of-2.pt', 'shard-1-of-2.pt',
                                  'state.pt']


# ------------------------------------------------------------ train.run

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


def test_torchrun_sp2_on_four_processes_is_sp2_beside_fsdp2(tmp_path):
    """The long-context recipe's layout: four processes joined by
    torchrun's variables with --sp 2 train on sp 2 x fsdp 2, every rank
    reporting the same losses, the ring's hops in the probe, the slices
    saved by one writer per fsdp index."""
    argv = ['--model', 'test-tiny', '--batch', '4', '--seq', '32',
            '--steps', '2', '--device', 'cpu', '--warmup-steps', '1',
            '--learning-rate', '1e-3', '--probe-hlo', '--sp', '2',
            '--checkpoint-dir', str(tmp_path / 'ckpt')]
    assert run._job_mesh(run.build_parser().parse_args(argv), 4) == \
        mesh.MeshConfig(fsdp=2, sp=2)  # pylint: disable=protected-access
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS='1')
    port = _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, '-c', _RUN_WORKER, json.dumps(argv),
         str(tmp_path / f'rank{rank}.json')],
        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE='4',
                 MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port)), cwd=_REPO)
        for rank in range(4)]
    for proc in ranks:
        assert proc.wait(timeout=180) == 0
    runs = [json.loads((tmp_path / f'rank{r}.json').read_text())
            for r in range(4)]
    assert all([h['loss'] for h in r] == [h['loss'] for h in runs[0]]
               for r in runs)
    assert all(np.isfinite(h['loss']) for h in runs[0])
    layers = get_config('test-tiny').num_layers
    probe = runs[0][0]['step_collectives']
    assert probe['collective_permute'] == layers * 2 * 2
    assert probe['all_gather'] == 2 * layers + 2
    assert sorted(os.listdir(tmp_path / 'ckpt' / '2')) == [
        'shard-0-of-2.pt', 'shard-1-of-2.pt', 'state.pt']


_BASE = ['--model', 'test-tiny', '--seq', '32', '--steps', '1', '--device',
         'cpu']


@pytest.mark.parametrize('extra,message', [
    (['--batch', '4', '--sp', '2', '--dp', '2', '--elastic',
      '--checkpoint-dir', 'x'], '--elastic composes with dp/ZeRO-1 only'),
    (['--batch', '4', '--sp', '3'], 'divisible by --sp 3'),
    (['--batch', '6', '--dp', '4', '--sp', '2'],
     r'must be divisible by dp\*fsdp = 4'),
], ids=['elastic-sp', 'seq', 'batch'])
def test_refusals_that_stay(extra, message):
    with pytest.raises(SystemExit, match=message):
        run.main(_BASE + extra)


def test_a_sliding_window_is_refused_on_the_ring():
    from skypilot_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError) as got:
        fa.flash_attention(q, q, q, window=4, impl='ring')
    assert str(got.value) == (
        'window is not supported on the ring path; a sliding window makes '
        'ring rotation unnecessary — shard the sequence instead.')


def test_the_probe_publishes_collective_permute():
    from skypilot_tpu_torch.observability import metrics as obs
    from skypilot_tpu_torch.observability.exposition import (
        generate_latest, parse_prometheus_text)
    was = obs.enabled()
    obs.enable()
    try:
        metrics_lib.publish_step_collectives(
            {'all_reduce': 1, 'all_gather': 0, 'reduce_scatter': 0,
             'partition_scatter': 0, 'collective_permute': 12,
             'reduce_scatter_effective': 0})
        samples = parse_prometheus_text(generate_latest())[
            'skytpu_train_step_collectives']['samples']
    finally:
        if not was:
            obs.disable()
    name = 'skytpu_train_step_collectives'
    assert samples[(name, (('op', 'collective_permute'),))] == 12
    assert samples[(name, (('op', 'all_reduce'),))] == 1
