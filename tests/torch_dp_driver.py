"""Data-parallel training and ZeRO-1 on the port, over gloo process groups
on the CPU.

This process is rank 0 of a group of 4 that `train_group` starts; the
other ranks run the same phases (`follower`), each phase on the group's
first dp ranks (`TrainGroup.split`). Usage:

    python tests/torch_dp_driver.py jax SPEC_JSON
    python tests/torch_dp_driver.py zero1 SPEC_JSON

`jax`: the weights in SPEC['params'] (a state dict carried across from
the JAX init) and the batches in SPEC['batches'] (npz) train 3 steps at
dp 2 and 4, grad_accum 1 and 2, ZeRO-1 off and on; the row holds every
run's (loss, grad_norm) series and the first step's collectives
(tests/test_torch_dp.py holds them against the JAX train step).

`zero1`: the reference's ZeRO-1 promises (tests/zero1_driver.py) on
test-tiny fp32 at dp=4 with clipping active: bit parity with ZeRO-1 on
and off at grad_accum 1 and 2, moments born as slices, bytes per rank,
the step's collectives, LoRA moments for the adapters only; checkpoints
a MoE model through the same step; checkpoints
saved at dp=4 restored onto dp=4, dp=2 and an unsharded state, a
truncated and a missing moment file refused; the gauges read by an
exporter enabled late (tests/test_torch_zero1.py asserts on the row).

Prints ONE JSON row.
"""
import glob
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_TARGET = 'torch_dp_driver:follower'
_KEPT = {}      # rank 0's ZeRO-1 state, for the gauges after the groups


def _cfg(over):
    from skypilot_tpu_torch.models.configs import get_config
    over = dict(over)
    return get_config(over.pop('model', 'test-tiny'), **over)


def _tc(spec):
    from skypilot_tpu_torch.train.trainer import TrainConfig
    return TrainConfig(**spec['tc'])


def _series(group, spec, accum, zero1, over=None, steps=3):
    """(loss, grad_norm) per step and the first step's collectives of a
    state built fresh on `group` from the spec's weights (or the seeded
    init)."""
    from skypilot_tpu_torch.train import trainer
    cfg = _cfg({**spec['cfg'], **(over or {})})
    state = trainer.create_train_state(cfg, _tc(spec), device='cpu', seed=0,
                                       group=group, zero1=zero1)
    if spec.get('params'):
        state.model.load_state_dict(torch.load(spec['params'],
                                               weights_only=True))
    step = trainer.make_train_step(grad_accum=accum)
    out, probe = [], None
    for i, batch in enumerate(_batches(spec)[:steps]):
        if i == 0:
            m, probe = trainer.step_collectives(step, state, batch)
        else:
            m = step(state, batch)
        out.append((float(m['loss']), float(m['grad_norm'])))
    return out, probe, state


def _batches(spec):
    if spec.get('batches'):
        raw = np.load(spec['batches'])
        return [{k: torch.from_numpy(raw[f'{k}{i}']) for k in
                 ('inputs', 'targets', 'mask')} for i in range(3)]
    out = []
    for i in range(3):
        tokens = np.random.RandomState(i).randint(0, 512, (16, 65))
        out.append({'inputs': torch.from_numpy(tokens[:, :-1]),
                    'targets': torch.from_numpy(tokens[:, 1:]),
                    'mask': torch.ones((16, 64), dtype=torch.int32)})
    return out


def _jax_phase(group, spec):
    return {f'{accum}/{int(zero1)}': _series(group, spec, accum, zero1)[:2]
            for accum in (1, 2) for zero1 in (False, True)}


def _whole_moments(group, state):
    """Rank 0: every leaf's whole moments, assembled from every rank's
    slices (None on the others)."""
    parts = group.gather_object({n: {k: v.clone() for k, v in m.items()}
                                 for n, m in state.moments().items()})
    if parts is None:
        return None
    whole = {}
    for name, dim in zip(state.names, state.zero_dims):
        whole[name] = {
            k: (v if dim is None or v.dim() == 0 else
                torch.cat([p[name][k] for p in parts], dim=dim))
            for k, v in parts[0][name].items()}
    return whole


def _equal_to(state, whole, params) -> bool:
    """Whether `state` holds `params` and this rank's layout of the whole
    moments `whole` bit for bit."""
    ok = all(torch.equal(p, params[n])
             for n, p in state.model.state_dict().items())
    mine = state.moments()
    ok = ok and set(mine) == set(whole)
    for name in whole:
        want = state.own_moments(name, whole[name])
        ok = ok and all(torch.equal(mine[name][k], want[k]) for k in want)
    return ok and state.count == 1


def _zero1_phase_a(group, spec):
    """dp=4: parity, born sharded, bytes, collectives, LoRA; the
    checkpoint at dp=4 and its restore onto dp=4."""
    from skypilot_tpu_torch.parallel.sharding import zero_update_dim
    from skypilot_tpu_torch.train import metrics as metrics_lib
    from skypilot_tpu_torch.train import trainer
    from skypilot_tpu_torch.train.checkpoints import CheckpointManager
    row = {}
    for accum in (1, 2):
        for zero1 in (False, True):
            series, probe, state = _series(group, spec, accum, zero1)
            row[f'series/{accum}/{int(zero1)}'] = series
            row[f'probe/{accum}/{int(zero1)}'] = probe
            if accum == 1:
                row[f'bytes/{int(zero1)}'] = list(
                    metrics_lib.opt_state_bytes(state))
            if accum == 1 and zero1:
                zero_state = _KEPT['zero_state'] = state
    row['dims'] = dict(zip(zero_state.names, zero_state.zero_dims))
    row['shapes'] = {n: list(p.shape) for n, p in
                     zip(zero_state.names, zero_state.params)}
    row['born_sliced'] = all(
        list(v.shape) == [s // group.dp if i == d else s
                          for i, s in enumerate(p.shape)]
        for p, d, u in zip(zero_state.params, zero_state.zero_dims,
                           zero_state.updated)
        for v in zero_state.optimizer.state[u].values() if v.dim())
    row['rule_dims'] = [zero_update_dim(p.shape, group.dp)
                        for p in zero_state.params]
    for zero1 in (False, True):
        series, probe, state = _series(group, spec, 1, zero1, steps=2,
                                       over={'lora_rank': 4})
        row[f'lora/{int(zero1)}'] = series
        if zero1:
            row['lora_moment_names'] = sorted(state.moments())
            row['lora_trained'] = sorted(state.names)
        row[f'moe/{int(zero1)}'] = _series(
            group, spec, 2, zero1, steps=2, over={'model': 'test-tiny-moe'})[0]
    # Checkpoints at dp=4: one trained step, saved as steps 1 and 2.
    state = trainer.create_train_state(_cfg(spec['cfg']), _tc(spec),
                                       device='cpu', seed=0, group=group,
                                       zero1=True)
    trainer.make_train_step()(state, _batches(spec)[0])
    manager = CheckpointManager(spec['ckpt'], save_interval_steps=1)
    manager.save(1, state, force=True)
    manager.save(2, state, force=True)
    whole = _whole_moments(group, state)
    params = {n: p.clone() for n, p in state.model.state_dict().items()}
    if group.rank == 0:
        torch.save({'moments': whole, 'params': params}, spec['reference'])
    group.barrier()
    template = trainer.create_train_state(_cfg(spec['cfg']), _tc(spec),
                                          device='cpu', seed=3, group=group,
                                          zero1=True)
    manager.restore(template, 2)
    ref = torch.load(spec['reference'], weights_only=True)
    row['same_dp_ranks'] = group.gather_object(
        _equal_to(template, ref['moments'], ref['params']))
    row['files'] = sorted(os.listdir(os.path.join(spec['ckpt'], '2')))
    return row


def _zero1_phase_b(group, spec):
    """dp=2: the dp=4 checkpoint restored onto a dp=2 ZeRO-1 state."""
    from skypilot_tpu_torch.train import metrics as metrics_lib
    from skypilot_tpu_torch.train import trainer
    from skypilot_tpu_torch.train.checkpoints import CheckpointManager
    template = trainer.create_train_state(_cfg(spec['cfg']), _tc(spec),
                                          device='cpu', seed=3, group=group,
                                          zero1=True)
    CheckpointManager(spec['ckpt']).restore(template, 2)
    ref = torch.load(spec['reference'], weights_only=True)
    return {'cross_dp_ranks': group.gather_object(
                _equal_to(template, ref['moments'], ref['params'])),
            'cross_dp_bytes': list(metrics_lib.opt_state_bytes(template))}


_PHASES = {'jax': _jax_phase, 'zero1_a': _zero1_phase_a,
           'zero1_b': _zero1_phase_b}


def _run_phases(world, phases: list) -> list:
    """Each (dp, phase, spec) of `phases` on the world's first dp ranks:
    this rank's results (None where it sat out). One intra-op thread a
    rank: four processes share the CPU, and a CPU kernel's threads may
    otherwise split a sum differently from run to run."""
    torch.set_num_threads(1)
    out = []
    for dp, mode, spec in phases:
        group = world.split(dp)
        out.append(_PHASES[mode](group, spec) if group is not None
                   else None)
        world.barrier()
    return out


def follower(world, phases) -> None:
    _run_phases(world, phases)


def _on_world(phases: list) -> list:
    """Rank 0's results of `phases` on a group of 4 started here."""
    from skypilot_tpu_torch.parallel.mesh import train_group
    world = train_group(4, device='cpu', target=_TARGET, args=[phases],
                        timeout_seconds=120)
    try:
        out = _run_phases(world, phases)
    except BaseException:
        world.kill()
        raise
    world.close(timeout=120)
    return out


def _zero1(spec):
    tmp = tempfile.mkdtemp(prefix='skytpu-torch-zero1-')
    try:
        return _zero1_in(tmp, spec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _zero1_in(tmp: str, spec):
    from skypilot_tpu_torch.observability import metrics as obs
    from skypilot_tpu_torch.observability.exposition import (
        generate_latest, parse_prometheus_text)
    from skypilot_tpu_torch.train import metrics as metrics_lib
    from skypilot_tpu_torch.train import trainer
    from skypilot_tpu_torch.train.checkpoints import (CheckpointManager,
                                                      moments_file)
    spec = {**spec, 'ckpt': os.path.join(tmp, 'ckpt'),
            'reference': os.path.join(tmp, 'reference.pt')}
    row, cross = _on_world([(4, 'zero1_a', spec), (2, 'zero1_b', spec)])
    row.update(cross)
    # Unsharded: the dp=4 save restored onto a state of one process.
    ref = torch.load(spec['reference'], weights_only=True)
    plain = trainer.create_train_state(_cfg(spec['cfg']), _tc(spec),
                                       device='cpu', seed=3)
    manager = CheckpointManager(spec['ckpt'])
    manager.restore(plain, 2)
    row['unsharded'] = _equal_to(plain, ref['moments'], ref['params'])
    # Torn: step 2's largest moment file cut in half; step 1 missing one.
    step2 = os.path.join(spec['ckpt'], '2')
    victim = max(glob.glob(os.path.join(step2, 'moments-*')),
                 key=os.path.getsize)
    with open(victim, 'r+b') as f:
        f.truncate(os.path.getsize(victim) // 2)
    os.remove(os.path.join(spec['ckpt'], '1', moments_file(3, 4)))
    for step, key in ((2, 'truncated'), (1, 'missing')):
        fresh = trainer.create_train_state(_cfg(spec['cfg']), _tc(spec),
                                           device='cpu', seed=3)
        before = {n: p.clone() for n, p in fresh.model.state_dict().items()}
        try:
            manager.restore(fresh, step)
            row[f'{key}_raises'] = False
        except Exception as e:  # pylint: disable=broad-except
            row[f'{key}_raises'] = type(e).__name__
        row[f'{key}_untouched'] = all(
            torch.equal(p, before[n])
            for n, p in fresh.model.state_dict().items())
    # Gauges, with the exporter enabled after the run.
    obs.enable()
    metrics_lib.publish_opt_state_bytes(_KEPT['zero_state'])
    metrics_lib.publish_step_collectives(row['probe/1/1'])
    families = parse_prometheus_text(generate_latest())
    row['gauge_per_device'] = families[
        'skytpu_train_opt_state_bytes_per_device']['samples'][
            ('skytpu_train_opt_state_bytes_per_device', ())]
    row['gauge_rs_effective'] = families['skytpu_train_step_collectives'][
        'samples'][('skytpu_train_step_collectives',
                    (('op', 'reduce_scatter_effective'),))]
    return row


def main() -> int:
    os.environ['PYTHONPATH'] = os.pathsep.join(
        p for p in (_HERE, os.environ.get('PYTHONPATH')) if p)
    mode, spec = sys.argv[1], json.loads(sys.argv[2])
    if mode == 'jax':
        row = dict(zip(('2', '4'), _on_world([(2, 'jax', spec),
                                              (4, 'jax', spec)])))
    else:
        row = _zero1(spec)
    print(json.dumps(row))
    return 0


if __name__ == '__main__':
    sys.exit(main())
