"""Tensor-parallel training on the port, over gloo process groups on the
CPU.

This process is rank 0 of a group of 4 that `train_group` starts; the
other ranks run the same phases (`follower`), each case on the group's
first dp x fsdp x sp x tp ranks with those extents (`TrainGroup.split`).
Usage:

    python tests/torch_tp_train_driver.py SPEC_JSON

SPEC: 'weights' (state dicts carried across from the JAX inits, by
name), 'batches' (npz), 'configs' ((model, overrides) by weight name),
'tc' (TrainConfig), 'ckpt' (a directory for the checkpoint phase).

Phase `steps`: 3 steps of every case in CASES from the JAX init's
weights; per case the (loss, grad_norm) series, the first step's
collectives, the bytes the steps' collectives moved, the weight and
optimizer bytes a rank, and the whole params after the last step (saved
by rank 0 under 'ckpt'). Phase `ckpt`: states trained one step at each
layout of SAVES saved, restored at each layout of TARGETS, and two steps
continued on each, beside the unbroken runs; whether each restore holds
the saved whole params, and the files of each save.
tests/test_torch_tp_train.py asserts on the row.

Prints ONE JSON row.
"""
import json
import os
import sys

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_TARGET = 'torch_tp_train_driver:follower'

# (name, dp, fsdp, sp, tp, grad_accum, zero1, weights, config overrides)
CASES = (
    ('tp2', 1, 1, 1, 2, 1, False, 'plain', {}),
    ('tp2/remat', 1, 1, 1, 2, 1, False, 'plain', {'remat': True}),
    ('fsdp2xtp2', 1, 2, 1, 2, 1, False, 'plain', {}),
    ('dp2xtp2/accum2/zero1', 2, 1, 1, 2, 2, True, 'plain', {}),
    ('tp2/lora', 1, 1, 1, 2, 1, False, 'lora', {}),
    ('tp2/lora-all', 1, 1, 1, 2, 1, False, 'lora_all', {}),
    ('fsdp2xtp2/lora-all', 1, 2, 1, 2, 1, False, 'lora_all', {}),
    ('dp2', 2, 1, 1, 1, 1, False, 'plain', {}),
    ('fsdp2', 1, 2, 1, 1, 1, False, 'plain', {}),
)

# Layouts of the checkpoint phase: (name, dp, fsdp, tp, zero1).
SAVES = (('tp2', 1, 1, 2, False), ('one', 1, 1, 1, False),
         ('dp2xtp2/zero1', 2, 1, 2, True))
TARGETS = (('one', 1, 1, 1, False), ('tp2', 1, 1, 2, False),
           ('fsdp2xtp2', 1, 2, 2, False), ('dp2xtp2/zero1', 2, 1, 2, True))


def _cfg(spec, weights, over=None):
    from skypilot_tpu_torch.models.configs import get_config
    model, base = spec['configs'][weights]
    return get_config(model, **dict(base, **(over or {})))


def _batches(spec):
    raw = np.load(spec['batches'])
    return [{k: torch.from_numpy(raw[f'{k}{i}']) for k in
             ('inputs', 'targets', 'mask')} for i in range(3)]


def _state(group, spec, weights, zero1=False, over=None):
    """A TrainState on `group` (None: one rank) holding the JAX init's
    weights."""
    from skypilot_tpu_torch.train import trainer
    state = trainer.create_train_state(
        _cfg(spec, weights, over), trainer.TrainConfig(**spec['tc']),
        device='cpu', seed=0, group=group, zero1=zero1)
    full = torch.load(spec['weights'][weights], weights_only=True)
    state.model.load_whole(full.items())
    return state


def _whole(state) -> dict:
    """Every whole parameter of a state (every rank of its groups calls
    it)."""
    return {n: v.clone() for n, v in state.model.whole_params()}


def _steps_phase(group, spec) -> dict:
    from skypilot_tpu_torch.train import metrics, trainer
    out = {}
    for name, dp, fsdp, sp, tp, accum, zero1, weights, over in CASES:
        sub = group.split(dp, fsdp, sp, tp)
        if sub is not None:
            state = _state(sub, spec, weights, zero1, over)
            moved = dict(sub.bytes)
            step = trainer.make_train_step(grad_accum=accum)
            series, probe = [], None
            for i, batch in enumerate(_batches(spec)):
                if i == 0:
                    m, probe = trainer.step_collectives(step, state, batch)
                else:
                    m = step(state, batch)
                series.append((float(m['loss']), float(m['grad_norm'])))
            moved = {k: sub.bytes[k] - moved[k] for k in moved}
            whole = _whole(state)
            if sub.rank == 0:
                torch.save(whole, os.path.join(
                    spec['ckpt'], name.replace('/', '_') + '.params.pt'))
            out[name] = sub.gather_object(
                {'series': series, 'probe': probe,
                 'layers': len(state.model.layers),
                 'tensor': sub.tensor is not None,
                 'tp_train': state.model.tp_train,
                 'param_bytes': sum(p.numel() * p.element_size()
                                    for p in state.model.parameters()),
                 'opt_bytes': metrics.opt_state_bytes(state),
                 'moved': moved})
        group.barrier()
    return out


def _continue(state, spec) -> list:
    from skypilot_tpu_torch.train import trainer
    step = trainer.make_train_step()
    return [tuple(float(v) for v in (m['loss'], m['grad_norm']))
            for m in (step(state, b) for b in _batches(spec)[1:])]


def _ckpt_phase(group, spec) -> dict:
    from skypilot_tpu_torch.train import trainer
    from skypilot_tpu_torch.train.checkpoints import CheckpointManager
    out = {}
    for key, dp, fsdp, tp, zero1 in SAVES:
        sub = group.split(dp, fsdp, 1, tp)
        if sub is not None:
            state = _state(sub if sub.size > 1 else None, spec, 'plain',
                           zero1)
            trainer.make_train_step()(state, _batches(spec)[0])
            directory = os.path.join(spec['ckpt'], key.replace('/', '_'))
            CheckpointManager(directory, save_interval_steps=1).save(
                1, state, force=True)
            whole = _whole(state)
            series = _continue(state, spec)
            if sub.rank == 0:
                out[f'{key}/unbroken'] = series
                torch.save(whole, directory + '.whole.pt')
                out[f'{key}/files'] = sorted(
                    os.path.relpath(os.path.join(root, f),
                                    os.path.join(directory, '1'))
                    for root, _, files in os.walk(os.path.join(directory,
                                                               '1'))
                    for f in files)
        group.barrier()
    for key, *_ in SAVES:
        directory = os.path.join(spec['ckpt'], key.replace('/', '_'))
        saved = torch.load(directory + '.whole.pt', weights_only=True)
        for name, dp, fsdp, tp, zero1 in TARGETS:
            sub = group.split(dp, fsdp, 1, tp)
            if sub is not None:
                state = _state(sub if sub.size > 1 else None, spec, 'plain',
                               zero1)
                CheckpointManager(directory).restore(state, 1)
                whole = _whole(state)
                same = all(torch.equal(whole[n], saved[n]) for n in saved)
                count = state.count
                series = _continue(state, spec)
                if sub.rank == 0:
                    out[f'{key}->{name}'] = {'params_equal': same,
                                             'count': count,
                                             'series': series}
            group.barrier()
    # A LoRA save at tp 2 (its frozen base a file a tp index) restored on
    # one rank.
    sub = group.split(1, 1, 1, 2)
    directory = os.path.join(spec['ckpt'], 'lora')
    if sub is not None:
        state = _state(sub, spec, 'lora_all')
        trainer.make_train_step()(state, _batches(spec)[0])
        CheckpointManager(directory, save_interval_steps=1).save(
            1, state, force=True)
        whole = _whole(state)
        if sub.rank == 0:
            torch.save(whole, directory + '.whole.pt')
    group.barrier()
    if group.rank == 0:
        state = _state(None, spec, 'lora_all')
        manager = CheckpointManager(directory)
        manager.restore(state, 1)
        saved = torch.load(directory + '.whole.pt', weights_only=True)
        model = manager.model_state(1)
        out['lora->one'] = {
            'params_equal': all(torch.equal(p, saved[n]) for n, p in
                                state.model.named_parameters()),
            'model_state_equal': all(torch.equal(model[n], saved[n])
                                     for n in saved),
            'files': sorted(os.listdir(os.path.join(directory, '1',
                                                    'tp-0-of-2')))}
    group.barrier()
    return out


_PHASES = {'steps': _steps_phase, 'ckpt': _ckpt_phase}


def _run(world, spec) -> dict:
    """Every phase on the world (one intra-op thread a rank: four
    processes share the CPU)."""
    torch.set_num_threads(1)
    return {name: fn(world, spec) for name, fn in _PHASES.items()}


def follower(world, spec) -> None:
    _run(world, spec)


def main() -> int:
    os.environ['PYTHONPATH'] = os.pathsep.join(
        p for p in (_HERE, os.environ.get('PYTHONPATH')) if p)
    spec = json.loads(sys.argv[1])
    from skypilot_tpu_torch.parallel.mesh import train_group
    world = train_group(4, device='cpu', target=_TARGET, args=[spec],
                        timeout_seconds=120)
    try:
        row = _run(world, spec)
    except BaseException:
        world.kill()
        raise
    world.close(timeout=120)
    print(json.dumps(row))
    return 0


if __name__ == '__main__':
    sys.exit(main())
