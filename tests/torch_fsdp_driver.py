"""fsdp training on the port, over gloo process groups on the CPU.

This process is rank 0 of a group of 4 that `train_group` starts; the
other ranks run the same phases (`follower`), each case on the group's
first dp x fsdp ranks with those extents (`TrainGroup.split`). Usage:

    python tests/torch_fsdp_driver.py SPEC_JSON

SPEC: 'params' and 'lora_params' (state dicts carried across from the
JAX inits), 'batches' (npz), 'cfg', 'lora' (config overrides), 'tc'
(TrainConfig), 'ckpt' (a directory for the checkpoint phase).

Phase `steps`: 3 steps of every case in CASES from the JAX init's
weights; per case the (loss, grad_norm) series, the first step's
collectives, the bytes a rank holds (params and AdamW state) beside the
plain model's, and the most gathered weight bytes alive at once beside
the units' sizes. Phase `ckpt`: a state trained one step at fsdp 2 (and
one at dp 2 x fsdp 2 under ZeRO-1) saved, restored at fsdp 2, fsdp 4, dp
2 and on one rank, and two steps continued on each, beside the unbroken
runs; whether each restore holds the saved whole params; a torn shard
file refused. tests/test_torch_fsdp.py asserts on the row.

Prints ONE JSON row.
"""
import json
import os
import sys

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_TARGET = 'torch_fsdp_driver:follower'

# (name, dp, fsdp, grad_accum, zero1, over): over 'lora' takes the LoRA
# config and weights; other keys are config overrides.
CASES = (
    ('dp2', 2, 1, 1, False, {}),
    ('dp4', 4, 1, 1, False, {}),
    ('fsdp2', 1, 2, 1, False, {}),
    ('fsdp4', 1, 4, 1, False, {}),
    ('dp2xfsdp2', 2, 2, 1, False, {}),
    ('fsdp2/accum2', 1, 2, 2, False, {}),
    ('dp2xfsdp2/zero1', 2, 2, 1, True, {}),
    ('fsdp2/remat', 1, 2, 1, False, {'remat': True}),
    ('fsdp2/lora', 1, 2, 1, False, {'lora': True}),
    ('dp2/lora', 2, 1, 1, False, {'lora': True}),
    ('fsdp2/mixed', 1, 2, 1, False, {'dtype': 'bfloat16'}),
    ('dp2/mixed', 2, 1, 1, False, {'dtype': 'bfloat16'}),
)


def _cfg(spec, over):
    from skypilot_tpu_torch.models.configs import get_config
    over = dict(over)
    lora = spec['lora'] if over.pop('lora', False) else {}
    return get_config('test-tiny', **{**spec['cfg'], **lora, **over})


def _batches(spec):
    raw = np.load(spec['batches'])
    return [{k: torch.from_numpy(raw[f'{k}{i}']) for k in
             ('inputs', 'targets', 'mask')} for i in range(3)]


def _state(group, spec, over, zero1=False):
    """A TrainState on `group` (None: one rank) holding the JAX init's
    weights."""
    from skypilot_tpu_torch.train import trainer
    cfg = _cfg(spec, over)
    state = trainer.create_train_state(cfg, trainer.TrainConfig(
        **spec['tc']), device='cpu', seed=0, group=group, zero1=zero1)
    full = torch.load(spec['lora_params' if over.get('lora') else 'params'],
                      weights_only=True)
    if state.fsdp is not None:
        state.fsdp.load_full(full.items())
    else:
        state.model.load_state_dict(full)
    return state


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _case(group, spec, dp, fsdp, accum, zero1, over) -> dict:
    from skypilot_tpu_torch.train import metrics as metrics_lib
    from skypilot_tpu_torch.train import trainer
    state = _state(group, spec, over, zero1)
    step = trainer.make_train_step(grad_accum=accum)
    series, probe = [], None
    for i, batch in enumerate(_batches(spec)):
        if i == 0:
            m, probe = trainer.step_collectives(step, state, batch)
        else:
            m = step(state, batch)
        series.append((float(m['loss']), float(m['grad_norm'])))
    opt_total, opt_rank = metrics_lib.opt_state_bytes(state)
    row = {'series': series, 'probe': probe,
           'param_bytes': _bytes(state.model.parameters()),
           'opt_bytes': [opt_total, opt_rank]}
    fs = state.fsdp
    if fs is not None:
        row['whole_param_bytes'] = sum(
            torch.Size(leaf.shape).numel() * leaf.param.element_size()
            for leaf in fs.leaves.values())
        row['peak_gathered'] = fs.peak_gathered
        row['cast_handles'] = fs.cast_handles
        row['unit_bytes'] = {name: fs.unit_bytes(name)
                             for name in fs.units}
        row['layers'] = len(state.model.layers)
        # The whole moments (exp_avg, exp_avg_sq) of the trained leaves
        # fsdp cuts, and of those it keeps whole (a LoRA B whose output
        # is no embed axis, as in the reference).
        split = [0, 0]
        for name in state.names:
            leaf = fs.leaves[name]
            split[leaf.dim is None] += 2 * torch.Size(
                leaf.shape).numel() * leaf.param.element_size()
        row['moment_split'] = split
    return row


def _steps_phase(group, spec) -> dict:
    out = {}
    for name, dp, fsdp, accum, zero1, over in CASES:
        sub = group.split(dp, fsdp)
        if sub is not None:
            row = _case(sub, spec, dp, fsdp, accum, zero1, over)
            out[name] = sub.gather_object(row)
        group.barrier()
    return out


def _whole(state) -> dict:
    """Every whole parameter of a state (an fsdp state's gathered; every
    rank of its group calls it)."""
    if state.fsdp is None:
        return {n: p.detach().clone()
                for n, p in state.model.named_parameters()}
    return {n: state.fsdp.full(n) for n in state.fsdp.leaves}


def _continue(state, spec, start=1) -> list:
    from skypilot_tpu_torch.train import trainer
    step = trainer.make_train_step()
    return [tuple(float(v) for v in (m['loss'], m['grad_norm']))
            for m in (step(state, b) for b in _batches(spec)[start:])]


def _ckpt_phase(group, spec) -> dict:
    """Save at fsdp 2 (and at dp 2 x fsdp 2 under ZeRO-1) after one step,
    then restore onto every layout and continue."""
    from skypilot_tpu_torch.train import trainer
    from skypilot_tpu_torch.train.checkpoints import (CheckpointManager,
                                                      shard_file)
    out = {}
    saves = (('fsdp2', 1, 2, False), ('zero1', 2, 2, True))
    for key, dp, fsdp, zero1 in saves:
        sub = group.split(dp, fsdp)
        if sub is not None:
            state = _state(sub, spec, {}, zero1)
            trainer.make_train_step()(state, _batches(spec)[0])
            manager = CheckpointManager(os.path.join(spec['ckpt'], key),
                                        save_interval_steps=1)
            manager.save(1, state, force=True)
            whole = _whole(state)
            series = _continue(state, spec)
            if sub.rank == 0:
                out[f'{key}/unbroken'] = series
                torch.save(whole, os.path.join(spec['ckpt'],
                                               f'{key}.whole.pt'))
                out[f'{key}/files'] = sorted(os.listdir(
                    os.path.join(spec['ckpt'], key, '1')))
        group.barrier()
    targets = (('fsdp2', 1, 2, False), ('fsdp4', 1, 4, False),
               ('dp2', 2, 1, False), ('dp2/zero1', 2, 1, True),
               ('one', 1, 1, False), ('dp2xfsdp2/zero1', 2, 2, True))
    for key, _, _, _ in saves:
        saved = torch.load(os.path.join(spec['ckpt'], f'{key}.whole.pt'),
                           weights_only=True)
        for name, dp, fsdp, zero1 in targets:
            sub = group.split(dp, fsdp)
            if sub is not None:
                state = _state(sub if sub.size > 1 else None, spec, {},
                               zero1)
                CheckpointManager(os.path.join(spec['ckpt'], key)).restore(
                    state, 1)
                whole = _whole(state)
                same = all(torch.equal(whole[n], saved[n]) for n in saved)
                count = state.count
                series = _continue(state, spec)
                if sub.rank == 0:
                    out[f'{key}->{name}'] = {'params_equal': same,
                                             'count': count,
                                             'series': series}
            group.barrier()
    # A torn shard file: the restore raises and leaves the state as it
    # was.
    sub = group.split(1, 2)
    if sub is not None:
        path = os.path.join(spec['ckpt'], 'fsdp2', '1', shard_file(1, 2))
        if sub.rank == 0:
            with open(path, 'r+b') as f:
                f.truncate(os.path.getsize(path) // 2)
        sub.barrier()
        state = _state(sub, spec, {})
        before = {n: p.clone() for n, p in state.model.named_parameters()}
        try:
            CheckpointManager(os.path.join(spec['ckpt'], 'fsdp2')).restore(
                state, 1)
            raised = False
        except Exception as e:  # pylint: disable=broad-except
            raised = type(e).__name__
        untouched = all(torch.equal(p, before[n]) for n, p in
                        state.model.named_parameters())
        if sub.rank == 0:
            out['torn'] = {'raises': raised, 'untouched': untouched}
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
