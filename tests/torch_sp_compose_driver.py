"""The sequence ring composed with the other training axes, over gloo
process groups on the CPU.

This process is rank 0 of a group of 4 that `train_group` starts; the
other ranks run the same phases (`follower`), each case on the group's
first dp x fsdp x sp ranks with those extents (`TrainGroup.split`).
Usage:

    python tests/torch_sp_compose_driver.py SPEC_JSON

SPEC: 'weights' (state dicts carried across from the JAX inits, by
name), 'batches' (npz), 'configs' ((model, overrides) by weight name),
'tc' (TrainConfig), 'ckpt' (a directory for the checkpoint phase).

Phase `steps`: 3 steps of every case in CASES from the JAX init's
weights; per case the (loss, grad_norm) series and the first step's
collectives. Phase `ring`: at dp 2 x sp 2 each rank's per-rank ring
(over its group's `ring`) against the one-process ring of its rows, the
output and the gradients compared bit for bit. Phase `ckpt`: states
trained one step at dp 2 x sp 2 under ZeRO-1 and at sp 2 x fsdp 2 saved,
restored at sp 2 x fsdp 2, dp 2 x sp 2 under ZeRO-1, dp 2 and on one rank
(the last two with the one-process ring), and two steps continued on
each, beside the unbroken runs; whether each restore holds the saved
whole params. tests/test_torch_sp_compose.py asserts on the row.

Prints ONE JSON row.
"""
import json
import os
import sys

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_TARGET = 'torch_sp_compose_driver:follower'

# (name, dp, fsdp, sp, grad_accum, zero1, weights): `weights` names the
# JAX init's weights and their config in the spec.
CASES = (
    ('dp2xsp2', 2, 1, 2, 1, False, 'plain'),
    ('dp2xsp2/accum2', 2, 1, 2, 2, False, 'plain'),
    ('sp2xfsdp2', 1, 2, 2, 1, False, 'plain'),
    ('sp2xfsdp2/accum2', 1, 2, 2, 2, False, 'plain'),
    ('dp2xsp2/zero1', 2, 1, 2, 1, True, 'plain'),
    ('sp2/lora', 1, 1, 2, 1, False, 'lora'),
    ('sp2/lora-all', 1, 1, 2, 1, False, 'lora_all'),
    ('sp2/moe', 1, 1, 2, 1, False, 'moe'),
    ('dp2xsp2/moe', 2, 1, 2, 1, False, 'moe'),
    ('dp2/moe', 2, 1, 1, 1, False, 'moe'),
    ('fsdp2/moe', 1, 2, 1, 1, False, 'moe'),
)


def _cfg(spec, weights, sp):
    """The config of a weight set; the ring's attention under sp."""
    from skypilot_tpu_torch.models.configs import get_config
    model, over = spec['configs'][weights]
    over = dict(over, **({'attention_impl': 'ring'} if sp > 1 else {}))
    return get_config(model, **over)


def _batches(spec):
    raw = np.load(spec['batches'])
    return [{k: torch.from_numpy(raw[f'{k}{i}']) for k in
             ('inputs', 'targets', 'mask')} for i in range(3)]


def _state(group, spec, weights, sp, zero1=False):
    """A TrainState on `group` (None: one rank) holding the JAX init's
    weights."""
    from skypilot_tpu_torch.train import trainer
    state = trainer.create_train_state(
        _cfg(spec, weights, sp), trainer.TrainConfig(**spec['tc']),
        device='cpu', seed=0, group=group, zero1=zero1)
    full = torch.load(spec['weights'][weights], weights_only=True)
    if state.fsdp is not None:
        state.fsdp.load_full(full.items())
    else:
        state.model.load_state_dict(full)
    return state


def _steps_phase(group, spec) -> dict:
    from skypilot_tpu_torch.train import trainer
    out = {}
    for name, dp, fsdp, sp, accum, zero1, weights in CASES:
        sub = group.split(dp, fsdp, sp)
        if sub is not None:
            state = _state(sub, spec, weights, sp, zero1)
            step = trainer.make_train_step(grad_accum=accum)
            series, probe = [], None
            for i, batch in enumerate(_batches(spec)):
                if i == 0:
                    m, probe = trainer.step_collectives(step, state, batch)
                else:
                    m = step(state, batch)
                series.append((float(m['loss']), float(m['grad_norm'])))
            out[name] = sub.gather_object(
                {'series': series, 'probe': probe,
                 'layers': len(state.model.layers)})
        group.barrier()
    return out


def _ring_phase(group, spec) -> dict:
    """Per-rank ring over dp 2 x sp 2 against the one-process ring of the
    rank's rows, bit for bit (output, dq, dk, dv)."""
    from skypilot_tpu_torch.ops import ring_attention as ra
    del spec
    sub = group.split(2, 1, 2)
    gen = torch.Generator().manual_seed(3)
    q, g = (torch.randn(4, 32, 4, 16, generator=gen) for _ in range(2))
    k, v = (torch.randn(4, 32, 2, 16, generator=gen) for _ in range(2))
    rows = slice(2 * sub.dp_rank, 2 * sub.dp_rank + 2)
    cols = slice(16 * sub.sp_rank, 16 * sub.sp_rank + 16)
    whole = [t[rows].clone().requires_grad_() for t in (q, k, v)]
    out = ra.ring_attention_sharded(*whole, sp=2)
    out.backward(g[rows])
    mine = [t[rows, cols].clone().requires_grad_() for t in (q, k, v)]
    before = sub.counts()['collective_permute']
    got = ra.ring_attention(*mine, group=sub.ring)
    got.backward(g[rows, cols])
    same = [torch.equal(got, out[:, cols])] + [
        torch.equal(a.grad, b.grad[:, cols]) for a, b in zip(mine, whole)]
    hops = sub.counts()['collective_permute'] - before
    return {'ranks': sub.gather_object({'equal': same, 'hops': hops})}


def _whole(state) -> dict:
    """Every whole parameter of a state (an fsdp state's gathered; every
    rank of its group calls it)."""
    if state.fsdp is None:
        return {n: p.detach().clone()
                for n, p in state.model.named_parameters()}
    return {n: state.fsdp.full(n) for n in state.fsdp.leaves}


def _continue(state, spec, ring) -> list:
    """Two more steps: the per-rank ring of the state's group, or (a
    state without one) the one-process ring."""
    from skypilot_tpu_torch.train import trainer
    step = trainer.make_train_step(sp=None if ring else 2)
    return [tuple(float(v) for v in (m['loss'], m['grad_norm']))
            for m in (step(state, b) for b in _batches(spec)[1:])]


def _ckpt_phase(group, spec) -> dict:
    from skypilot_tpu_torch.train import trainer
    from skypilot_tpu_torch.train.checkpoints import CheckpointManager
    out = {}
    saves = (('zero1', 2, 1, 2, True), ('fsdp', 1, 2, 2, False))
    for key, dp, fsdp, sp, zero1 in saves:
        sub = group.split(dp, fsdp, sp)
        if sub is not None:
            state = _state(sub, spec, 'plain', sp, zero1)
            trainer.make_train_step()(state, _batches(spec)[0])
            manager = CheckpointManager(os.path.join(spec['ckpt'], key),
                                        save_interval_steps=1)
            manager.save(1, state, force=True)
            whole = _whole(state)
            series = _continue(state, spec, True)
            if sub.rank == 0:
                out[f'{key}/unbroken'] = series
                torch.save(whole, os.path.join(spec['ckpt'],
                                               f'{key}.whole.pt'))
                out[f'{key}/files'] = sorted(os.listdir(
                    os.path.join(spec['ckpt'], key, '1')))
        group.barrier()
    targets = (('sp2xfsdp2', 1, 2, 2, False), ('dp2xsp2/zero1', 2, 1, 2, True),
               ('dp2', 2, 1, 1, False), ('one', 1, 1, 1, False))
    for key, *_ in saves:
        saved = torch.load(os.path.join(spec['ckpt'], f'{key}.whole.pt'),
                           weights_only=True)
        for name, dp, fsdp, sp, zero1 in targets:
            sub = group.split(dp, fsdp, sp)
            if sub is not None:
                state = _state(sub if sub.size > 1 else None, spec, 'plain',
                               2, zero1)
                CheckpointManager(os.path.join(spec['ckpt'], key)).restore(
                    state, 1)
                whole = _whole(state)
                same = all(torch.equal(whole[n], saved[n]) for n in saved)
                count = state.count
                series = _continue(state, spec, sp > 1)
                if sub.rank == 0:
                    out[f'{key}->{name}'] = {'params_equal': same,
                                             'count': count,
                                             'series': series}
            group.barrier()
    return out


_PHASES = {'steps': _steps_phase, 'ring': _ring_phase, 'ckpt': _ckpt_phase}


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
