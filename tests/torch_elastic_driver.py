"""Preemption-native elastic training on the port: the reference's storm
(tests/elastic_driver.py) over gloo process groups on the CPU.

This process is rank 0 of a group of 4 that `train_group` starts (the
other ranks run `follower` with the whole schedule); each incarnation
is the loop's `run` on the whole group at its dp, which runs on the
group's first dp ranks (`TrainGroup.split`), as the reference's storm
builds a mesh over the first dp devices of one process. test-tiny in
fp32, clipping active, canonical extent 4, ZeRO-1, one checkpoint a
step:

1. BASELINE: one unpreempted incarnation at dp=4 trains 12 steps.
2. STORM: the same 12 steps over six incarnations:
     inc1 dp=4  a notice on rank 0 alone after step 2 (the ranks agree
                on it) → deadline-bounded save → relaunch at the
                surviving extent dp=2;
     inc2 dp=2  a notice after step 4;
     inc3 dp=2  `train.step` armed fail:1 on every rank after step 5:
                the slice dies mid-step 6 with no notice;
     inc4 dp=2  `train.notice` armed fail:1: the notice after step 7 is
                lost in delivery and the kill lands at step 8 with no
                final checkpoint;
     inc5 dp=2  a notice after step 9;
     inc6 dp=4  capacity returns: grow back and run to the end.
   Pins: the extents, the lineage down then up, each incident's resume
   frontier, and every captured step's (loss, grad_norm) bit-identical to
   the baseline's.
3. TORN: the newest checkpoint's largest moment file truncated:
   restore_latest_valid falls back to an older step.
4. GAUGES: the preemption, resize, save-seconds and fallback metrics in
   the exposition.

Prints ONE JSON row; tests/test_torch_elastic.py asserts on it.
"""
import glob
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

TOTAL = 12
CANONICAL = 4
SURVIVING = 2                 # elastic.surviving_extent(4, 2 cards left)
_HERE = os.path.dirname(os.path.abspath(__file__))


def _setup():
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.train.trainer import TrainConfig
    torch.set_num_threads(1)
    cfg = get_config('test-tiny', dtype='float32', param_dtype='float32')
    tc = TrainConfig(warmup_steps=1, total_steps=TOTAL, learning_rate=3e-2,
                     grad_clip_norm=0.5)
    return cfg, tc


def batches(vocab: int) -> list:
    out = []
    for i in range(TOTAL):
        tokens = np.random.RandomState(i).randint(0, vocab, (16, 65))
        out.append({'inputs': torch.from_numpy(tokens[:, :-1]),
                    'targets': torch.from_numpy(tokens[:, 1:]),
                    'mask': torch.ones((16, 64), dtype=torch.int32)})
    return out


def _schedule(root: str) -> list:
    base, storm = (os.path.join(root, n) for n in ('base', 'storm'))
    return [{'dp': 4, 'dir': base},
            {'dp': 4, 'dir': storm, 'notice_at': 2},
            {'dp': SURVIVING, 'dir': storm, 'notice_at': 4},
            {'dp': SURVIVING, 'dir': storm, 'kill_at': 5},
            {'dp': SURVIVING, 'dir': storm, 'lost_notice_at': 7},
            {'dp': SURVIVING, 'dir': storm, 'notice_at': 9},
            {'dp': 4, 'dir': storm}]


def incarnation(group, spec: dict):
    """One incarnation on this rank: the loop over `spec['dir']` at
    extent `spec['dp']` on the group's first ranks, with the spec's
    faults armed on this rank at the spec's steps; rank 0 alone gets the
    notice at `notice_at`. Returns the IncarnationResult, or None when
    the slice was killed or this rank sat it out; sets
    spec['frontier'] (the newest published step after it)."""
    from skypilot_tpu_torch.train.checkpoints import CheckpointManager
    from skypilot_tpu_torch.train.elastic import (ElasticTrainLoop,
                                                  PreemptionNotice)
    from skypilot_tpu_torch.utils import fault_injection
    cfg, tc = _setup()
    data = batches(cfg.vocab_size)
    notice = PreemptionNotice()
    if spec.get('lost_notice_at') is not None:
        fault_injection.arm('train.notice', 'fail:1')

    def batch_for(step):
        if step == spec.get('notice_at') and group.rank == 0:
            notice.deliver()
        if step == spec.get('kill_at'):
            fault_injection.arm('train.step', 'fail:1')
        if step == spec.get('lost_notice_at'):
            try:
                notice.deliver()
            except fault_injection.InjectedFault:
                spec['notice_lost'] = True
                fault_injection.arm('train.step', 'fail:1')
        return data[step]

    loop = ElasticTrainLoop(cfg, tc, spec['dir'], canonical_dp=CANONICAL,
                            device='cpu')
    try:
        return loop.run(spec['dp'], batch_for, TOTAL, notice=notice,
                        group=group)
    except fault_injection.InjectedFault:
        return None                     # the slice died mid-step
    finally:
        fault_injection.disarm_all()
        spec['frontier'] = CheckpointManager(spec['dir']).latest_step()


def _run_all(world, schedule: list) -> list:
    """Every incarnation of `schedule` on this rank's part of `world`:
    its result where this rank took part, else None."""
    out = []
    for spec in schedule:
        out.append(incarnation(world, spec))
        world.barrier()
    return out


def follower(world, schedule: list) -> None:
    _run_all(world, schedule)


def main() -> int:
    os.environ['PYTHONPATH'] = os.pathsep.join(
        p for p in (_HERE, os.environ.get('PYTHONPATH')) if p)
    root = tempfile.mkdtemp(prefix='skytpu-torch-elastic-')
    try:
        return _storm(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _storm(root: str) -> int:
    from skypilot_tpu_torch.observability import metrics as obs
    from skypilot_tpu_torch.observability.exposition import (
        generate_latest, parse_prometheus_text)
    from skypilot_tpu_torch.parallel.mesh import train_group
    from skypilot_tpu_torch.train.checkpoints import CheckpointManager
    from skypilot_tpu_torch.train.elastic import ElasticMeta, surviving_extent
    from skypilot_tpu_torch.train.trainer import create_train_state

    obs.enable()
    cfg, tc = _setup()
    schedule = _schedule(root)
    storm_dir = schedule[-1]['dir']
    world = train_group(4, device='cpu',
                        target='torch_elastic_driver:follower',
                        args=[schedule], timeout_seconds=120)
    try:
        results = _run_all(world, schedule)
    except BaseException:
        world.kill()
        raise
    world.close(timeout=120)

    base = results[0]
    series, incarnations, faults = {}, [], {}
    for i, (spec, result) in enumerate(zip(schedule[1:], results[1:])):
        if result is None:
            faults[f'killed_at_{i}'] = True
            faults['notice_lost'] = faults.get('notice_lost') or bool(
                spec.get('notice_lost'))
            continue
        start = result.next_step - len(result.series)
        for j, v in enumerate(result.series):
            series[start + j] = v
        incarnations.append({'dp': result.dp, 'start': start,
                             'next': result.next_step,
                             'preempted': result.preempted,
                             'committed': result.checkpoint_committed})
    meta = ElasticMeta.load(storm_dir)
    mismatches = [s for s, v in series.items() if v != base.series[s]]

    # Torn: the newest step's largest moment file cut in half.
    manager = CheckpointManager(storm_dir)
    kept = manager.all_steps()
    victim = max(glob.glob(os.path.join(storm_dir, str(kept[-1]),
                                        'moments-*')), key=os.path.getsize)
    with open(victim, 'r+b') as f:
        f.truncate(os.path.getsize(victim) // 2)
    template = create_train_state(cfg, tc, device='cpu', seed=0)
    _, fallback = manager.restore_latest_valid(template)

    families = parse_prometheus_text(generate_latest())

    def sample(name, labels=(), sample_name=None):
        fam = families.get(name)
        return fam['samples'].get((sample_name or name, labels)) if fam \
            else None

    print(json.dumps({
        'clip_active': all(norm > tc.grad_clip_norm
                           for _, norm in base.series[:3]),
        'dp_survive': surviving_extent(CANONICAL, 2),
        'baseline': base.series,
        'incarnations': incarnations,
        'frontiers': [spec['frontier'] for spec in schedule[1:]],
        'faults': faults,
        'lineage': [(e['from_dp'], e['to_dp']) for e in meta.lineage],
        'canonical': meta.canonical_dp,
        'captured_steps': sorted(series),
        'mismatches': mismatches,
        'final_parity': series.get(TOTAL - 1) == base.series[-1],
        'kept_steps': kept,
        'fallback_step': fallback,
        'preemptions': sample('skytpu_train_preemptions_total'),
        'resizes_down': sample('skytpu_train_elastic_resizes_total',
                               (('direction', 'down'),)),
        'resizes_up': sample('skytpu_train_elastic_resizes_total',
                             (('direction', 'up'),)),
        'save_count': sample('skytpu_train_checkpoint_save_seconds',
                             sample_name='skytpu_train_checkpoint_save_'
                             'seconds_count'),
        'fallbacks': sample(
            'skytpu_train_checkpoint_restore_fallbacks_total'),
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
