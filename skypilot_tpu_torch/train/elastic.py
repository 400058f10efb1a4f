"""Preemption-native elastic training: the port of
skypilot_tpu/train/elastic.py.

A preemption notice (SIGTERM, the cloud's spot warning, or a
programmatic `PreemptionNotice.deliver()`) sets a flag the step loop
reads between steps; the run then saves within the notice budget
(`$SKYTPU_TRAIN_PREEMPT_NOTICE_BUDGET`, 30 s by default:
`CheckpointManager.save_within_deadline`) and yields, and a relaunch at
the surviving dp extent (`surviving_extent`) resumes through the
template-decided restore and steps with the extent-invariant
`make_elastic_train_step`, so the loss curve is bit-identical to a run
never preempted over the same data order. The run-scoped facts that
must outlive a process (the canonical extent, the extent the run last
trained at, and the resize lineage) live in the `elastic.json` sidecar
beside the checkpoints.

New in the port: ranks are separate processes, so a notice that reaches
any one rank must stop every rank at the same step. The loop agrees on
it once between steps (`TrainGroup.any`, one small host all-reduce),
which is no step collective and is not counted as one.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from skypilot_tpu_torch.observability import metrics as _obs
from skypilot_tpu_torch.utils import fault_injection

logger = logging.getLogger(__name__)

_PREEMPTIONS = _obs.counter(
    'skytpu_train_preemptions_total',
    'Preemption notices the elastic training loop handled (checkpoint '
    'within the notice budget, then yield for relaunch)')
_RESIZES = _obs.counter(
    'skytpu_train_elastic_resizes_total',
    'dp-extent changes across elastic incarnations', ('direction',))


def record_preemption() -> None:
    """Count a handled preemption notice (the run.py and
    ElasticTrainLoop notice paths share this counter)."""
    _PREEMPTIONS.inc()


def notice_budget_seconds() -> float:
    """The training preemption-notice budget: how long the run has
    between the notice and the kill to commit its checkpoint."""
    try:
        return float(os.environ.get(
            'SKYTPU_TRAIN_PREEMPT_NOTICE_BUDGET', 30.0))
    except ValueError:
        return 30.0


class PreemptionNotice:
    """Thread-safe preemption flag the step loop polls between steps.

    `install_sigterm()` wires the cloud's spot warning to it; tests call
    `deliver()` directly (optionally armed via the `train.notice`
    injection point: a failure there simulates a notice that never
    reaches the trainer)."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._delivered_at: Optional[float] = None

    def deliver(self) -> None:
        fault_injection.point('train.notice')
        self._delivered_at = time.monotonic()
        self._event.set()

    def pending(self) -> bool:
        return self._event.is_set()

    def clear(self) -> None:
        self._event.clear()
        self._delivered_at = None

    def remaining_budget(self, budget_s: float) -> float:
        """How much of the notice budget is LEFT, measured from notice
        delivery (the kill clock starts when the warning is sent, not
        when the step loop polls it)."""
        if self._delivered_at is None:
            return budget_s
        return max(0.0, budget_s - (time.monotonic() - self._delivered_at))

    def install_sigterm(self) -> None:
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):  # pylint: disable=unused-argument
            logger.warning('SIGTERM: preemption notice — checkpointing '
                           'within the notice budget')
            try:
                self.deliver()
            except fault_injection.InjectedFault:
                # A notice lost in delivery: the loop never sees the flag
                # (a signal handler must not raise).
                pass
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, _handler)


def surviving_extent(canonical_dp: int, available_devices: int) -> int:
    """Largest dp extent that (a) divides the canonical extent — the
    elastic step's invariance requirement — and (b) fits the surviving
    devices. This is the extent a post-preemption relaunch runs at
    instead of waiting for full capacity."""
    if canonical_dp < 1:
        raise ValueError(f'canonical_dp must be >= 1, got {canonical_dp}')
    if available_devices < 1:
        raise ValueError('no surviving devices')
    dp = min(canonical_dp, available_devices)
    while canonical_dp % dp:
        dp -= 1
    return dp


@dataclasses.dataclass
class ElasticMeta:
    """The elastic.json sidecar: run-scoped extent + lineage that must
    survive relaunches (the lora.json pattern)."""
    canonical_dp: int
    dp: int
    lineage: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @classmethod
    def path(cls, checkpoint_dir: str) -> str:
        return os.path.join(os.path.expanduser(checkpoint_dir),
                            'elastic.json')

    @classmethod
    def load(cls, checkpoint_dir: str) -> Optional['ElasticMeta']:
        try:
            with open(cls.path(checkpoint_dir), encoding='utf-8') as f:
                raw = json.load(f)
            return cls(canonical_dp=int(raw['canonical_dp']),
                       dp=int(raw['dp']),
                       lineage=list(raw.get('lineage', [])))
        except (OSError, ValueError, KeyError, TypeError) as e:
            # A sidecar that parses but lacks the schema is as unusable as
            # a torn one: treat it as absent, loudly.
            if os.path.exists(cls.path(checkpoint_dir)):
                logger.warning('ignoring unreadable elastic sidecar %s '
                               '(%s: %s)', cls.path(checkpoint_dir),
                               type(e).__name__, e)
            return None

    def save(self, checkpoint_dir: str) -> None:
        path = self.path(checkpoint_dir)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + '.tmp'
        with open(tmp, 'w', encoding='utf-8') as f:
            json.dump(dataclasses.asdict(self), f)
        os.replace(tmp, path)  # atomic publish, never a torn sidecar


def revalidate_extent(checkpoint_dir: str, canonical_dp: int, dp: int,
                      step: int, coordinator: bool = True) -> ElasticMeta:
    """dp-extent revalidation at incarnation start: check the requested
    extent against the run's sidecar, record the resize (direction
    metric + lineage) when the extent changed, and refuse a canonical
    extent that contradicts the one the run was started with. Only the
    `coordinator` (rank 0) writes the sidecar and counts the resize; every
    rank refuses."""
    meta = ElasticMeta.load(checkpoint_dir)
    if meta is None:
        meta = ElasticMeta(canonical_dp=canonical_dp, dp=dp)
        if coordinator:
            meta.save(checkpoint_dir)
        return meta
    if meta.canonical_dp != canonical_dp:
        raise ValueError(
            f'elastic run in {checkpoint_dir!r} was started with '
            f'canonical extent {meta.canonical_dp}, not {canonical_dp}: '
            f'the canonical extent is fixed for the life of a run (it '
            f'defines the bit-parity contract); resume with '
            f'--dp {meta.canonical_dp} or use a fresh checkpoint dir')
    if meta.dp != dp:
        direction = 'up' if dp > meta.dp else 'down'
        meta.lineage.append({'step': step, 'from_dp': meta.dp,
                             'to_dp': dp, 'at': time.time()})
        meta.dp = dp
        if coordinator:
            _RESIZES.labels(direction=direction).inc()
            logger.warning('elastic resize %s: dp %d -> %d at step %d '
                           '(lineage depth %d)', direction,
                           meta.lineage[-1]['from_dp'], dp, step,
                           len(meta.lineage))
            meta.save(checkpoint_dir)
    return meta


@dataclasses.dataclass
class IncarnationResult:
    """What one `ElasticTrainLoop.run` call accomplished. A notice save
    that missed its deadline (checkpoint_committed False) may leave the
    incarnation's group broken (CheckpointManager.save_within_deadline):
    it must not be used again."""
    next_step: int            # first step NOT yet trained
    preempted: bool           # stopped on a notice (vs ran to target)
    checkpoint_committed: bool  # the notice-time save made it in time
    dp: int                   # extent this incarnation ran at
    resume_latency_s: float   # restore + revalidate wall time
    series: List[Any]         # (loss, grad_norm) per completed step


class ElasticTrainLoop:
    """One relaunchable elastic training run over a checkpoint dir.

    Each `run()` call is ONE incarnation at a given live extent: every
    rank of the group calls it (SPMD), builds the state (ZeRO-1, as the
    reference's default), restores the newest VALID checkpoint onto it
    (a corrupt newest falls back older), revalidates the extent, then
    steps with the extent-invariant elastic step until `total_steps` or
    a preemption notice on any rank. Whoever launches the incarnations
    (a managed job's controller, a test) decides each one's extent; the
    loop never chooses."""

    def __init__(self, cfg, train_config, checkpoint_dir: str, *,
                 canonical_dp: int, save_every: int = 1,
                 device='cuda') -> None:
        self.cfg = cfg
        self.train_config = train_config
        self.checkpoint_dir = checkpoint_dir
        self.canonical_dp = canonical_dp
        self.save_every = save_every
        self.device = device

    def run(self, dp: int, batch_for: Callable[[int], Dict[str, Any]],
            total_steps: int,
            notice: Optional[PreemptionNotice] = None,
            notice_budget_s: Optional[float] = None,
            group=None) -> Optional[IncarnationResult]:
        """One incarnation at extent `dp`. `group`: this rank's
        parallel/mesh.TrainGroup of at least `dp` ranks (default:
        `train_group(dp)` on the loop's device, which under torchrun joins
        the job). A larger group runs the incarnation on its first `dp`
        ranks (TrainGroup.split), so one set of processes can step down
        to a surviving extent and back; every rank of it calls run, and
        the ranks left out return None at once. Every rank passes the
        same `batch_for` (step -> global batch)."""
        from skypilot_tpu_torch.parallel.mesh import train_group
        from skypilot_tpu_torch.train.checkpoints import CheckpointManager
        from skypilot_tpu_torch.train.trainer import (create_train_state,
                                                      make_elastic_train_step)

        if group is None:
            group = train_group(dp, device=self.device)
        if group.dp < dp:
            raise ValueError(f'elastic incarnation at dp={dp} on a group of '
                             f'{group.dp} ranks')
        group = group.split(dp)
        if group is None:
            return None
        budget = (notice_budget_seconds() if notice_budget_s is None
                  else notice_budget_s)
        t0 = time.monotonic()
        state = create_train_state(self.cfg, self.train_config,
                                   device=group.device, seed=0, group=group,
                                   zero1=True)
        manager = CheckpointManager(self.checkpoint_dir,
                                    save_interval_steps=self.save_every)
        state, start_step = manager.restore_latest_valid(state)
        revalidate_extent(self.checkpoint_dir, self.canonical_dp, dp,
                          start_step, coordinator=group.rank == 0)
        step_fn = make_elastic_train_step(self.canonical_dp)
        resume_latency = time.monotonic() - t0
        series: List[Any] = []
        step = start_step
        while step < total_steps:
            if group.any(notice is not None and notice.pending()):
                record_preemption()
                left = (notice.remaining_budget(budget) if notice is not None
                        else budget)
                committed = manager.save_within_deadline(step, state, left)
                return IncarnationResult(
                    next_step=step, preempted=True,
                    checkpoint_committed=committed, dp=dp,
                    resume_latency_s=resume_latency, series=series)
            fault_injection.point('train.step')
            metrics = step_fn(state, batch_for(step))
            series.append((float(metrics['loss']),
                           float(metrics['grad_norm'])))
            step += 1
            manager.save(step, state)
        if manager.latest_step() != total_steps:
            manager.save(total_steps, state, force=True)
        return IncarnationResult(
            next_step=step, preempted=False, checkpoint_committed=True,
            dp=dp, resume_latency_s=resume_latency, series=series)
