"""Deterministic fault injection for chaos testing.

Own copy of skypilot_tpu/utils/fault_injection.py (stdlib only; every
function and class is the reference's), with the injection points the
port's device stack fires, at the reference's places:

    engine.decode   models/inference.ContinuousBatchingEngine._tick —
                    before the decode dispatch (a wedge here is what the
                    engine watchdog recovers from)
    replica.preempt_kill
                    serve/server preemption notice — between drain and
                    prefix export; a failure simulates the replica dying
                    mid-notice (the kill lands before the export
                    publishes)
    storage.export  models/inference export_prefixes — per exported
                    prefix (nothing is published)
    storage.import  models/inference import_prefixes — per imported
                    prefix (nothing leaks)
    kv.stream       serve/server — before each KV handoff chunk push
                    (prefill replica -> decode /kv/ingest); a failure
                    simulates the prefill replica dying mid-stream (the
                    partial ingest must roll back to refcount 0 on the
                    decode side)
    engine.ingest   models/inference ingest_chunk — as a decode replica
                    receives a handoff chunk; a failure simulates the
                    ingest path dying mid-stream
    engine.slot_preempt
                    models/inference — inside the tier preemption loop,
                    before a batch slot yields to an interactive arrival
    tenant.adapter_load
                    models/inference._ensure_resident — before an
                    adapter is made resident (host -> device copy)
    tenant.evict    models/inference._ensure_resident / unload_adapter —
                    before a resident adapter is evicted
    train.step      train/elastic.ElasticTrainLoop.run — before each
                    elastic train step; a failure simulates the slice
                    dying mid-step with no notice (only the in-flight
                    step re-runs)
    train.save      train/checkpoints.CheckpointManager.save and
                    save_within_deadline — before a checkpoint save
                    starts; a failure simulates a dead checkpoint mount
                    (the run keeps the last committed step)
    train.notice    train/elastic.PreemptionNotice.deliver — a failure
                    simulates a preemption notice lost in delivery (the
                    kill lands with no final checkpoint)

The reference's points the port does not fire stay out of KNOWN_POINTS:
the control plane's ``rpc.send``, ``replica.probe``,
``replica.preempt_notice``, ``storage.chunk``, ``lb.digest`` and
``lb.handoff`` (CONTROL_PLANE_POINTS names them).

Disarmed (the default) a point is one module-level boolean check.
Arming is programmatic (tests) or through the ``SKYTPU_FAULTS``
environment variable, parsed once at import:

    SKYTPU_FAULTS='kv.stream=fail:1;storage.export=delay:0.05'

Behaviors: ``fail[:N]`` raises InjectedFault on the first N firings
(default: every firing), ``delay:SECS`` sleeps, ``wedge`` blocks until
release()/disarm. Schedules count firings, never wall clock.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

logger = logging.getLogger(__name__)

# The documented injection points the port has (the reference's names,
# at the reference's places).
KNOWN_POINTS = (
    'engine.decode',
    'replica.preempt_kill',
    'storage.export',
    'storage.import',
    'kv.stream',
    'engine.ingest',
    'train.step',
    'train.save',
    'train.notice',
    'tenant.adapter_load',
    'tenant.evict',
    'engine.slot_preempt',
)

# The reference's points whose code the port does not have: its control
# plane's.
CONTROL_PLANE_POINTS = ('rpc.send', 'replica.probe',
                        'replica.preempt_notice', 'storage.chunk',
                        'lb.digest', 'lb.handoff')


class InjectedFault(Exception):
    """Raised by an armed ``fail`` injection point."""


class _Spec:
    """One armed behavior. `remaining` counts down for fail:N (None =
    unlimited); `release` unblocks a wedge."""

    __slots__ = ('behavior', 'remaining', 'delay', 'release', 'trips')

    def __init__(self, behavior: str, remaining: Optional[int] = None,
                 delay: float = 0.0) -> None:
        self.behavior = behavior
        self.remaining = remaining
        self.delay = delay
        self.release = threading.Event()
        self.trips = 0


_lock = threading.Lock()
_specs: Dict[str, _Spec] = {}
# Fast-path flag: point() reads this single boolean when nothing is
# armed. Not under the lock on purpose — worst case a racing reader
# misses a fault armed concurrently, which no schedule relies on.
_armed = False


def point(name: str) -> None:
    """An injection point. No-op unless `name` is armed."""
    if not _armed:
        return
    _fire(name)


def _fire(name: str) -> None:
    with _lock:
        spec = _specs.get(name)
        if spec is None:
            return
        spec.trips += 1
        behavior = spec.behavior
        if behavior == 'fail':
            if spec.remaining is not None:
                if spec.remaining <= 0:
                    return
                spec.remaining -= 1
            raise InjectedFault(name)
        delay = spec.delay
        release = spec.release
    # delay/wedge block OUTSIDE the lock so other points stay live.
    if behavior == 'delay':
        import time
        time.sleep(delay)
    elif behavior == 'wedge':
        logger.warning('fault injection: %s wedged', name)
        release.wait()


def arm(name: str, behavior: str) -> None:
    """Arm `name` with a behavior string (see module docstring)."""
    global _armed
    spec = _parse_behavior(behavior)
    with _lock:
        _specs[name] = spec
        _armed = True


def _parse_behavior(behavior: str) -> _Spec:
    kind, _, arg = behavior.partition(':')
    if kind == 'fail':
        return _Spec('fail', remaining=int(arg) if arg else None)
    if kind == 'delay':
        return _Spec('delay', delay=float(arg or 0.1))
    if kind == 'wedge':
        return _Spec('wedge')
    raise ValueError(f'unknown fault behavior {behavior!r}; '
                     "expected 'fail[:N]', 'delay:SECS', or 'wedge'")


def release(name: str) -> None:
    """Unblock a wedge without disarming it (subsequent firings pass
    straight through the set event)."""
    with _lock:
        spec = _specs.get(name)
    if spec is not None:
        spec.release.set()


def disarm(name: str) -> None:
    global _armed
    with _lock:
        spec = _specs.pop(name, None)
        _armed = bool(_specs)
    if spec is not None:
        spec.release.set()  # free any thread wedged on it


def disarm_all() -> None:
    global _armed
    with _lock:
        specs = list(_specs.values())
        _specs.clear()
        _armed = False
    for spec in specs:
        spec.release.set()


def armed() -> bool:
    return _armed


def trip_count(name: str) -> int:
    """How many times `name` fired while armed (0 when never armed —
    the disarmed fast path does not count)."""
    with _lock:
        spec = _specs.get(name)
        return spec.trips if spec is not None else 0


def parse_spec(spec: str) -> Dict[str, str]:
    """'a=fail:2;b=wedge' → {'a': 'fail:2', 'b': 'wedge'}."""
    out: Dict[str, str] = {}
    for part in spec.split(';'):
        part = part.strip()
        if not part:
            continue
        name, sep, behavior = part.partition('=')
        if not sep or not name or not behavior:
            raise ValueError(f'bad SKYTPU_FAULTS entry {part!r}; '
                             'expected name=behavior')
        out[name.strip()] = behavior.strip()
    return out


def _arm_from_env() -> None:
    spec = os.environ.get('SKYTPU_FAULTS', '')
    if not spec:
        return
    try:
        for name, behavior in parse_spec(spec).items():
            arm(name, behavior)
            logger.warning('fault injection armed from SKYTPU_FAULTS: '
                           '%s=%s', name, behavior)
    except ValueError as e:
        raise ValueError(f'invalid SKYTPU_FAULTS={spec!r}: {e}') from e


_arm_from_env()
