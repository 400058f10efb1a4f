"""Process-wide metrics registry: Counter, Gauge, Histogram with labels.

Own copy of skypilot_tpu/observability/metrics.py, exemplars included:

- **Near-zero cost when no exporter is attached.** Recording methods
  (`inc`/`set`/`observe`) return after ONE module-level boolean check,
  no locks and no allocations. Hot paths (the per-token decode loop)
  bind label children once, at import or engine construction, so the
  per-event call is `child.inc()`, never a `.labels()` dict build.
- **Lock-free reads.** Exposition walks plain attributes; each read is a
  GIL-consistent snapshot of one value. Writers take a per-child lock
  (only when enabled) so concurrent increments never lose counts.

Metric constructors are **get-or-create** on (name, registry): two call
sites naming the same metric share one object; re-declaring a name as a
different kind, or with different labels or buckets, is an error.

The only import-time side effect is reading ``SKYTPU_METRICS`` into the
enabled boolean.
"""
from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Fast-path flag: every recording method reads this single boolean
# first. Not synchronized on purpose — worst case a racing reader
# misses an enable() flipped concurrently, which no scrape relies on.
_enabled = False


def enable() -> None:
    """Turn recording on (called when an exporter attaches)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


_NAME_OK = frozenset(
    'abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:')
_LABEL_OK = frozenset(
    'abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_')

# Latency buckets (seconds) sized for serving: sub-ms ticks on-chip up
# through multi-second cold prefills.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _check_name(name: str, what: str, allowed: frozenset) -> None:
    if not name or not set(name) <= allowed or name[0].isdigit():
        raise ValueError(f'invalid {what} {name!r}')


class _Child:
    """One (metric, labelvalues) time series holding a scalar."""

    __slots__ = ('_lock', '_value')

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value  # lock-free read (GIL-consistent)


class _CounterChild(_Child):

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        if amount < 0:
            raise ValueError('counters only go up')
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):

    __slots__ = ()

    def set(self, value: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


# Exemplar retention window (seconds): within a window the WORST
# (largest) exemplar-carrying observation wins; an exemplar older than
# the window is replaced by the next one regardless, so the linked
# trace stays findable in the trace ring.
EXEMPLAR_WINDOW_S = 60.0


class _HistogramChild:
    """Per-bucket counts + sum + count. Buckets store NON-cumulative
    counts; exposition accumulates, so observe() touches exactly one
    bucket slot.

    `exemplar` (optional): a trace_id linking this observation to a
    span tree. The child keeps the worst (max-value) exemplar per
    EXEMPLAR_WINDOW_S. The default `None` adds one is-None check inside
    the already-taken lock: the disabled fast path is unchanged."""

    __slots__ = ('_lock', '_buckets', '_counts', '_sum', '_count',
                 '_exemplar')

    def __init__(self, buckets: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # +1 = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._exemplar: Optional[Tuple[float, str, float]] = None

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        if not _enabled:
            return
        idx = bisect.bisect_left(self._buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                prev = self._exemplar
                now = time.monotonic()
                if prev is None or value > prev[0] or \
                        now - prev[2] > EXEMPLAR_WINDOW_S:
                    self._exemplar = (value, exemplar, now)

    @property
    def exemplar(self) -> Optional[Tuple[float, str, float]]:
        """(value, trace_id, monotonic stamp) of the retained worst
        sample, or None: lock-free snapshot (one attribute read)."""
        return self._exemplar

    @property
    def value(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts, sum, count): lock-free snapshot; a scrape
        racing an observe may see the bucket before sum/count, which
        monotone Prometheus consumers tolerate."""
        return list(self._counts), self._sum, self._count


class _Metric:
    """Base: a named family of children keyed by label values."""

    kind = ''

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = ()) -> None:
        _check_name(name, 'metric name', _NAME_OK)
        for label in labelnames:
            _check_name(label, 'label name', _LABEL_OK)
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # Label-less metric: one implicit child, bound as attributes
            # so `metric.inc()` is the child call (no indirection on the
            # hot path).
            child = self._make_child()
            self._children[()] = child
            self._bind(child)

    def _make_child(self):
        raise NotImplementedError

    def _bind(self, child) -> None:
        raise NotImplementedError

    def labels(self, **labelvalues: str):
        """Get-or-create the child for these label values. Hot paths
        should call this ONCE (import/init time) and keep the child."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f'{self.name}: expected labels {self.labelnames}, '
                f'got {tuple(labelvalues)}')
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def samples(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        """(labelvalues, child) pairs — lock-free iteration over a
        point-in-time copy of the child table."""
        return list(self._children.items())

    def prune(self, keep) -> int:
        """Drop children whose labels dict fails `keep(labels)` —
        the anti-leak hook for dynamic label values (e.g. per-replica
        series after the replica is torn down). No-op on label-less
        metrics (their single implicit child is the metric). Returns
        the number of series removed."""
        if not self.labelnames:
            return 0
        removed = 0
        with self._lock:
            for key in list(self._children):
                if not keep(dict(zip(self.labelnames, key))):
                    del self._children[key]
                    removed += 1
        return removed


class Counter(_Metric):
    """Monotone counter. Its name should end in `_total` (a convention,
    not enforced)."""

    kind = 'counter'

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def _bind(self, child: _CounterChild) -> None:
        self.inc = child.inc
        self.value = lambda: child.value


class Gauge(_Metric):

    kind = 'gauge'

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def _bind(self, child: _GaugeChild) -> None:
        self.set = child.set
        self.inc = child.inc
        self.dec = child.dec
        self.value = lambda: child.value


class Histogram(_Metric):

    kind = 'histogram'

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        # Dedupe: duplicate bounds would render duplicate le= sample
        # lines, which strict parsers (ours included) reject.
        buckets = tuple(sorted({float(b) for b in buckets}))
        if not buckets:
            raise ValueError('histogram needs at least one bucket')
        self.buckets = buckets
        super().__init__(name, help_text, labelnames)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def _bind(self, child: _HistogramChild) -> None:
        self.observe = child.observe
        self.value = lambda: child.value
        self.exemplar = lambda: child.exemplar


class Registry:
    """Name → metric table; `collect()` is the exposition's input."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if (existing.kind != metric.kind or
                        existing.labelnames != metric.labelnames or
                        getattr(existing, 'buckets', None) !=
                        getattr(metric, 'buckets', None)):
                    raise ValueError(
                        f'metric {metric.name!r} already registered as '
                        f'{existing.kind}{existing.labelnames}'
                        f'{getattr(existing, "buckets", "")}, cannot '
                        f're-register as {metric.kind}'
                        f'{metric.labelnames}'
                        f'{getattr(metric, "buckets", "")}')
                return existing
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def collect(self) -> List[_Metric]:
        """Registered metrics in insertion order (dicts preserve it)."""
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Drop every metric (module-scope metric objects keep working
        but stop being exported)."""
        with self._lock:
            self._metrics.clear()


# The process-wide default registry every subsystem records into and
# every /metrics route exposes.
REGISTRY = Registry()


def counter(name: str, help_text: str, labelnames: Sequence[str] = (),
            registry: Registry = REGISTRY) -> Counter:
    """Get-or-create a Counter (idempotent per registry)."""
    return registry.register(Counter(name, help_text, labelnames))


def gauge(name: str, help_text: str, labelnames: Sequence[str] = (),
          registry: Registry = REGISTRY) -> Gauge:
    return registry.register(Gauge(name, help_text, labelnames))


def histogram(name: str, help_text: str, labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS,
              registry: Registry = REGISTRY) -> Histogram:
    return registry.register(Histogram(name, help_text, labelnames,
                                       buckets))


def _enable_from_env() -> None:
    # A boolean flip only: no exporter, thread or socket at import.
    if os.environ.get('SKYTPU_METRICS', '') == '1':
        enable()


_enable_from_env()
