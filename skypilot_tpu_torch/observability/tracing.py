"""End-to-end request tracing + flight recorder.

Own copy of skypilot_tpu/observability/tracing.py (stdlib only; every
function and class is the reference's). Aggregate histograms
(``metrics.py``) answer "how is the fleet doing"; this module answers
"where did THIS request's milliseconds go" across the serving path
(server -> engine queue -> prefill -> decode ticks, and the
disaggregated prefill tier -> per-chunk KV stream -> decode tier
ingest), and "what was the engine doing in the seconds before" a wedge
recovery, tick failure or preemption notice (the flight recorder).

Design constraints (pinned by tests/test_torch_tracing.py):

- **Zero cost when disabled.** Recording is off by default behind ONE
  module-level boolean. With tracing disabled the decode tick pays no
  span allocation and no clock reads: per-request span state is
  ``None`` so the per-tick guard is a plain identity check; ``span()``
  returns one shared no-op handle. Every internal clock read funnels
  through ``_now`` so the overhead test can poison it.
- **Bounded memory.** Spans land in an in-process ring
  (``SKYTPU_TRACE_RING``, default 8192 spans); overflow drops the
  OLDEST span and counts ``skytpu_trace_spans_dropped_total``.
- **Context is explicit OR ambient, never guessed.** The ambient current
  span is a ``contextvars.ContextVar``: correct across asyncio tasks and
  across threads (each engine thread sees only what it ``activate()``d).

Wire format (the ``X-SkyTPU-Trace`` header, traceparent-style):

    00-<32 hex trace_id>-<16 hex span_id>-01

The server continues the header of each request; the KV chunk header's
``trace`` field carries it so the decode replica's ingest spans join the
sender's trace. Headers and span records are the reference's, so a port
replica and a reference replica join one trace.

Span names are a closed vocabulary: every ``span(...)`` /
``start_span(...)`` / ``record_span(...)`` call site uses a literal name
from ``KNOWN_SPANS``. The reference's five ``lb.*`` spans belong to its
load balancer (the control plane), which the port does not have.
"""
from __future__ import annotations

import collections
import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.observability import metrics as _metrics

# ---------------------------------------------------------------------
# enable/disable (the one boolean every recording call checks first)
# ---------------------------------------------------------------------

_enabled = False

TRACE_HEADER = 'X-SkyTPU-Trace'

# The closed span-name vocabulary: the reference's, less the load
# balancer's five `lb.*` spans (the control plane the port does not
# have; named in CONTROL_PLANE_SPANS).
KNOWN_SPANS = (
    # HTTP server (serve/server.py)
    'server.request',        # one handled request (continues the caller's trace)
    'server.kv_push',        # prefill tier pushing chunks to /kv/ingest
    'server.preempt_notice',  # the notice body: drain + export window
    # Engine (models/inference.py)
    'engine.queue_wait',     # submit -> admission into a decode slot
    'engine.prefill',        # admission -> first token (chunked)
    'engine.decode',         # first token -> finish (coalesced, slot attr)
    'engine.ingest_chunk',   # one handoff chunk applied on the decode tier
    'engine.ingest_publish',  # final-chunk scatter + prefix-index publish
    'engine.wedge_recovery',  # watchdog recovery (flight-record trigger)
    'engine.tick_failure',   # tick exception recovery (flight-record trigger)
    'engine.preempt_export',  # preemption-notice prefix export
    'engine.adapter_load',   # adapter made resident (tick thread, slot attr)
    'engine.slot_preempt',   # batch slot yielded to an interactive arrival
)

# The reference's spans that stay out of the port: its load balancer's.
CONTROL_PLANE_SPANS = ('lb.request', 'lb.route', 'lb.proxy', 'lb.handoff',
                       'lb.handoff_attempt')

# Tracing metrics.
_SPANS_RECORDED = _metrics.counter(
    'skytpu_trace_spans_recorded_total',
    'Spans recorded into the in-process trace ring')
_SPANS_DROPPED = _metrics.counter(
    'skytpu_trace_spans_dropped_total',
    'Spans evicted from the trace ring by overflow (oldest-first; '
    'size the ring with SKYTPU_TRACE_RING)')
_FLIGHT_RECORDS = _metrics.counter(
    'skytpu_trace_flight_records_total',
    'Flight records dumped, by trigger (wedge_recovery / tick_failure '
    '/ preempt_notice)', ('trigger',))


def enable() -> None:
    """Turn span recording on (anchors the wall clock once so span
    timestamps stay monotonic-derived afterwards)."""
    global _enabled, _anchor
    if _anchor is None:
        _anchor = (time.time(), time.monotonic())
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def active() -> bool:
    """True when the FLIGHT RECORDER should fire: tracing is on, or an
    operator pinned a flight directory (a recorder with no spans still
    captures step_log/tick_stats — better than nothing on a wedge)."""
    return _enabled or bool(os.environ.get('SKYTPU_FLIGHT_DIR'))


# Internal clock funnel: every span start/end reads THIS symbol, so the
# disabled-path overhead test can poison it and prove the decode tick
# never touches a clock while tracing is off.
_now = time.monotonic


def now() -> float:
    """Monotonic seconds through the tracer's clock funnel (callers
    that record after-the-fact spans share the poisoning seam)."""
    return _now()


# Wall anchor: (time.time(), time.monotonic()) captured once at
# enable(); span wall timestamps derive as anchor_wall + (mono -
# anchor_mono) so the hot path reads ONLY the monotonic clock.
_anchor: Optional[tuple] = None


def _wall_us(mono: float) -> float:
    if _anchor is None:
        return mono * 1e6
    wall0, mono0 = _anchor
    return (wall0 + (mono - mono0)) * 1e6


# ---------------------------------------------------------------------
# span ring
# ---------------------------------------------------------------------

_RING_CAP = max(64, int(os.environ.get('SKYTPU_TRACE_RING', '8192')))
_ring: 'collections.deque[dict]' = collections.deque(maxlen=_RING_CAP)
_ring_lock = threading.Lock()


def _record(span: dict) -> None:
    with _ring_lock:
        if len(_ring) == _ring.maxlen:
            _SPANS_DROPPED.inc()
        _ring.append(span)
    _SPANS_RECORDED.inc()


def snapshot(window_s: Optional[float] = None) -> List[dict]:
    """Point-in-time copy of the span ring (oldest first), optionally
    restricted to spans that STARTED within the last `window_s`
    seconds."""
    with _ring_lock:
        spans = list(_ring)
    if window_s is not None:
        cutoff = _now() - window_s
        spans = [s for s in spans if s['mono'] >= cutoff]
    return spans


def reset() -> None:
    """Drop every recorded span (tests only)."""
    with _ring_lock:
        _ring.clear()


# ---------------------------------------------------------------------
# context + propagation
# ---------------------------------------------------------------------


class SpanContext:
    """The (trace_id, span_id) pair a child span parents to — what
    rides the X-SkyTPU-Trace header and the KV chunk headers."""

    __slots__ = ('trace_id', 'span_id')

    def __init__(self, trace_id: str, span_id: str) -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f'SpanContext({self.trace_id}, {self.span_id})'


_current: 'contextvars.ContextVar[Optional[SpanContext]]' = \
    contextvars.ContextVar('skytpu_trace_current', default=None)


def current() -> Optional[SpanContext]:
    """The ambient span context (None when tracing is disabled — the
    one-boolean fast path every capture site relies on)."""
    if not _enabled:
        return None
    return _current.get()


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def header_value(ctx: Optional[SpanContext]) -> Optional[str]:
    """Render `ctx` as the X-SkyTPU-Trace header value (traceparent
    style: version 00, sampled flag 01), or None for no context."""
    if ctx is None:
        return None
    return f'00-{ctx.trace_id}-{ctx.span_id}-01'


def parse_header(value: Optional[str]) -> Optional[SpanContext]:
    """Parse an X-SkyTPU-Trace value; garbage returns None (trace
    propagation must never fail a request)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split('-')
    if len(parts) != 4:
        return None
    _version, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id, span_id)


class _Activation:
    """Context manager setting the ambient context (executor threads
    adopting a request's trace); `activate(None)` is a no-op."""

    __slots__ = ('_ctx', '_token')

    def __init__(self, ctx: Optional[SpanContext]) -> None:
        self._ctx = ctx
        self._token = None

    def __enter__(self) -> '_Activation':
        if self._ctx is not None and _enabled:
            self._token = _current.set(self._ctx)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None


def activate(ctx: Optional[SpanContext]) -> _Activation:
    return _Activation(ctx)


# ---------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------


class _SpanHandle:
    """One live span. As a context manager it also installs itself as
    the ambient context (children created inside parent to it)."""

    __slots__ = ('ctx', 'name', '_parent_id', '_start', '_attrs',
                 '_token', '_done')

    def __init__(self, name: str, parent: Optional[SpanContext],
                 attrs: Optional[Dict[str, Any]]) -> None:
        self.name = name
        if parent is not None:
            trace_id = parent.trace_id
            self._parent_id: Optional[str] = parent.span_id
        else:
            trace_id = _new_id(16)
            self._parent_id = None
        self.ctx = SpanContext(trace_id, _new_id(8))
        self._start = _now()
        self._attrs = dict(attrs) if attrs else {}
        self._token = None
        self._done = False

    def set_attr(self, key: str, value: Any) -> None:
        self._attrs[key] = value

    def end(self, **attrs: Any) -> None:
        if self._done:
            return
        self._done = True
        if attrs:
            self._attrs.update(attrs)
        end = _now()
        _record({
            'name': self.name,
            'trace_id': self.ctx.trace_id,
            'span_id': self.ctx.span_id,
            'parent_id': self._parent_id,
            'ts_us': round(_wall_us(self._start), 3),
            'mono': self._start,
            'dur_us': round((end - self._start) * 1e6, 3),
            'pid': os.getpid(),
            'tid': threading.get_ident(),
            'attrs': self._attrs,
        })

    def __enter__(self) -> '_SpanHandle':
        self._token = _current.set(self.ctx)
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self._attrs.setdefault('error', f'{exc_type.__name__}: {exc}')
        self.end()


class _NullSpan:
    """The shared no-op handle the disabled path returns: no
    allocation, no clocks, `ctx` is None so header propagation and
    per-request capture short-circuit on an identity check."""

    __slots__ = ()
    ctx = None
    name = ''

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def end(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> '_NullSpan':
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


def span(name: str, parent: Optional[SpanContext] = None,
         attrs: Optional[Dict[str, Any]] = None):
    """Start a span (context manager). Parent resolution: explicit
    `parent`, else the ambient context, else a fresh trace is minted.
    Disabled tracing returns the shared no-op handle."""
    if not _enabled:
        return NULL_SPAN
    return _SpanHandle(name, parent if parent is not None
                       else _current.get(), attrs)


def start_span(name: str, parent: Optional[SpanContext] = None,
               attrs: Optional[Dict[str, Any]] = None):
    """Non-lexical twin of `span()`: the caller holds the handle and
    calls `.end(**attrs)` (paths where `with` blocks don't line up with
    the request lifecycle)."""
    if not _enabled:
        return NULL_SPAN
    return _SpanHandle(name, parent if parent is not None
                       else _current.get(), attrs)


def record_span(name: str, start_mono: float, end_mono: float,
                parent: Optional[SpanContext] = None,
                attrs: Optional[Dict[str, Any]] = None
                ) -> Optional[SpanContext]:
    """Record a span AFTER the fact from monotonic stamps the caller
    already holds (queue-wait: submit_time → admit_time). Returns the
    new span's context (for chaining) or None when disabled."""
    if not _enabled:
        return None
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        ambient = _current.get()
        if ambient is not None:
            trace_id, parent_id = ambient.trace_id, ambient.span_id
        else:
            trace_id, parent_id = _new_id(16), None
    ctx = SpanContext(trace_id, _new_id(8))
    _record({
        'name': name,
        'trace_id': trace_id,
        'span_id': ctx.span_id,
        'parent_id': parent_id,
        'ts_us': round(_wall_us(start_mono), 3),
        'mono': start_mono,
        'dur_us': round(max(0.0, end_mono - start_mono) * 1e6, 3),
        'pid': os.getpid(),
        'tid': threading.get_ident(),
        'attrs': dict(attrs) if attrs else {},
    })
    return ctx


# ---------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------

# Synthetic track ids: spans render on per-subsystem tracks
# ('spans:server', 'spans:engine', ...), the reference's ids, so the two
# frameworks' exports merge into one view.
_SPAN_TRACK_BASE = 900000


def perfetto_events(spans: Optional[List[dict]] = None) -> List[dict]:
    """Chrome-trace events for `spans` (default: the current ring):
    one 'X' complete event per span plus 'M' thread_name metadata
    naming each subsystem track."""
    if spans is None:
        spans = snapshot()
    subsystems = sorted({s['name'].split('.', 1)[0] for s in spans})
    tids = {sub: _SPAN_TRACK_BASE + i
            for i, sub in enumerate(subsystems)}
    pid = os.getpid()
    events: List[dict] = [
        {'name': 'thread_name', 'ph': 'M', 'pid': pid, 'tid': tid,
         'args': {'name': f'spans:{sub}'}}
        for sub, tid in tids.items()
    ]
    for s in spans:
        args = {'trace_id': s['trace_id'], 'span_id': s['span_id']}
        if s.get('parent_id'):
            args['parent_id'] = s['parent_id']
        args.update(s.get('attrs') or {})
        events.append({
            'name': s['name'], 'cat': 'span', 'ph': 'X',
            'ts': s['ts_us'], 'dur': s['dur_us'],
            'pid': s['pid'], 'tid': tids[s['name'].split('.', 1)[0]],
            'args': args,
        })
    return events


# ---------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------

FLIGHT_SCHEMA = 'skytpu-flight/1'
_FLIGHT_WINDOW_S = 30.0


def flight_dir() -> str:
    return os.environ.get(
        'SKYTPU_FLIGHT_DIR',
        os.path.expanduser('~/.skytpu/flightrecords'))


def flight_record(trigger: str, extra: Optional[dict] = None,
                  window_s: float = _FLIGHT_WINDOW_S) -> Optional[str]:
    """Dump the last `window_s` seconds of spans plus caller-supplied
    engine state (step_log, tick stats) to a structured JSON file —
    the postmortem a wedge recovery, tick failure, or preemption
    notice leaves behind. Atomic publish (write-to-temp + rename): a
    kill mid-dump never publishes a torn record. Best-effort by contract: a full disk must not break the
    recovery path — returns the published path, or None."""
    if not active():
        return None
    try:
        directory = flight_dir()
        os.makedirs(directory, exist_ok=True)
        payload = {
            'schema': FLIGHT_SCHEMA,
            'trigger': trigger,
            'ts': time.time(),
            'window_s': window_s,
            'pid': os.getpid(),
            'spans': snapshot(window_s=window_s),
            'extra': extra or {},
        }
        path = os.path.join(
            directory, f'flight-{trigger}-{time.time_ns()}.json')
        tmp = path + '.tmp'
        with open(tmp, 'w', encoding='utf-8') as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        _FLIGHT_RECORDS.labels(trigger=trigger).inc()
        return path
    except Exception:  # pylint: disable=broad-except
        return None


# ---------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------


def _fmt_attrs(attrs: Dict[str, Any]) -> str:
    if not attrs:
        return ''
    parts = []
    for key in sorted(attrs):
        value = attrs[key]
        if isinstance(value, float):
            value = round(value, 6)
        parts.append(f'{key}={value}')
    return '  [' + ' '.join(parts) + ']'


def render_trace_tree(spans: List[dict],
                      grep: Optional[str] = None) -> List[str]:
    """Human-readable trace trees: one block per trace_id, spans
    nested by parentage (orphans — parents outside the ring — root at
    depth 0), durations in ms. `grep` keeps only traces where some
    span's name or rendered attrs contain the substring."""
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        by_trace.setdefault(s['trace_id'], []).append(s)
    lines: List[str] = []
    for trace_id in sorted(by_trace,
                           key=lambda t: min(s['ts_us']
                                             for s in by_trace[t])):
        members = sorted(by_trace[trace_id], key=lambda s: s['ts_us'])
        if grep is not None and not any(
                grep in s['name'] or grep in _fmt_attrs(s['attrs'])
                for s in members):
            continue
        ids = {s['span_id'] for s in members}
        children: Dict[Optional[str], List[dict]] = {}
        for s in members:
            parent = s['parent_id'] if s['parent_id'] in ids else None
            children.setdefault(parent, []).append(s)
        lines.append(f'trace {trace_id} ({len(members)} spans)')

        def walk(parent_id: Optional[str], depth: int) -> None:
            for s in children.get(parent_id, []):
                lines.append(
                    f'{"  " * (depth + 1)}{s["name"]} '
                    f'{s["dur_us"] / 1000.0:.2f}ms'
                    f'{_fmt_attrs(s["attrs"])}')
                walk(s['span_id'], depth + 1)

        walk(None, 0)
    return lines


def render_flight_record(record: dict) -> List[str]:
    """Postmortem view of one flight-record dict."""
    lines = [
        f'flight record: trigger={record.get("trigger")} '
        f'pid={record.get("pid")} '
        f'window={record.get("window_s")}s '
        f'spans={len(record.get("spans", []))}',
    ]
    extra = record.get('extra') or {}
    for key in sorted(extra):
        if key == 'step_log':
            continue
        lines.append(f'  {key}: {extra[key]}')
    step_log = extra.get('step_log') or []
    if step_log:
        lines.append(f'  step_log (last {len(step_log)} ticks):')
        for entry in step_log[-20:]:
            step, slots = entry[0], entry[1]
            lines.append(f'    step {step}: slots {slots}')
    tree = render_trace_tree(record.get('spans', []))
    if tree:
        lines.append('  spans:')
        lines.extend('  ' + line for line in tree)
    return lines


def _enable_from_env() -> None:
    # A boolean flip only: no thread, socket, or file at import.
    if os.environ.get('SKYTPU_TRACING', '') == '1':
        enable()


_enable_from_env()
