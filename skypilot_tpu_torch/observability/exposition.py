"""Prometheus text-format exposition and a small strict parser.

Own copy of skypilot_tpu/observability/exposition.py without the
timeline bridge. ``generate_latest`` renders the registry in
Prometheus text format 0.0.4 (`# HELP` / `# TYPE` headers, escaped label
values, histogram `_bucket{le=...}` cumulative counts plus
`_sum`/`_count`). ``parse_prometheus_text`` is its inverse: it validates
every line and rejects duplicate (metric, label set) pairs.
``collect_exemplars`` lists the histograms' retained exemplars (the text
format stays exemplar-free).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

from skypilot_tpu_torch.observability import metrics as _metrics

CONTENT_TYPE_LATEST = 'text/plain; version=0.0.4; charset=utf-8'


def _escape_help(text: str) -> str:
    return text.replace('\\', r'\\').replace('\n', r'\n')


def _escape_label(value: str) -> str:
    return (value.replace('\\', r'\\').replace('"', r'\"')
            .replace('\n', r'\n'))


def _fmt_value(value: float) -> str:
    if value == math.inf:
        return '+Inf'
    if value == -math.inf:
        return '-Inf'
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _labels_str(names: Tuple[str, ...], values: Tuple[str, ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return '{' + ','.join(pairs) + '}' if pairs else ''


def generate_latest(registry: '_metrics.Registry' = None) -> str:
    """Render `registry` (default: the process-wide one) as Prometheus
    text format. Always ends with a trailing newline."""
    if registry is None:
        registry = _metrics.REGISTRY
    lines = []
    for metric in registry.collect():
        lines.append(f'# HELP {metric.name} {_escape_help(metric.help)}')
        lines.append(f'# TYPE {metric.name} {metric.kind}')
        for labelvalues, child in metric.samples():
            if metric.kind == 'histogram':
                counts, total, count = child.value
                cumulative = 0
                for bound, n in zip(metric.buckets, counts):
                    cumulative += n
                    lines.append(
                        f'{metric.name}_bucket'
                        f'{_labels_str(metric.labelnames, labelvalues, (("le", _fmt_value(bound)),))}'
                        f' {cumulative}')
                cumulative += counts[-1]
                lines.append(
                    f'{metric.name}_bucket'
                    f'{_labels_str(metric.labelnames, labelvalues, (("le", "+Inf"),))}'
                    f' {cumulative}')
                lines.append(
                    f'{metric.name}_sum'
                    f'{_labels_str(metric.labelnames, labelvalues)}'
                    f' {_fmt_value(total)}')
                lines.append(
                    f'{metric.name}_count'
                    f'{_labels_str(metric.labelnames, labelvalues)}'
                    f' {count}')
            else:
                lines.append(
                    f'{metric.name}'
                    f'{_labels_str(metric.labelnames, labelvalues)}'
                    f' {_fmt_value(child.value)}')
    return '\n'.join(lines) + '\n'


# ---------------- parser ----------------

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?'
    r'\s+(?P<value>[^\s]+)'
    r'(?:\s+(?P<ts>-?[0-9]+))?$')
_LABEL_RE = re.compile(
    r'(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"')


def _unescape_label(value: str) -> str:
    # Left-to-right scan (naive chained .replace() mangles sequences
    # like a literal backslash followed by 'n').
    out = []
    i = 0
    while i < len(value):
        if value[i] == '\\' and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt in ('\\', '"'):
                out.append(nxt)
                i += 2
                continue
            if nxt == 'n':
                out.append('\n')
                i += 2
                continue
        out.append(value[i])
        i += 1
    return ''.join(out)


def _parse_labels(body: str, line: str) -> Tuple[Tuple[str, str], ...]:
    out = []
    pos = 0
    while pos < len(body):
        m = _LABEL_RE.match(body, pos)
        if m is None:
            raise ValueError(f'bad label syntax in line {line!r}')
        out.append((m.group('name'), _unescape_label(m.group('value'))))
        pos = m.end()
        if pos < len(body) and body[pos] == ',':
            pos += 1
    names = [n for n, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f'duplicate label name in line {line!r}')
    return tuple(sorted(out))


def _parse_value(raw: str, line: str) -> float:
    if raw == '+Inf':
        return math.inf
    if raw == '-Inf':
        return -math.inf
    if raw == 'NaN':
        return math.nan
    try:
        return float(raw)
    except ValueError as e:
        raise ValueError(f'bad sample value in line {line!r}') from e


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Strict parse of Prometheus text format. Returns
    {family_name: {'kind', 'help', 'samples': {(sample_name,
    sorted_label_pairs): value}}}. Raises ValueError on any malformed
    line, a sample with no preceding TYPE header, or a duplicate
    (sample name, label set) pair."""
    families: Dict[str, dict] = {}
    # sample name -> owning family (histogram _bucket/_sum/_count map
    # back to their family).
    sample_owner: Dict[str, str] = {}
    for raw in text.split('\n'):
        line = raw.strip()
        if not line:
            continue
        if line.startswith('# HELP '):
            parts = line[len('# HELP '):].split(' ', 1)
            name = parts[0]
            fam = families.setdefault(
                name, {'kind': None, 'help': '', 'samples': {}})
            fam['help'] = parts[1] if len(parts) > 1 else ''
            continue
        if line.startswith('# TYPE '):
            parts = line[len('# TYPE '):].split(' ')
            if len(parts) != 2:
                raise ValueError(f'bad TYPE line {line!r}')
            name, kind = parts
            if kind not in ('counter', 'gauge', 'histogram', 'summary',
                            'untyped'):
                raise ValueError(f'unknown metric kind in {line!r}')
            fam = families.setdefault(
                name, {'kind': None, 'help': '', 'samples': {}})
            if fam['kind'] is not None:
                raise ValueError(f'duplicate TYPE for {name}')
            fam['kind'] = kind
            sample_owner[name] = name
            if kind == 'histogram':
                for suffix in ('_bucket', '_sum', '_count'):
                    sample_owner[name + suffix] = name
            continue
        if line.startswith('#'):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f'malformed sample line {line!r}')
        name = m.group('name')
        owner = sample_owner.get(name)
        if owner is None:
            raise ValueError(f'sample {name!r} has no TYPE header')
        labels = _parse_labels(m.group('labels') or '', line)
        value = _parse_value(m.group('value'), line)
        key = (name, labels)
        samples = families[owner]['samples']
        if key in samples:
            raise ValueError(
                f'duplicate sample for metric/label pair {key!r}')
        samples[key] = value
    return families


# ---------------- exemplars ----------------


def collect_exemplars(registry: '_metrics.Registry' = None
                      ) -> Dict[str, dict]:
    """Histogram exemplars as {family[|label=value...]: {'value',
    'trace_id', 'age_s'}}: the metrics-to-traces link the /traces
    endpoint surfaces. Prometheus text exposition is deliberately left
    exemplar-free: the strict parser pins the 0.0.4 grammar, which has
    no exemplar syntax."""
    import time as _time
    if registry is None:
        registry = _metrics.REGISTRY
    now = _time.monotonic()
    out: Dict[str, dict] = {}
    for metric in registry.collect():
        if metric.kind != 'histogram':
            continue
        for labelvalues, child in metric.samples():
            ex = child.exemplar
            if ex is None:
                continue
            value, trace_id, stamp = ex
            suffix = ''.join(f'|{n}={v}' for n, v in
                             zip(metric.labelnames, labelvalues))
            out[f'{metric.name}{suffix}'] = {
                'value': value,
                'trace_id': trace_id,
                'age_s': round(max(0.0, now - stamp), 3),
            }
    return out
