"""Observability: a process-wide metrics registry, its Prometheus text
exposition, and request tracing (own copy of skypilot_tpu/observability's
`metrics`, `exposition` and `tracing`, without the timeline bridge).

Recording is off until an exporter attaches (the server's `make_app`
calls `metrics.enable()`) or `SKYTPU_METRICS=1`; while off every
recording call returns after one boolean check. Tracing has its own
boolean (`tracing.enable()` or `SKYTPU_TRACING=1`) with the same cost
contract. Importing this package starts no thread, socket or exporter.
"""
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.observability.exposition import (
    collect_exemplars, generate_latest, parse_prometheus_text)
from skypilot_tpu_torch.observability.metrics import (REGISTRY, Counter,
                                                      Gauge, Histogram,
                                                      Registry, counter,
                                                      disable, enable,
                                                      enabled, gauge,
                                                      histogram)

__all__ = ['REGISTRY', 'Counter', 'Gauge', 'Histogram', 'Registry',
           'counter', 'disable', 'enable', 'enabled', 'gauge', 'histogram',
           'collect_exemplars', 'generate_latest', 'parse_prometheus_text',
           'tracing']
