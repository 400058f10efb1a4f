"""Observability: a process-wide metrics registry and its Prometheus
text exposition (own copy of skypilot_tpu/observability's `metrics` and
`exposition`, without exemplars or the timeline bridge).

Recording is off until an exporter attaches (the server's `make_app`
calls `metrics.enable()`) or `SKYTPU_METRICS=1`; while off every
recording call returns after one boolean check. Importing this package
starts no thread, socket or exporter.
"""
from skypilot_tpu_torch.observability.exposition import (
    generate_latest, parse_prometheus_text)
from skypilot_tpu_torch.observability.metrics import (REGISTRY, Counter,
                                                      Gauge, Histogram,
                                                      Registry, counter,
                                                      disable, enable,
                                                      enabled, gauge,
                                                      histogram)

__all__ = ['REGISTRY', 'Counter', 'Gauge', 'Histogram', 'Registry',
           'counter', 'disable', 'enable', 'enabled', 'gauge', 'histogram',
           'generate_latest', 'parse_prometheus_text']
