"""Unified runtime telemetry (counterpart of paddle_tpu/telemetry).

One labeled metrics registry (Counter/Gauge/Histogram families, the
Prometheus data model) that the serving path publishes into: the KV pool,
the engine, the scheduler, the QoS ladder and the replica fleet. Gated by
the `PADDLE_TPU_TELEMETRY` flag (default on; one cached bool read per
event when off). Exporters render Prometheus text and JSON-lines
snapshots; metric names stay `paddle_tpu_*`, so a snapshot of the port
compares byte for byte with the JAX package's. `request_trace` keeps
sampled request-scoped phase spans (`FLAGS_request_trace`), `timeline` the
incident ring (`FLAGS_incident_timeline`). The compile ledger
(compile_cache/ledger.py) and the guardian publish here too; the io and
collective hooks arrive with their modules.
"""
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    default_registry,
    disable,
    enable,
    enabled,
    gauge,
    histogram,
)
from .exporters import (  # noqa: F401
    dump_snapshot,
    parse_prometheus,
    start_metrics_server,
    to_json_lines,
    to_prometheus,
    validate_snapshot,
)
from . import request_trace  # noqa: F401
from . import timeline  # noqa: F401

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "counter",
    "gauge",
    "histogram",
    "default_registry",
    "enabled",
    "enable",
    "disable",
    "to_prometheus",
    "to_json_lines",
    "parse_prometheus",
    "dump_snapshot",
    "start_metrics_server",
    "validate_snapshot",
    "request_trace",
    "timeline",
]
