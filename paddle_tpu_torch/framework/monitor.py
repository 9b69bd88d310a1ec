"""Named stats counters: a compatibility shim over `telemetry`
(counterpart of paddle_tpu/framework/monitor.py).

Reference parity: paddle/fluid/platform/monitor.cc (STAT_INT registry used
for framework-internal counters). The counters forward into the unified
telemetry registry (`telemetry.metrics`), so monitor stats appear in the
same Prometheus/JSON exports as every other runtime metric. Prefer
`paddle_tpu_torch.telemetry.counter(...)` / `.gauge(...)` in new code.

Legacy semantics preserved: `add()` accepts decrements, a counter and a
gauge may share a name (the gauge exports under `<name>__gauge` in that
case), and `get()` on a name that was never recorded returns 0 (counter
semantics), not None.
"""
from __future__ import annotations

import threading
import warnings

from ..telemetry import metrics as _metrics

_lock = threading.Lock()
# logical monitor name -> registry family name (may be suffixed on a
# counter/gauge name collision, which the old dual-dict API allowed)
_counter_fams: dict = {}
_gauge_fams: dict = {}
_warned = [False]


def _deprecation_note():
    if not _warned[0]:
        _warned[0] = True
        warnings.warn(
            "paddle_tpu_torch.framework.monitor is a compatibility shim; use "
            "paddle_tpu_torch.telemetry.counter()/gauge() for labeled metrics and "
            "unified export",
            DeprecationWarning,
            stacklevel=3,
        )


def _family(name: str, factory, fams: dict, suffix: str):
    with _lock:
        fam_name = fams.get(name)
    if fam_name is not None:
        return _metrics.default_registry().get(fam_name) or factory(fam_name)
    fam_name = name
    try:
        fam = factory(fam_name)
    except (TypeError, ValueError):
        # name taken by another kind/schema in the shared registry
        fam_name = name + suffix
        fam = factory(fam_name)
    with _lock:
        fams[name] = fam_name
    return fam


def add(name: str, value=1):
    _deprecation_note()
    fam = _family(name, _metrics.counter, _counter_fams, "__counter")
    # legacy STAT_INT semantics allowed decrements (add(name, -1)); route
    # through the shim-only signed path so old callers keep working
    fam._default()._add_signed(value)


def set_gauge(name: str, value):
    _deprecation_note()
    _family(name, _metrics.gauge, _gauge_fams, "__gauge").set(value)


def _read(fam_name):
    fam = _metrics.default_registry().get(fam_name)
    if fam is None or fam.kind == "histogram" or fam.label_names:
        return None
    return fam.value


def get(name: str):
    with _lock:
        c, g = _counter_fams.get(name), _gauge_fams.get(name)
    # old flat-dict priority: counters first, then gauges
    for fam_name in (c, g):
        if fam_name is not None:
            v = _read(fam_name)
            if v is not None:
                return v
    # non-shim name: read 0 for anything not representable as a flat scalar
    v = _read(name)
    return 0 if v is None else v


def snapshot():
    with _lock:
        owned = [("counters", dict(_counter_fams)), ("gauges", dict(_gauge_fams))]
    out = {"counters": {}, "gauges": {}}
    for section, fams in owned:
        for n, f in fams.items():
            v = _read(f)
            if v is not None:
                out[section][n] = v
    return out


def reset(name: str = None):
    reg = _metrics.default_registry()
    with _lock:
        # only monitor-owned families — never delete live telemetry metrics
        # that happen to share the default registry
        names = [name] if name is not None else sorted(set(_counter_fams) | set(_gauge_fams))
        for n in names:
            for fams in (_counter_fams, _gauge_fams):
                fam_name = fams.pop(n, None)
                if fam_name is not None:
                    reg.unregister(fam_name)
