"""Typed, labeled runtime metrics registry (counterpart of
paddle_tpu/telemetry/metrics.py).

paddle/fluid/platform/monitor.cc's stat registry generalized to the shape
the fleet stack needs: `Counter` / `Gauge` / `Histogram` families keyed by a
label dict (Prometheus data model), thread-safe, and near-zero-cost when
collection is disabled — every instrumented hot path checks `enabled()`
(one cached bool read) before touching the registry.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..framework import flags as _flags

_flags.define_flag(
    "PADDLE_TPU_TELEMETRY",
    True,
    "collect runtime telemetry (compile-cache, collective, optimizer, jit "
    "trace metrics); disable for a zero-instrumentation hot path",
)

# cached gate: instrumented hot paths call enabled() per event, so this must
# be a plain attribute read, not a lock-guarded flag lookup; the flag watcher
# keeps it in sync with paddle.set_flags({"PADDLE_TPU_TELEMETRY": ...})
_enabled = bool(_flags.get_flag("PADDLE_TPU_TELEMETRY"))


def _sync_enabled(_value) -> None:
    # re-read the registry rather than trusting the callback's value:
    # watchers fire outside the flags lock, so two racing set_flags calls
    # could deliver values out of order — the registry holds the final word
    global _enabled
    _enabled = bool(_flags.get_flag("PADDLE_TPU_TELEMETRY"))


_flags.watch_flag("PADDLE_TPU_TELEMETRY", _sync_enabled)


def enabled() -> bool:
    return _enabled


def enable() -> None:
    _flags.set_flags({"PADDLE_TPU_TELEMETRY": True})


def disable() -> None:
    _flags.set_flags({"PADDLE_TPU_TELEMETRY": False})


# default histogram buckets: latency-flavored seconds, compile times included
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _label_items(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Child:
    """One (family, label-values) time series."""

    __slots__ = ("labels", "_lock")

    def __init__(self, labels: Tuple[Tuple[str, str], ...]):
        self.labels = labels
        self._lock = threading.Lock()


class CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, labels):
        super().__init__(labels)
        self._value = 0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters can only increase; use a Gauge")
        with self._lock:
            self._value += amount

    def _add_signed(self, amount):
        """Legacy escape hatch for the framework/monitor shim only: the old
        STAT_INT registry allowed decrements; new code should use a Gauge."""
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, labels):
        super().__init__(labels)
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = value

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        with self._lock:
            return self._value


class HistogramChild(_Child):
    __slots__ = ("buckets", "bucket_counts", "_sum", "_count")

    def __init__(self, labels, buckets):
        super().__init__(labels)
        self.buckets = buckets
        self.bucket_counts = [0] * (len(buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.bucket_counts[i] += 1
                    return
            self.bucket_counts[-1] += 1

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def count(self):
        with self._lock:
            return self._count

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count)] with the +Inf bound last."""
        with self._lock:
            counts = list(self.bucket_counts)
        out, acc = [], 0
        for b, c in zip(self.buckets, counts[:-1]):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out


class _Family:
    """A named metric with a fixed label-name set and per-labelset children."""

    kind = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, doc: str = "", label_names: Sequence[str] = ()):
        self.name = name
        self.doc = doc
        self.label_names = tuple(label_names)
        self._children: Dict[Tuple[Tuple[str, str], ...], _Child] = {}
        self._lock = threading.Lock()

    def _make_child(self, key):
        return self._child_cls(key)

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} expects labels {sorted(self.label_names)}, "
                f"got {sorted(labels)}"
            )
        key = _label_items(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child(key)
            return child

    def children(self):
        with self._lock:
            return list(self._children.values())

    # unlabeled convenience: family acts as its own single child
    def _default(self):
        if self.label_names:
            raise ValueError(f"metric {self.name!r} is labeled; call .labels(...)")
        return self.labels()


class Counter(_Family):
    kind = "counter"
    _child_cls = CounterChild

    def inc(self, amount=1):
        self._default().inc(amount)

    @property
    def value(self):
        return self._default().value


class Gauge(_Family):
    kind = "gauge"
    _child_cls = GaugeChild

    def set(self, value):
        self._default().set(value)

    def inc(self, amount=1):
        self._default().inc(amount)

    def dec(self, amount=1):
        self._default().dec(amount)

    @property
    def value(self):
        return self._default().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, doc="", label_names=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, doc, label_names)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self, key):
        return HistogramChild(key, self.buckets)

    def observe(self, value):
        self._default().observe(value)

    @property
    def sum(self):
        return self._default().sum

    @property
    def count(self):
        return self._default().count


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Thread-safe name -> family registry; get-or-create semantics so
    instrumentation sites can declare their metrics at call time."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, doc, label_names, **kwargs):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {fam.kind}, "
                        f"requested {cls.kind}"
                    )
                # schema must match, or the second declarer silently feeds a
                # family with different labels/buckets and gets wrong data
                if fam.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.label_names}, requested {tuple(label_names)}"
                    )
                want_buckets = kwargs.get("buckets")
                if want_buckets is not None and fam.buckets != tuple(sorted(want_buckets)):
                    raise ValueError(
                        f"histogram {name!r} already registered with buckets "
                        f"{fam.buckets}, requested {tuple(sorted(want_buckets))}"
                    )
                return fam
            fam = cls(name, doc, label_names, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name, doc="", label_names=()) -> Counter:
        return self._get_or_create(Counter, name, doc, label_names)

    def gauge(self, name, doc="", label_names=()) -> Gauge:
        return self._get_or_create(Gauge, name, doc, label_names)

    def histogram(self, name, doc="", label_names=(), buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, doc, label_names, buckets=buckets)

    def get(self, name) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> Iterable[_Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def unregister(self, name) -> None:
        with self._lock:
            self._families.pop(name, None)

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    def collect(self) -> list:
        """Flat sample list: one dict per (family, labelset) — the neutral
        form both exporters and tests consume."""
        samples = []
        for fam in self.families():
            for child in fam.children():
                s = {
                    "name": fam.name,
                    "type": fam.kind,
                    "labels": dict(child.labels),
                }
                if fam.kind == "histogram":
                    s["sum"] = child.sum
                    s["count"] = child.count
                    # the +Inf bound serializes as the string "+Inf"
                    # (Prometheus convention): bare float('inf') would render
                    # as non-RFC-8259 `Infinity` in the JSON-lines export
                    s["buckets"] = [
                        {"le": "+Inf" if le == float("inf") else le, "count": c}
                        for le, c in child.cumulative_buckets()
                    ]
                else:
                    s["value"] = child.value
                samples.append(s)
        return samples


_default_registry = Registry()


def default_registry() -> Registry:
    return _default_registry


def counter(name, doc="", label_names=()) -> Counter:
    return _default_registry.counter(name, doc, label_names)


def gauge(name, doc="", label_names=()) -> Gauge:
    return _default_registry.gauge(name, doc, label_names)


def histogram(name, doc="", label_names=(), buckets=DEFAULT_BUCKETS) -> Histogram:
    return _default_registry.histogram(name, doc, label_names, buckets=buckets)
