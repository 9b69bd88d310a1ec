"""Compile-event ledger: the observability half of the compile cache
(counterpart of paddle_tpu/compile_cache/ledger.py).

The port compiles two things: the hand-written kernel libraries (`nvcc`,
ops/kernels/build.py, origin ``kernel_build``) and a static Program's
replay plan (verify + the pass pipeline, static/executor.py, origin
``static_executor``). Each reports here with a structured event: origin,
name, stable fingerprint, signature, wall seconds and an outcome:

- ``miss``     the work ran (nvcc, or verify + passes)
- ``restore``  a kernel library was restored from the persistent store
- ``shared``   an identical in-process result was reused
- ``persist``  a freshly built library was written to the store
- ``error``    a store entry was rejected (corrupt, topology mismatch)
- ``hit``      the caller's own in-memory cache served the signature

No event names work that did not happen: `to_static` runs eagerly and
records none, and the serving engine records only its cold-start marks.
Hits are counter-only (they happen per run), so the bounded event store
keeps the rare compile-path events.

Telemetry (labeled ``{origin, outcome}``): ``paddle_tpu_compile_events_total``,
``paddle_tpu_compile_seconds_total``, ``paddle_tpu_compile_cache_hits_total``
(hit|shared|restore), ``paddle_tpu_compile_cache_misses_total``
(miss|error). With request tracing on, non-hit events also land as spans
in the ``compile`` lane of the chrome export.

The **timeline** (marks + phase spans) lets the cold-start report
decompose the engine-load -> first-token wall: `InferenceEngine.__init__`
records an ``engine_load_start`` mark and an ``engine_init`` span,
`prewarm()` a ``prewarm`` span, and the first logits out of the engine a
``first_token`` mark.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import List, Optional

from .. import telemetry as _tm
from ..telemetry import timeline as _tl

__all__ = [
    "record",
    "events",
    "summary",
    "reset",
    "reset_timeline",
    "mark",
    "span",
    "marks",
    "spans",
    "last_serial",
    "dump_json",
    "load_dump",
    "OUTCOMES",
]

OUTCOMES = ("hit", "miss", "restore", "shared", "persist", "error")
_HIT_LIKE = ("hit", "shared", "restore")
_MISS_LIKE = ("miss", "error")

_MAX_EVENTS = 512

_lock = threading.Lock()
_events: deque = deque(maxlen=_MAX_EVENTS)
_serial = [0]
_marks: List[dict] = []
_spans: List[dict] = []


def _counters(origin: str, outcome: str, seconds: float) -> None:
    lbl = {"origin": str(origin), "outcome": str(outcome)}
    _tm.counter(
        "paddle_tpu_compile_events_total",
        "compile-lifecycle events by entry point and outcome",
        ("origin", "outcome"),
    ).labels(**lbl).inc()
    if seconds > 0:
        _tm.counter(
            "paddle_tpu_compile_seconds_total",
            "wall seconds spent in compile-lifecycle work (compile, "
            "restore, persist) by entry point and outcome",
            ("origin", "outcome"),
        ).labels(**lbl).inc(float(seconds))
    if outcome in _HIT_LIKE:
        _tm.counter(
            "paddle_tpu_compile_cache_hits_total",
            "compile-cache hits (in-memory hit, in-process shared, "
            "disk restore)", ("origin", "outcome"),
        ).labels(**lbl).inc()
    elif outcome in _MISS_LIKE:
        _tm.counter(
            "paddle_tpu_compile_cache_misses_total",
            "compile-cache misses (fresh compile) and rejected entries",
            ("origin", "outcome"),
        ).labels(**lbl).inc()


def record(
    origin: str,
    name: str,
    outcome: str,
    seconds: float = 0.0,
    fingerprint: Optional[str] = None,
    signature: Optional[str] = None,
    extra: Optional[dict] = None,
) -> Optional[dict]:
    """Report one compile-lifecycle event. Gated on `telemetry.enabled()`
    (record NOTHING when off — the near-zero-cost contract every
    instrumented hot path in this repo follows). Never raises: a telemetry
    schema clash must not break a compile path. Returns the event dict
    (None when disabled or for counter-only hits)."""
    if outcome not in OUTCOMES:
        outcome = "error"
    seconds = float(seconds or 0.0)
    if outcome != "hit":
        # the incident timeline sees compile-lifecycle transitions even
        # with the metrics registry off (independent gates); per-dispatch
        # hits stay counter-only — they would flood any event stream
        _tl.emit("compile", f"compile.{outcome}",
                 severity="warn" if outcome == "error" else "info",
                 origin=str(origin), name=str(name),
                 seconds=round(seconds, 6))
    if not _tm.enabled():
        return None
    try:
        _counters(origin, outcome, seconds)
    except Exception:
        pass
    if outcome == "hit":
        return None  # counter-only: per-dispatch, would flood the store
    t1 = time.monotonic()
    with _lock:
        _serial[0] += 1
        serial = _serial[0]
    ev = {
        "serial": serial,
        "origin": str(origin),
        "name": str(name),
        "outcome": outcome,
        "seconds": seconds,
        "fingerprint": fingerprint,
        "signature": signature,
        "t_end": t1,
        "recorded_at": time.time(),
    }
    if extra:
        ev.update(extra)
    with _lock:
        _events.append(ev)
    try:
        from ..telemetry import request_trace as _rt

        if _rt.enabled() and seconds > 0:
            _rt.record_span(
                "compile", f"{origin}:{name}", t1 - seconds, t1,
                origin=str(origin), outcome=outcome,
                fingerprint=fingerprint,
            )
        elif _rt.enabled():
            _rt.record_event(
                "compile", f"{origin}:{name}", t=t1,
                origin=str(origin), outcome=outcome,
            )
    except Exception:
        pass
    return ev


def events(origin: Optional[str] = None, outcome: Optional[str] = None,
           since_serial: int = 0) -> List[dict]:
    """Ledger events oldest-first (copies), optionally filtered."""
    with _lock:
        evs = list(_events)
    out = []
    for e in evs:
        if e["serial"] <= since_serial:
            continue
        if origin is not None and e["origin"] != origin:
            continue
        if outcome is not None and e["outcome"] != outcome:
            continue
        out.append(dict(e))
    return out


def last_serial() -> int:
    with _lock:
        return _serial[0]


# ---------------------------------------------------------------------------
# cold-start timeline: marks + contiguous phase spans
# ---------------------------------------------------------------------------

def mark(key: str, t: Optional[float] = None) -> None:
    """Timeline point (monotonic clock). Gated like record()."""
    if not _tm.enabled():
        return
    with _lock:
        _marks.append({"key": str(key), "t": time.monotonic() if t is None else float(t)})


def span(key: str, t0: float, t1: float, **attrs) -> None:
    """Timeline phase span (monotonic clock). Gated like record()."""
    if not _tm.enabled():
        return
    ev = {"key": str(key), "t0": float(t0), "t1": float(t1)}
    if attrs:
        ev.update(attrs)
    with _lock:
        _spans.append(ev)


def marks() -> List[dict]:
    with _lock:
        return [dict(m) for m in _marks]


def spans() -> List[dict]:
    with _lock:
        return [dict(s) for s in _spans]


def summary() -> dict:
    """Aggregate view for `perf_report()`'s `compilation` section: totals,
    hit rate, and a per-origin breakdown. Counter families are the source
    of truth for hit/miss totals (hits never enter the event store)."""
    with _lock:
        evs = list(_events)
    by_origin: dict = {}
    total_seconds = 0.0
    for e in evs:
        o = by_origin.setdefault(
            e["origin"], {"events": 0, "compile_seconds": 0.0, "outcomes": {}}
        )
        o["events"] += 1
        o["compile_seconds"] += e["seconds"]
        o["outcomes"][e["outcome"]] = o["outcomes"].get(e["outcome"], 0) + 1
        total_seconds += e["seconds"]
    hits = misses = 0
    for fam_name, bucket in (
        ("paddle_tpu_compile_cache_hits_total", "hits"),
        ("paddle_tpu_compile_cache_misses_total", "misses"),
    ):
        fam = _tm.default_registry().get(fam_name)
        if fam is None:
            continue
        n = sum(c.value for c in fam.children())
        if bucket == "hits":
            hits = int(n)
        else:
            misses = int(n)
    looked_up = hits + misses
    return {
        "available": bool(evs) or looked_up > 0,
        "events": len(evs),
        "total_compile_seconds": round(total_seconds, 6),
        "hits": hits,
        "misses": misses,
        "hit_rate": round(hits / looked_up, 4) if looked_up else None,
        "by_origin": by_origin,
    }


def dump_json(path: str) -> str:
    """Write events + timeline as one JSON doc (the report CLI's input)."""
    doc = {
        "version": 1,
        "dumped_at": time.time(),
        "events": events(),
        "marks": marks(),
        "spans": spans(),
        "summary": summary(),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path


def load_dump(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reset_timeline() -> None:
    """Clear marks/spans only — bench's warm-vs-cold sub-run re-measures
    the engine-load window without losing the event history."""
    with _lock:
        _marks.clear()
        _spans.clear()


def reset() -> None:
    """Clear events + timeline (tests, dryrun scenario boundaries)."""
    with _lock:
        _events.clear()
        _marks.clear()
        _spans.clear()
