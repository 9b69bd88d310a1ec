"""Cold-start timeline report: decompose engine-load -> first-token wall
(counterpart of paddle_tpu/compile_cache/report.py).

The ledger timeline gives contiguous phase boundaries — an
``engine_load_start`` mark + ``engine_init`` span from the engine
constructor, an optional ``prewarm`` span, and a ``first_token`` mark from
the first logits the engine produces. Compile events (miss / restore /
persist, each with wall seconds) land inside those phases. The report
slices the window into components that sum to the measured wall BY
CONSTRUCTION (the PR 14 request-trace discipline applied to compilation):

    engine_init_s        constructor work (weight placement, pool alloc)
    pre_prewarm_s        gap between constructor exit and prewarm start
    prewarm_compile_s    fresh builds inside prewarm (outcome=miss)
    prewarm_restore_s    disk restores inside prewarm (outcome=restore)
    prewarm_persist_s    disk writes inside prewarm (outcome=persist)
    prewarm_host_s       prewarm wall not covered by compile events
    serve_compile_s      builds and persists after prewarm, before first token
    serve_restore_s      restores in the same tail window
    serve_host_s         residual host work up to the first token

`consistency` = sum(components) / wall. Because residuals are clamped at
zero, overlapping or mis-attributed events push it away from 1.0. Kernel
libraries build in parallel, so each library's `miss` carries the wall
it added to the build (ops/kernels/build.py), and the events of one
build sum to its wall.
"""
from __future__ import annotations

from typing import List, Optional

from . import ledger as _ledger

__all__ = ["cold_start_report", "format_report"]

_COMPILE_OUTCOMES = ("miss", "restore", "persist", "shared", "error")


def _last(marks: List[dict], key: str, before: Optional[float] = None):
    t = None
    for m in marks:
        if m["key"] == key and (before is None or m["t"] <= before):
            t = m["t"]
    return t


def _first_after(marks: List[dict], key: str, after: float):
    for m in marks:
        if m["key"] == key and m["t"] >= after:
            return m["t"]
    return None


def _span_in(spans: List[dict], key: str, t0: float, t1: float):
    """Last span of `key` overlapping [t0, t1]."""
    found = None
    for s in spans:
        if s["key"] == key and s["t1"] >= t0 and s["t0"] <= t1:
            found = s
    return found


def _bucket_seconds(events, t0, t1, outcome):
    return sum(
        e["seconds"] for e in events
        if e["outcome"] == outcome and t0 <= e["t_end"] <= t1
    )


def cold_start_report(data: Optional[dict] = None) -> dict:
    """Build the report from the live ledger, or from a `dump_json` doc
    (the CLI path). Returns `{"available": False, "reason": ...}` when the
    timeline marks are missing (telemetry off, or no engine loaded)."""
    if data is None:
        events = _ledger.events()
        marks = _ledger.marks()
        spans = _ledger.spans()
    else:
        events = list(data.get("events", ()))
        marks = list(data.get("marks", ()))
        spans = list(data.get("spans", ()))

    start = _last(marks, "engine_load_start")
    if start is None:
        return {"available": False,
                "reason": "no engine_load_start mark (telemetry off, or no "
                          "engine constructed since the last reset)"}
    first_token = _first_after(marks, "first_token", start)
    if first_token is None:
        return {"available": False,
                "reason": "no first_token mark after engine_load_start "
                          "(engine never produced logits)"}
    wall = first_token - start
    win_events = [
        e for e in events
        if e["outcome"] in _COMPILE_OUTCOMES and start <= e["t_end"] <= first_token
    ]

    init = _span_in(spans, "engine_init", start, first_token)
    init_end = min(init["t1"], first_token) if init else start
    engine_init_s = max(0.0, init_end - start) if init else 0.0

    pw = _span_in(spans, "prewarm", init_end, first_token)
    comp = {"engine_init_s": engine_init_s}
    if pw:
        p0 = max(init_end, pw["t0"])
        p1 = min(first_token, pw["t1"])
        comp["pre_prewarm_s"] = max(0.0, p0 - init_end)
        comp["prewarm_compile_s"] = _bucket_seconds(win_events, p0, p1, "miss")
        comp["prewarm_restore_s"] = _bucket_seconds(win_events, p0, p1, "restore")
        comp["prewarm_persist_s"] = _bucket_seconds(win_events, p0, p1, "persist")
        comp["prewarm_host_s"] = max(
            0.0, (p1 - p0) - comp["prewarm_compile_s"]
            - comp["prewarm_restore_s"] - comp["prewarm_persist_s"]
        )
        tail0 = p1
    else:
        tail0 = init_end
    comp["serve_compile_s"] = (
        _bucket_seconds(win_events, tail0, first_token, "miss")
        + _bucket_seconds(win_events, tail0, first_token, "persist")
    )
    comp["serve_restore_s"] = _bucket_seconds(win_events, tail0, first_token, "restore")
    comp["serve_host_s"] = max(
        0.0, (first_token - tail0) - comp["serve_compile_s"] - comp["serve_restore_s"]
    )
    comp = {k: round(v, 6) for k, v in comp.items()}
    total = sum(comp.values())
    outcomes: dict = {}
    for e in win_events:
        outcomes[e["outcome"]] = outcomes.get(e["outcome"], 0) + 1
    return {
        "available": True,
        "wall_s": round(wall, 6),
        "components": comp,
        "consistency": round(total / wall, 4) if wall > 0 else None,
        "outcomes": outcomes,
        "per_bucket": [
            {"origin": e["origin"], "name": e["name"],
             "outcome": e["outcome"], "seconds": round(e["seconds"], 6)}
            for e in win_events
        ],
        "prewarmed": bool(pw),
    }


def format_report(rep: dict) -> str:
    if not rep.get("available"):
        return f"cold-start report unavailable: {rep.get('reason')}"
    lines = [
        f"engine-load -> first-token wall: {rep['wall_s'] * 1e3:.1f} ms "
        f"(component sum / wall = {rep['consistency']})",
        "components:",
    ]
    for k, v in rep["components"].items():
        if v:
            lines.append(f"  {k:<22} {v * 1e3:>10.1f} ms")
    if rep["outcomes"]:
        lines.append("compile events in window: " + ", ".join(
            f"{k}={v}" for k, v in sorted(rep["outcomes"].items())))
    for b in rep["per_bucket"]:
        lines.append(
            f"  [{b['outcome']:>7}] {b['origin']}:{b['name']} "
            f"{b['seconds'] * 1e3:.1f} ms"
        )
    return "\n".join(lines)
