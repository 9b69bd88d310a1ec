"""Unified incident timeline: one time-ordered event bus for the fleet
(counterpart of paddle_tpu/telemetry/timeline.py).

The registry says *that* a counter moved, the request traces say *why one
request* was slow — but the events that explain a production incident (FaultPlan
injections, replica/tier health transitions, KV migrations and CRC rejects,
QoS brownout rungs, evacuations, hot-swaps, elastic restarts, watchdog
escalations, guardian anomalies) were scattered across per-subsystem rings
with no shared time order. This module is the shared order: a bounded,
thread-safe, process-wide ring of severity-ranked incident events that
every producer publishes into.

Record shape (plain JSON-clean dicts):

    {"t_wall", "t_perf", "rank", "source", "kind", "severity",
     "labels", "payload"}

Every record carries BOTH clocks — `t_wall` (time.time) for the operator
and `t_perf` (time.perf_counter) for trace alignment — so the chrome-trace
export derives its own `(perf_ns, unix_ns)` clock-sync pair from any single
record and merges onto the per-rank/per-request lanes.

Gating follows `FLAGS_request_trace` exactly: off (the default) costs one
cached module-level bool read per `emit()` call. Evictions are counted (`dropped` = appended −
retained), never silent.

On top ride three consumers:

- exports: JSON-lines (header carries dropped + clock_sync), a chrome-trace
  instant-event lane (pid 90010), and a crash-artifact `tail()` that is
  lenient about the very NaN it reports (non-finite floats stringify
  instead of poisoning the dump);
- `python -m paddle_tpu_torch.telemetry.timeline report` — incident auto-triage:
  given an SLO-violation window (or a crash dump's embedded tail) it
  correlates in-window events into a ranked blame table (severity-weighted,
  earliest-first, so on a seeded chaos replay the injected cause ranks
  first);
- **chaos observability coverage**: every FaultPlan injection
  (`source="resilience", kind="fault.injected"`) must be causally matched
  — same `site` label, within `deadline_s` — by ≥1 later observed event.
  `chaos_coverage()["unobserved_faults"]` is what chaos runs hold at
  exactly zero: a silent fault is an observability regression.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..framework import flags as _flags

__all__ = [
    "SEVERITIES",
    "TimelineRecorder",
    "enabled",
    "emit",
    "recorder",
    "set_recorder",
    "reset",
    "tail",
    "dropped",
    "to_json_lines",
    "dump_json_lines",
    "load_json_lines",
    "to_chrome_trace",
    "dump_chrome_trace",
    "chaos_coverage",
    "triage",
]

_flags.define_flag(
    "FLAGS_incident_timeline",
    False,
    "unified incident timeline: fault injections, replica/tier/mode "
    "transitions, KV migrations + CRC rejects, QoS brownout/shed, request "
    "terminal outcomes, compile-cache misses, checkpoint save/load, elastic "
    "restarts, watchdog escalations and guardian anomalies land in one "
    "bounded time-ordered ring; off = one cached bool read per emit site",
)
_flags.define_flag(
    "FLAGS_incident_timeline_ring",
    8192,
    "incident-timeline events retained (oldest evicted; evictions are "
    "counted and perf-gated to zero on bench chaos captures — a silent "
    "truncation would hide the very event a post-mortem needs)",
)

# cached gate, kept in sync by the flag watcher (same discipline as
# request_trace/metrics: hot paths read one plain bool, never the flag lock)
_enabled = bool(_flags.get_flag("FLAGS_incident_timeline"))


def _sync_enabled(_value) -> None:
    global _enabled
    _enabled = bool(_flags.get_flag("FLAGS_incident_timeline"))


_flags.watch_flag("FLAGS_incident_timeline", _sync_enabled)


def enabled() -> bool:
    return _enabled


# severity ladder: triage ranks by weight first, so a fatal escalation
# always outranks a warn rung-change regardless of order
SEVERITIES = ("info", "warn", "error", "fatal")
_SEV_WEIGHT = {s: i for i, s in enumerate(SEVERITIES)}

# the chrome-trace lane pid: above the request_trace global lanes
# (90001-90005), below the per-request block (100000+)
TIMELINE_LANE_PID = 90010

# this process's rank in the timeline records; launch/init paths may
# override via set_rank() (the env read matches launch/controller's worker
# env contract)
_rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)


def set_rank(rank: int) -> None:
    global _rank
    _rank = int(rank)


class TimelineRecorder:
    """Bounded thread-safe ring of incident events with counted evictions."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(_flags.get_flag("FLAGS_incident_timeline_ring"))
        self._ring: deque = deque(maxlen=max(int(capacity), 16))
        self._lock = threading.Lock()
        self._appended = 0

    def emit(self, source: str, kind: str, severity: str = "info",
             labels: Optional[dict] = None,
             payload: Optional[dict] = None) -> None:
        if severity not in _SEV_WEIGHT:
            severity = "info"
        rec = {
            "t_wall": time.time(),
            "t_perf": time.perf_counter(),
            "rank": _rank,
            "source": str(source),
            "kind": str(kind),
            "severity": severity,
            "labels": dict(labels or {}),
            "payload": dict(payload or {}),
        }
        with self._lock:
            self._appended += 1
            self._ring.append(rec)

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def tail(self, n: int = 256, json_safe: bool = True) -> List[dict]:
        """The newest `n` events, for crash artifacts. `json_safe` replaces
        non-finite floats with their repr strings — the dump must survive
        the NaN it exists to report."""
        with self._lock:
            out = list(self._ring)[-max(0, int(n)):]
        return [_json_safe(r) for r in out] if json_safe else out

    @property
    def dropped(self) -> int:
        """Events evicted from the ring (appended - retained)."""
        with self._lock:
            return self._appended - len(self._ring)

    def clock_sync(self) -> Optional[dict]:
        """(perf_ns, unix_ns) alignment pair, derived from the OLDEST
        retained record — every record carries both clocks, so the pair
        needs no separate capture and survives ring eviction."""
        with self._lock:
            if not self._ring:
                return None
            r = self._ring[0]
        return {"perf_ns": int(r["t_perf"] * 1e9),
                "unix_ns": int(r["t_wall"] * 1e9)}

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._appended = 0


def _json_safe(rec: dict):
    """Deep-copy `rec` with non-finite floats stringified (json.dumps with
    allow_nan=False would otherwise throw away the whole record)."""
    def fix(v):
        if isinstance(v, float) and not math.isfinite(v):
            return repr(v)
        if isinstance(v, dict):
            return {k: fix(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [fix(x) for x in v]
        return v

    return {k: fix(v) for k, v in rec.items()}


# ---------------------------------------------------------------------------
# module-level default recorder + the one emit entry point
# ---------------------------------------------------------------------------

_default_recorder = TimelineRecorder()


def recorder() -> TimelineRecorder:
    return _default_recorder


def set_recorder(rec: TimelineRecorder) -> TimelineRecorder:
    global _default_recorder
    _default_recorder = rec
    return rec


def reset() -> None:
    _default_recorder.reset()


def emit(source: str, kind: str, severity: str = "info",
         labels: Optional[dict] = None, **payload) -> None:
    """Publish one incident event; no-op (one bool read) when the timeline
    flag is off. `labels` are the correlation keys (`site` in particular —
    the chaos-coverage gate matches injections to observations on it);
    `payload` is free-form context."""
    if not _enabled:
        return
    _default_recorder.emit(source, kind, severity=severity, labels=labels,
                           payload=payload)


def tail(n: int = 256, json_safe: bool = True) -> List[dict]:
    """Crash-artifact view of the default recorder (newest `n`, NaN-safe)."""
    return _default_recorder.tail(n, json_safe=json_safe)


def dropped() -> int:
    """Evictions from the default recorder's ring."""
    return _default_recorder.dropped


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

def to_json_lines(rec: Optional[TimelineRecorder] = None) -> str:
    """One JSON object per line, preceded by a header carrying the
    eviction count + clock-sync pair (the request_trace log shape)."""
    rec = rec or _default_recorder
    header = {
        "type": "header", "version": 1, "stream": "incident_timeline",
        "dropped": rec.dropped, "clock_sync": rec.clock_sync(),
    }
    lines = [json.dumps(header, sort_keys=True)]
    lines.extend(
        json.dumps(_json_safe(r), sort_keys=True) for r in rec.records()
    )
    return "\n".join(lines)


def dump_json_lines(path: str, rec: Optional[TimelineRecorder] = None) -> str:
    with open(path, "w") as f:
        f.write(to_json_lines(rec))
        f.write("\n")
    return path


def load_json_lines(path: str, with_header: bool = False):
    """Read an event log back: records, or `(header, records)` with
    `with_header` (header `{}` if absent)."""
    header: dict = {}
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("type") == "header":
                if not header:
                    header = rec
            elif "t_perf" in rec and "kind" in rec:
                out.append(rec)
    return (header, out) if with_header else out


def to_chrome_trace(rec: Optional[TimelineRecorder] = None) -> dict:
    """One instant-event chrome lane (pid 90010 'incident timeline'),
    timestamped on t_perf with the derived clock_sync pair in metadata —
    `trace_merge --timeline` aligns it onto the per-rank/per-request wall
    clock through the same `(unix_ns - perf_ns)` offset as every other
    lane."""
    rec = rec or _default_recorder
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": TIMELINE_LANE_PID,
         "tid": 0, "args": {"name": "incident timeline"}},
        {"ph": "M", "name": "process_sort_index", "pid": TIMELINE_LANE_PID,
         "tid": 0, "args": {"sort_index": TIMELINE_LANE_PID}},
    ]
    for r in rec.records():
        args = {"severity": r["severity"], "rank": r["rank"]}
        args.update(r["labels"])
        args.update(_json_safe(r)["payload"])
        events.append({
            "ph": "i", "name": f"{r['source']}.{r['kind']}",
            "cat": f"incident_{r['source']}", "pid": TIMELINE_LANE_PID,
            "tid": 0, "ts": r["t_perf"] * 1e6,
            # severity scopes the viewer mark: process-wide for fatal,
            # thread-local otherwise
            "s": "g" if r["severity"] == "fatal" else "p",
            "args": args,
        })
    meta: dict = {"timeline_lane": True}
    cs = rec.clock_sync()
    if cs:
        meta["clock_sync"] = cs
    return {"traceEvents": events, "metadata": meta}


def dump_chrome_trace(path: str, rec: Optional[TimelineRecorder] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(rec), f)
    return path


# ---------------------------------------------------------------------------
# chaos observability coverage: injected faults must surface in telemetry
# ---------------------------------------------------------------------------

INJECTION_SOURCE = "resilience"
INJECTION_KIND = "fault.injected"


def chaos_coverage(records: Optional[Sequence[dict]] = None, *,
                   deadline_s: float = 5.0) -> dict:
    """Match every FaultPlan injection to ≥1 observed event.

    An injection is `source="resilience", kind="fault.injected"` with a
    `site` label (emitted by `fault_injection._record` at claim time). It
    counts as OBSERVED when any later non-injection event within
    `deadline_s` (on t_perf, the monotonic clock) carries the same `site`
    label — the instrumented failure-handling path telling the operator
    what the fault did. `unobserved_faults` is the count chaos runs hold
    at exactly zero.
    """
    if records is None:
        records = _default_recorder.records()
    records = sorted(records, key=lambda r: r["t_perf"])
    injections = [r for r in records
                  if r["source"] == INJECTION_SOURCE
                  and r["kind"] == INJECTION_KIND]
    observations = [r for r in records
                    if not (r["source"] == INJECTION_SOURCE
                            and r["kind"] == INJECTION_KIND)
                    and r.get("labels", {}).get("site")]
    matched: Dict[str, int] = {}
    orphans: List[dict] = []
    observed = 0
    for inj in injections:
        site = inj.get("labels", {}).get("site")
        t0 = inj["t_perf"]
        hits = [o for o in observations
                if o["labels"].get("site") == site
                and t0 <= o["t_perf"] <= t0 + deadline_s]
        if hits:
            observed += 1
            matched[site] = matched.get(site, 0) + len(hits)
        else:
            orphans.append({
                "site": site,
                "action": inj.get("labels", {}).get("action"),
                "t_wall": inj["t_wall"],
                "t_perf": inj["t_perf"],
            })
    return {
        "injected": len(injections),
        "observed": observed,
        "unobserved_faults": len(injections) - observed,
        "orphans": orphans,
        "matched": matched,
        "deadline_s": float(deadline_s),
    }


# ---------------------------------------------------------------------------
# incident auto-triage: the ranked blame table
# ---------------------------------------------------------------------------

def triage(records: Optional[Sequence[dict]] = None, *,
           window: Optional[Tuple[float, float]] = None,
           clock: str = "wall", top: int = 20) -> dict:
    """Correlate in-window events into a ranked blame table.

    Events group by `(source, kind, site)`; groups rank by max severity
    first, then earliest first occurrence — in an incident the highest-
    severity event that happened FIRST is the best causal candidate, which
    is exactly why a seeded chaos replay ranks its `fault.injected` event
    (severity=error, preceding every consequence it triggers) at the top.
    `window` bounds `t_wall` (clock="wall", the SLO-violation window an
    operator pastes) or `t_perf` (clock="perf").
    """
    if records is None:
        records = _default_recorder.records()
    tkey = "t_wall" if clock == "wall" else "t_perf"
    if window is not None:
        t0, t1 = float(window[0]), float(window[1])
        records = [r for r in records if t0 <= r[tkey] <= t1]
    groups: Dict[tuple, dict] = {}
    for r in sorted(records, key=lambda r: r["t_perf"]):
        site = r.get("labels", {}).get("site")
        key = (r["source"], r["kind"], site)
        g = groups.get(key)
        if g is None:
            g = groups[key] = {
                "source": r["source"], "kind": r["kind"], "site": site,
                "severity": r["severity"], "count": 0,
                "first_t_wall": r["t_wall"], "last_t_wall": r["t_wall"],
                "first_t_perf": r["t_perf"],
                "example": _json_safe(r)["payload"],
            }
        g["count"] += 1
        g["last_t_wall"] = max(g["last_t_wall"], r["t_wall"])
        if _SEV_WEIGHT[r["severity"]] > _SEV_WEIGHT[g["severity"]]:
            g["severity"] = r["severity"]
    ranked = sorted(
        groups.values(),
        key=lambda g: (-_SEV_WEIGHT[g["severity"]], g["first_t_perf"],
                       -g["count"]),
    )
    for i, g in enumerate(ranked):
        g["rank"] = i + 1
    cov = chaos_coverage(records)
    return {
        "n_events": len(records),
        "window": list(window) if window is not None else None,
        "clock": clock,
        "blame": ranked[:max(1, int(top))],
        "severity_counts": {
            s: sum(1 for r in records if r["severity"] == s)
            for s in SEVERITIES
        },
        "chaos_coverage": {
            k: cov[k] for k in ("injected", "observed", "unobserved_faults")
        },
    }


def _format_triage(t: dict) -> str:
    lines = [
        f"incident triage: {t['n_events']} event(s) in window"
        + (f" [{t['window'][0]:.3f}, {t['window'][1]:.3f}] ({t['clock']})"
           if t.get("window") else " (full log)")
    ]
    sev = t["severity_counts"]
    lines.append(
        "severity: " + ", ".join(f"{s}={sev[s]}" for s in SEVERITIES if sev[s])
        if any(sev.values()) else "severity: (none)"
    )
    cov = t["chaos_coverage"]
    if cov["injected"]:
        flag = "" if cov["unobserved_faults"] == 0 else "  ** UNOBSERVED **"
        lines.append(
            f"chaos coverage: {cov['observed']}/{cov['injected']} injected "
            f"fault(s) observed, {cov['unobserved_faults']} unobserved{flag}"
        )
    lines.append("ranked blame table (severity desc, first-seen asc):")
    lines.append(
        f"  {'#':>2} {'severity':<8} {'source.kind':<34} {'site':<28} "
        f"{'n':>4} {'first':>14}"
    )
    for g in t["blame"]:
        lines.append(
            f"  {g['rank']:>2} {g['severity']:<8} "
            f"{g['source'] + '.' + g['kind']:<34} "
            f"{(g['site'] or '-'):<28} {g['count']:>4} "
            f"{g['first_t_wall']:>14.3f}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI: python -m paddle_tpu_torch.telemetry.timeline report events.jsonl
# ---------------------------------------------------------------------------

def _records_from_crash_dump(path: str) -> List[dict]:
    """Pull the embedded timeline tail out of a guardian FlightRecorder
    crash dump (`payload['timeline']`, written by FlightRecorder.dump)."""
    with open(path) as f:
        dump = json.load(f)
    recs = dump.get("timeline") or []
    return [r for r in recs if isinstance(r, dict) and "t_perf" in r]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.telemetry.timeline",
        description="incident auto-triage over a unified timeline event "
                    "log: ranked blame table + chaos observability coverage",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="triage a JSON-lines timeline log "
                                       "or a crash dump's embedded tail")
    rp.add_argument("events", nargs="?", default=None,
                    help="timeline .jsonl written by dump_json_lines()")
    rp.add_argument("--crash-dump", default=None, metavar="flight_*.json",
                    help="triage the timeline tail embedded in a guardian "
                         "crash dump instead of a .jsonl log")
    rp.add_argument("--window", nargs=2, type=float, default=None,
                    metavar=("T0", "T1"),
                    help="SLO-violation window (wall-clock seconds; use "
                         "--clock perf for monotonic timestamps)")
    rp.add_argument("--clock", choices=("wall", "perf"), default="wall")
    rp.add_argument("--deadline", type=float, default=5.0,
                    help="chaos-coverage match deadline in seconds")
    rp.add_argument("--top", type=int, default=20)
    rp.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    if (args.events is None) == (args.crash_dump is None):
        p.error("exactly one of `events` or --crash-dump is required")
    if args.crash_dump:
        records = _records_from_crash_dump(args.crash_dump)
        header = {}
    else:
        header, records = load_json_lines(args.events, with_header=True)
    t = triage(records, window=tuple(args.window) if args.window else None,
               clock=args.clock, top=args.top)
    t["chaos_coverage"] = {
        k: chaos_coverage(records, deadline_s=args.deadline)[k]
        for k in ("injected", "observed", "unobserved_faults")
    }
    t["dropped_events"] = header.get("dropped", 0)
    if args.json:
        print(json.dumps(t, sort_keys=True, indent=1))
    else:
        print(_format_triage(t))
        if t["dropped_events"]:
            print(f"WARNING: {t['dropped_events']} event(s) ring-evicted "
                  "before this log was written")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
