"""Request-scoped tracing & SLO attribution for the serving stack
(counterpart of paddle_tpu/telemetry/request_trace.py).

The serving histograms report *that* p99 TTFT/TPOT moved; this layer answers *why* for any given request. Every
sampled request carries a trace handle through its whole life — scheduler
queue, chunked-prefill streaming, decode, pool-dry preemption, fleet
evacuation, swap drain — as a chain of contiguous, cause-labeled PHASE
spans, so each request's wall time decomposes exactly into named
components:

    queue_wait | prefill | decode | preempt       (disjoint, sum == wall)
    swap_overlap                                  (overlay, informational)

Because a phase transition closes the old span and opens the new one at
the SAME timestamp, the components sum to the measured wall time by
construction — the consistency ratio is therefore a tracing-health gate
(ring eviction or a missed transition shows up as a sum shortfall).

Design (the flight-recorder shape, request-keyed):

- A bounded, thread-safe ring (`FLAGS_request_trace_ring`) of finished
  spans + point events in one global recorder. Handles only exist for
  sampled requests, so the off path costs one attribute read per site
  (`req.trace is None`); global lanes (engine dispatch, kv pool, fleet)
  check the cached `enabled()` bool like every other telemetry site.
- Sampling is DETERMINISTIC per request id (`FLAGS_request_trace_sample`
  fraction via a multiplicative hash), so a replayed trace samples the
  same requests every run.
- Exports: chrome-trace with ONE LANE PER REQUEST, a JSON-lines event
  log, and `slo_breakdown()` — the TTFT/TPOT decomposition with a p99
  blame table and SLO burn-rate.

CLI:
    python -m paddle_tpu_torch.telemetry.request_trace report events.jsonl \
        [--slo-ttft-ms F] [--slo-tpot-ms F] [--slo-target 0.99] [--json]
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..framework import flags as _flags

__all__ = [
    "RequestTrace",
    "RequestTraceRecorder",
    "enabled",
    "sampled",
    "start",
    "record_event",
    "record_span",
    "recorder",
    "set_recorder",
    "reset",
    "analyze",
    "slo_breakdown",
    "serving_section",
    "to_chrome_trace",
    "dump_json_lines",
]

_flags.define_flag(
    "FLAGS_request_trace",
    False,
    "request-scoped serving traces: sampled requests carry phase spans "
    "(queue/prefill/decode/preempt, cause-labeled) through the scheduler/"
    "engine/kv-pool/fleet path, exported as per-request chrome-trace lanes "
    "+ JSON-lines + the TTFT/TPOT slo_breakdown; off = ~zero cost (one "
    "attribute read per site)",
)
_flags.define_flag(
    "FLAGS_request_trace_sample",
    1.0,
    "fraction of requests traced when FLAGS_request_trace is on; the "
    "decision is a deterministic hash of the request id, so a replayed "
    "trace samples the same requests every run",
)
_flags.define_flag(
    "FLAGS_request_trace_ring",
    65536,
    "finished spans/events kept in the request-trace ring (oldest evicted; "
    "evictions are counted and surface as a consistency shortfall in the "
    "breakdown rather than silent truncation)",
)

# cached gate, kept in sync by the flag watcher (same discipline as
# telemetry.metrics: hot paths read one plain bool, never the flags lock)
_enabled = bool(_flags.get_flag("FLAGS_request_trace"))
_sample = float(_flags.get_flag("FLAGS_request_trace_sample"))


def _sync_enabled(_value) -> None:
    global _enabled
    _enabled = bool(_flags.get_flag("FLAGS_request_trace"))


def _sync_sample(_value) -> None:
    global _sample
    _sample = float(_flags.get_flag("FLAGS_request_trace_sample"))


_flags.watch_flag("FLAGS_request_trace", _sync_enabled)
_flags.watch_flag("FLAGS_request_trace_sample", _sync_sample)


def enabled() -> bool:
    return _enabled


def _hash01(rid: int) -> float:
    """[0, 1) deterministic per request id (Knuth multiplicative hash)."""
    return ((int(rid) * 2654435761) & 0xFFFFFFFF) / 4294967296.0


def sampled(rid: int) -> bool:
    if not _enabled:
        return False
    s = _sample
    if s >= 1.0:
        return True
    return _hash01(rid) < s


# span/phase names (the breakdown components)
PHASES = ("queue", "prefill", "decode", "preempt")
# global lanes (non-request-keyed events ride the same ring)
LANES = ("request", "engine", "kv_pool", "fleet", "qos")


class RequestTraceRecorder:
    """Bounded thread-safe ring of finished spans + point events.

    Records are plain JSON-clean dicts:
      span:  {"type": "span", "lane", "rid", "name", "t0", "t1", "attrs"}
      event: {"type": "event", "lane", "rid", "name", "t", "attrs"}
    `rid` is None on global-lane records. Timestamps are whatever clock the
    instrumented site runs on (the scheduler's injectable clock in serving);
    the chrome export maps them onto the wall clock via a (clock_ns,
    unix_ns) pair captured at the FIRST record, trace_merge-compatible.
    """

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(_flags.get_flag("FLAGS_request_trace_ring"))
        self._ring: deque = deque(maxlen=max(int(capacity), 16))
        self._lock = threading.Lock()
        self._appended = 0
        # open phase handles, for orphan detection (chaos tests + report)
        self._open: Dict[int, "RequestTrace"] = {}
        self._clock_sync: Optional[dict] = None

    # ---- append ----
    def _append(self, rec: dict, t_for_sync: float) -> None:
        with self._lock:
            if self._clock_sync is None:
                # the first record pins this recorder's clock onto the wall
                # clock (trace_merge's alignment pair); a fake test clock
                # still maps consistently, just not onto real wall time
                self._clock_sync = {
                    "perf_ns": int(t_for_sync * 1e9),
                    "unix_ns": time.time_ns(),
                }
            self._appended += 1
            self._ring.append(rec)

    def add_span(self, lane: str, name: str, t0: float, t1: float,
                 rid: Optional[int] = None, attrs: Optional[dict] = None) -> None:
        self._append(
            {"type": "span", "lane": lane, "rid": rid, "name": name,
             "t0": float(t0), "t1": float(t1), "attrs": dict(attrs or {})},
            t0,
        )

    def add_event(self, lane: str, name: str, t: float,
                  rid: Optional[int] = None, attrs: Optional[dict] = None) -> None:
        self._append(
            {"type": "event", "lane": lane, "rid": rid, "name": name,
             "t": float(t), "attrs": dict(attrs or {})},
            t,
        )

    # ---- read ----
    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    @property
    def dropped(self) -> int:
        """Records evicted from the ring (appended - retained)."""
        with self._lock:
            return self._appended - len(self._ring)

    def open_spans(self) -> List[tuple]:
        """(rid, phase) for every trace whose current phase never closed —
        must be empty once traffic drains (the no-orphaned-spans contract)."""
        with self._lock:
            return [(tr.rid, tr._phase) for tr in self._open.values()
                    if tr._phase is not None]

    def clock_sync(self) -> Optional[dict]:
        with self._lock:
            return dict(self._clock_sync) if self._clock_sync else None

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._appended = 0
            self._open.clear()
            self._clock_sync = None


class RequestTrace:
    """One sampled request's phase machine. NOT thread-safe by itself —
    exactly one scheduler/fleet owns a request at any instant (evacuation
    hands the whole object over), which is the same single-writer contract
    the Request's runtime fields already rely on."""

    __slots__ = ("rid", "_rec", "_phase", "_t0", "_attrs")

    def __init__(self, rid: int, rec: RequestTraceRecorder):
        self.rid = int(rid)
        self._rec = rec
        self._phase: Optional[str] = None
        self._t0: float = 0.0
        self._attrs: dict = {}
        with rec._lock:
            rec._open[id(self)] = self

    @property
    def phase_name(self) -> Optional[str]:
        return self._phase

    def event(self, name: str, t: float, **attrs) -> None:
        self._rec.add_event("request", name, t, rid=self.rid, attrs=attrs)

    def phase(self, name: str, t: float, **attrs) -> None:
        """Close the open phase span at `t` and open `name` at the SAME
        instant — contiguity is what makes the components sum to the wall
        time exactly."""
        if self._phase is not None:
            self._rec.add_span("request", self._phase, self._t0, t,
                               rid=self.rid, attrs=self._attrs)
        self._phase = name
        self._t0 = float(t)
        self._attrs = attrs

    def close(self, t: float, outcome: str, **attrs) -> None:
        """Terminal transition: close the open phase and record the
        `finish` event carrying the outcome. Every terminal path
        (completed/expired/cancelled) runs through here, so a drained
        system has zero open spans."""
        if self._phase is not None:
            self._rec.add_span("request", self._phase, self._t0, t,
                               rid=self.rid, attrs=self._attrs)
            self._phase = None
        attrs = dict(attrs)
        attrs["outcome"] = outcome
        self._rec.add_event("request", "finish", t, rid=self.rid, attrs=attrs)
        with self._rec._lock:
            self._rec._open.pop(id(self), None)


# ---------------------------------------------------------------------------
# module-level default recorder + instrumentation entry points
# ---------------------------------------------------------------------------

_default_recorder = RequestTraceRecorder()


def recorder() -> RequestTraceRecorder:
    return _default_recorder


def set_recorder(rec: RequestTraceRecorder) -> RequestTraceRecorder:
    global _default_recorder
    _default_recorder = rec
    return rec


def reset() -> None:
    _default_recorder.reset()


def start(rid: int, t: float, **attrs) -> Optional[RequestTrace]:
    """Sampling gate + handle creation, called once per request at submit.
    Returns None when tracing is off or the request is not sampled — every
    downstream site then costs one `req.trace is None` read."""
    if not sampled(rid):
        return None
    tr = RequestTrace(rid, _default_recorder)
    if attrs:
        tr.event("submit", t, **attrs)
    return tr


def record_event(lane: str, name: str, t: Optional[float] = None,
                 rid: Optional[int] = None, **attrs) -> None:
    """Global-lane point event (engine dispatch, kv pool, fleet routing);
    no-op unless tracing is enabled."""
    if not _enabled:
        return
    _default_recorder.add_event(
        lane, name, time.monotonic() if t is None else t, rid=rid, attrs=attrs
    )


def record_span(lane: str, name: str, t0: float, t1: float,
                rid: Optional[int] = None, **attrs) -> None:
    """Global-lane span (swap drain window); no-op unless enabled."""
    if not _enabled:
        return
    _default_recorder.add_span(lane, name, t0, t1, rid=rid, attrs=attrs)


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

# chrome-trace pid blocks: request lanes live far above any real rank pid
# so a merged trace can never collide lanes. The `compile` lane carries the
# compile-cache ledger's spans so cold-start compile activity
# interleaves with the request/engine lanes in a merged trace.
REQUEST_PID_BASE = 100000
_GLOBAL_LANE_PIDS = {"engine": 90001, "kv_pool": 90002, "fleet": 90003,
                     "compile": 90004, "qos": 90005}


def to_chrome_trace(rec: Optional[RequestTraceRecorder] = None) -> dict:
    """Chrome-trace dict: one lane (pid) per request plus one lane per
    global source; `metadata.request_lanes` marks it for trace_merge's
    `--requests` path (lanes are preserved, not flattened onto a rank)."""
    rec = rec or _default_recorder
    events: List[dict] = []
    named = set()

    def _pid(r):
        if r["rid"] is not None:
            return REQUEST_PID_BASE + int(r["rid"])
        return _GLOBAL_LANE_PIDS.get(r["lane"], 90000)

    def _name_lane(pid, label):
        if pid in named:
            return
        named.add(pid)
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        events.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                       "tid": 0, "args": {"sort_index": pid}})

    for r in rec.records():
        pid = _pid(r)
        label = (f"request {r['rid']}" if r["rid"] is not None
                 else f"serving {r['lane']}")
        _name_lane(pid, label)
        args = dict(r["attrs"])
        if r["rid"] is not None:
            args["rid"] = r["rid"]
        if r["type"] == "span":
            events.append({
                "ph": "X", "name": r["name"], "cat": f"serving_{r['lane']}",
                "pid": pid, "tid": 0, "ts": r["t0"] * 1e6,
                "dur": max(0.0, (r["t1"] - r["t0"]) * 1e6), "args": args,
            })
        else:
            events.append({
                "ph": "i", "name": r["name"], "cat": f"serving_{r['lane']}",
                "pid": pid, "tid": 0, "ts": r["t"] * 1e6, "s": "p",
                "args": args,
            })
    meta = {"request_lanes": True}
    cs = rec.clock_sync()
    if cs:
        meta["clock_sync"] = cs
    return {"traceEvents": events, "metadata": meta}


def dump_chrome_trace(path: str, rec: Optional[RequestTraceRecorder] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(rec), f)
    return path


def to_json_lines(rec: Optional[RequestTraceRecorder] = None) -> str:
    """One JSON object per line: every span/event in ring order, preceded
    by a header line carrying the clock-sync pair + eviction count."""
    rec = rec or _default_recorder
    header = {
        "type": "header", "version": 1, "dropped": rec.dropped,
        "clock_sync": rec.clock_sync(),
    }
    lines = [json.dumps(header, sort_keys=True)]
    lines.extend(json.dumps(r, sort_keys=True) for r in rec.records())
    return "\n".join(lines)


def dump_json_lines(path: str, rec: Optional[RequestTraceRecorder] = None) -> str:
    with open(path, "w") as f:
        f.write(to_json_lines(rec))
        f.write("\n")
    return path


def load_json_lines(path: str, with_header: bool = False):
    """Read an event log back: the span/event records, or with
    `with_header` a `(header, records)` pair (header `{}` if absent)."""
    header: dict = {}
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("type") in ("span", "event"):
                out.append(rec)
            elif rec.get("type") == "header" and not header:
                header = rec
    return (header, out) if with_header else out


# ---------------------------------------------------------------------------
# analysis: the TTFT/TPOT decomposition
# ---------------------------------------------------------------------------

def _pctl(values: Sequence[float], q: float) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = (len(vs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


def _stats_ms(values: Sequence[float]) -> dict:
    if not values:
        return {"n": 0, "mean": None, "p50": None, "p99": None}
    return {
        "n": len(values),
        "mean": round(sum(values) / len(values) * 1000, 3),
        "p50": round(_pctl(values, 50) * 1000, 3),
        "p99": round(_pctl(values, 99) * 1000, 3),
    }


def _overlap(t0: float, t1: float, windows: Sequence[tuple]) -> float:
    total = 0.0
    for w0, w1 in windows:
        total += max(0.0, min(t1, w1) - max(t0, w0))
    return total


def analyze(records: Optional[Sequence[dict]] = None) -> dict:
    """Aggregate the ring (or a loaded event log) per request. Returns the
    raw per-request table the breakdown/report summarize:
      rid -> {start, finish, outcome, components{phase: s}, ttft_s,
              decode_start, generated, preemptions, causes{cause: n},
              swap_overlap_s}
    plus the global-lane aggregates (engine bucket events, kv pool
    occupancy, swap windows)."""
    if records is None:
        records = _default_recorder.records()
    swap_windows = [
        (r["t0"], r["t1"]) for r in records
        if r["type"] == "span" and r["lane"] == "fleet"
        and r["name"] == "swap_drain"
    ]
    per: Dict[int, dict] = {}

    def _req(rid):
        return per.setdefault(rid, {
            "rid": rid, "start": None, "finish": None, "outcome": None,
            "components": {p: 0.0 for p in PHASES}, "decode_start": None,
            "generated": None, "preemptions": 0, "causes": {},
            "swap_overlap_s": 0.0, "pages_allocated": 0, "pages_freed": 0,
            "pages_shared": 0, "routes": [], "first_span": None,
            # prefix-cache + speculative-decode attribution
            "cached_tokens": 0, "drafted": 0, "accepted": 0,
        })

    engine = {"bucket_hits": 0, "bucket_compiles": 0, "compile_s_total": 0.0}
    pool_peak_used = 0
    for r in records:
        lane = r["lane"]
        if lane == "request":
            rid = r["rid"]
            q = _req(rid)
            if r["type"] == "span":
                t0, t1 = r["t0"], r["t1"]
                name = r["name"]
                if q["start"] is None or t0 < q["start"]:
                    q["start"] = t0
                    q["first_span"] = name
                if name in q["components"]:
                    q["components"][name] += t1 - t0
                if name == "decode" and q["decode_start"] is None:
                    q["decode_start"] = t0
                cause = r["attrs"].get("cause")
                if cause:
                    q["causes"][cause] = q["causes"].get(cause, 0) + 1
                q["swap_overlap_s"] += _overlap(t0, t1, swap_windows)
            elif r["name"] == "finish":
                q["finish"] = r["t"]
                q["outcome"] = r["attrs"].get("outcome")
                if r["attrs"].get("generated") is not None:
                    q["generated"] = r["attrs"]["generated"]
                if r["attrs"].get("preemptions") is not None:
                    q["preemptions"] = r["attrs"]["preemptions"]
                # where the TTFT/TPOT wins came from — prompt
                # tokens served from shared prefix pages, and draft tokens
                # proposed/verified by speculative decoding
                for fld in ("cached_tokens", "drafted", "accepted"):
                    if r["attrs"].get(fld) is not None:
                        q[fld] = r["attrs"][fld]
            elif r["name"] == "route":
                q["routes"].append({
                    "replica": r["attrs"].get("replica"),
                    "reason": r["attrs"].get("reason"),
                })
        elif lane == "engine" and r["type"] == "event":
            ev = r["attrs"].get("event")
            if ev == "hit":
                engine["bucket_hits"] += 1
            elif ev == "compile":
                engine["bucket_compiles"] += 1
                engine["compile_s_total"] += float(r["attrs"].get("dur_s") or 0.0)
        elif lane == "kv_pool" and r["type"] == "event":
            used = r["attrs"].get("used")
            if used is not None:
                pool_peak_used = max(pool_peak_used, int(used))
            rid = r["rid"]
            if rid is not None:
                q = _req(rid)
                n = int(r["attrs"].get("n") or 0)
                if r["name"] == "alloc":
                    q["pages_allocated"] += n
                elif r["name"] == "free":
                    q["pages_freed"] += n
                elif r["name"] == "share":
                    q["pages_shared"] += n
    for q in per.values():
        if q["start"] is not None and q["decode_start"] is not None:
            q["ttft_s"] = q["decode_start"] - q["start"]
        else:
            q["ttft_s"] = None
        if q["start"] is not None and q["finish"] is not None:
            q["wall_s"] = q["finish"] - q["start"]
        else:
            q["wall_s"] = None
        # every traced lifecycle opens with a queue span; anything else as
        # the earliest retained span means the ring evicted the head of
        # this request's trace — its wall_s and component sums SHRINK
        # TOGETHER, so consistency alone cannot see the loss
        q["truncated"] = (q["first_span"] is not None
                          and q["first_span"] != "queue")
    return {
        "requests": per,
        "engine": engine,
        "kv_pool": {"peak_used_pages": pool_peak_used},
        "swap_windows": swap_windows,
    }


def slo_breakdown(
    records: Optional[Sequence[dict]] = None,
    *,
    slo_ttft_ms: Optional[float] = None,
    slo_tpot_ms: Optional[float] = None,
    slo_target: float = 0.99,
    rec: Optional[RequestTraceRecorder] = None,
) -> dict:
    """The decomposition record: per-component TTFT/TPOT attribution with
    a p99 blame table, trace-health consistency, and (with SLO targets)
    the burn rate."""
    rec = rec or _default_recorder
    if records is None:
        records = rec.records()
    a = analyze(records)
    done = [q for q in a["requests"].values()
            if q["wall_s"] is not None and q["wall_s"] > 0]
    n = len(done)
    out = {
        "n_traced": n,
        # from the live recorder; the CLI overrides both when summarizing a
        # loaded log (the log's header carries its own eviction count)
        "open_spans": len(rec.open_spans()),
        "dropped_records": rec.dropped,
        # requests whose leading spans the ring evicted: their consistency
        # ratio still reads ~1.0 (wall shrinks with the lost spans), so the
        # count is the honest eviction signal
        "truncated_requests": sum(
            1 for q in a["requests"].values() if q["truncated"]),
        "engine": a["engine"],
        "kv_pool": a["kv_pool"],
        "swap_windows": len(a["swap_windows"]),
    }
    if not n:
        out["consistency"] = None
        return out

    # consistency: component sum / measured wall, per request — contiguous
    # phases make this ≈1.0 exactly; a shortfall means evicted/missed spans
    ratios = [sum(q["components"].values()) / q["wall_s"] for q in done]
    out["consistency"] = {
        "mean": round(sum(ratios) / n, 4),
        "min": round(min(ratios), 4),
        "max_abs_err_frac": round(max(abs(r - 1.0) for r in ratios), 4),
    }

    ttfts = [q["ttft_s"] for q in done if q["ttft_s"] is not None]
    walls = [q["wall_s"] for q in done]
    out["ttft_ms"] = _stats_ms(ttfts)
    out["e2e_ms"] = _stats_ms(walls)
    # traced TPOT: decode-phase wall over the decode interval count
    tpots = []
    for q in done:
        if q["decode_start"] is not None and q["generated"] and q["generated"] > 1:
            tpots.append((q["finish"] - q["decode_start"]) / (q["generated"] - 1))
    out["tpot_ms"] = _stats_ms(tpots)

    # per-component totals: TTFT side = everything before decode starts
    # (queue + prefill + preempt-before-first-token approximated by all
    # preempt time for requests still prefilling); e2e side = everything
    comp_e2e = {p: [q["components"][p] for q in done] for p in PHASES}
    ttft_side = ("queue", "prefill", "preempt")
    comp_ttft: Dict[str, List[float]] = {p: [] for p in ttft_side}
    for q in done:
        if q["ttft_s"] is None:
            continue
        for p in ttft_side:
            comp_ttft[p].append(q["components"][p])
    rename = {"queue": "queue_wait"}
    out["components_mean_ms"] = {
        rename.get(p, p): round(sum(v) / len(v) * 1000, 3) if v else 0.0
        for p, v in comp_e2e.items()
    }
    out["components_mean_ms"]["swap_overlap"] = round(
        sum(q["swap_overlap_s"] for q in done) / n * 1000, 3
    )
    out["ttft_p99_components_ms"] = {
        rename.get(p, p): round((_pctl(v, 99) or 0.0) * 1000, 3)
        for p, v in comp_ttft.items()
    }
    out["e2e_p99_components_ms"] = {
        rename.get(p, p): round((_pctl(v, 99) or 0.0) * 1000, 3)
        for p, v in comp_e2e.items()
    }
    # blame table: components ranked by their share of the p99-tail TTFT —
    # "what should I fix to move p99" in one read
    p99_ttft = _pctl(ttfts, 99) if ttfts else None
    blame = []
    if p99_ttft:
        tail = [q for q in done
                if q["ttft_s"] is not None and q["ttft_s"] >= p99_ttft * 0.999]
        for p in ttft_side:
            tot = sum(q["components"][p] for q in tail)
            tail_ttft = sum(q["ttft_s"] for q in tail)
            blame.append({
                "component": rename.get(p, p),
                "p99_ms": out["ttft_p99_components_ms"][rename.get(p, p)],
                "share_of_p99_ttft": round(tot / tail_ttft, 4) if tail_ttft else 0.0,
            })
        blame.sort(key=lambda b: -b["share_of_p99_ttft"])
    out["ttft_p99_blame"] = blame

    causes: Dict[str, int] = {}
    outcomes: Dict[str, int] = {}
    for q in done:
        for c, k in q["causes"].items():
            causes[c] = causes.get(c, 0) + k
        if q["outcome"]:
            outcomes[q["outcome"]] = outcomes.get(q["outcome"], 0) + 1
    out["causes"] = causes
    out["outcomes"] = outcomes
    out["preemptions"] = sum(q["preemptions"] for q in done)
    out["pages_allocated"] = sum(q["pages_allocated"] for q in done)
    out["pages_shared"] = sum(q["pages_shared"] for q in done)
    # attribution for WHERE TTFT/TPOT wins come from — prefix
    # reuse (prompt tokens never recomputed) and speculative decoding
    # (tokens committed per verify step beyond the baseline one)
    out["cached_tokens"] = sum(q["cached_tokens"] for q in done)
    out["prefix_hit_requests"] = sum(1 for q in done if q["cached_tokens"])
    drafted = sum(q["drafted"] for q in done)
    accepted = sum(q["accepted"] for q in done)
    out["spec"] = {
        "drafted_tokens": drafted,
        "accepted_tokens": accepted,
        "accept_rate": round(accepted / drafted, 4) if drafted else None,
    }

    if slo_ttft_ms is not None or slo_tpot_ms is not None:
        budget = max(1e-9, 1.0 - float(slo_target))
        slo: dict = {"target": float(slo_target)}
        if slo_ttft_ms is not None and ttfts:
            viol = sum(1 for t in ttfts if t * 1000 > slo_ttft_ms)
            slo.update(ttft_target_ms=float(slo_ttft_ms), ttft_violations=viol,
                       ttft_burn_rate=round((viol / len(ttfts)) / budget, 3))
        if slo_tpot_ms is not None and tpots:
            viol = sum(1 for t in tpots if t * 1000 > slo_tpot_ms)
            slo.update(tpot_target_ms=float(slo_tpot_ms), tpot_violations=viol,
                       tpot_burn_rate=round((viol / len(tpots)) / budget, 3))
        out["slo"] = slo
    return out


def serving_section() -> dict:
    """`perf_report()['serving']`: the live recorder's decomposition, or an
    explicit unavailable marker when nothing was traced."""
    rec = _default_recorder
    if not any(r["lane"] == "request" for r in rec.records()):
        return {
            "available": False,
            "reason": ("no traced requests (FLAGS_request_trace off, "
                       "sampling excluded everything, or no serving traffic)"),
        }
    bd = slo_breakdown(rec=rec)
    bd["available"] = True
    return bd


# ---------------------------------------------------------------------------
# CLI: python -m paddle_tpu_torch.telemetry.request_trace report events.jsonl
# ---------------------------------------------------------------------------

def _format_report(bd: dict) -> str:
    lines = []
    lines.append(
        f"request trace report: {bd['n_traced']} traced request(s), "
        f"{bd.get('dropped_records', 0)} ring-evicted record(s), "
        f"{bd.get('truncated_requests', 0)} truncated trace(s), "
        f"{bd.get('open_spans') or 0} orphaned open span(s)"
    )
    cons = bd.get("consistency")
    if cons:
        flag = "" if cons["max_abs_err_frac"] <= 0.05 else "  ** INCONSISTENT **"
        lines.append(
            f"consistency (component-sum / wall): mean {cons['mean']:.4f}, "
            f"min {cons['min']:.4f}, max err {cons['max_abs_err_frac']:.2%}{flag}"
        )
    if not bd["n_traced"]:
        return "\n".join(lines)
    for label, key in (("TTFT", "ttft_ms"), ("E2E", "e2e_ms"), ("TPOT", "tpot_ms")):
        s = bd.get(key) or {}
        if s.get("n"):
            lines.append(
                f"{label}: p50 {s['p50']:.2f} ms  p99 {s['p99']:.2f} ms  "
                f"mean {s['mean']:.2f} ms  (n={s['n']})"
            )
    lines.append("p99 TTFT blame table (share of the tail request's TTFT):")
    lines.append(f"  {'component':<12} {'p99 ms':>10} {'share':>8}")
    for b in bd.get("ttft_p99_blame", []):
        lines.append(
            f"  {b['component']:<12} {b['p99_ms']:>10.2f} "
            f"{b['share_of_p99_ttft']:>8.1%}"
        )
    mean = bd.get("components_mean_ms") or {}
    lines.append(
        "mean components (ms): "
        + ", ".join(f"{k}={v:.2f}" for k, v in mean.items())
    )
    if bd.get("causes"):
        lines.append(
            "preempt causes: "
            + ", ".join(f"{k}={v}" for k, v in sorted(bd["causes"].items()))
        )
    if bd.get("outcomes"):
        lines.append(
            "outcomes: "
            + ", ".join(f"{k}={v}" for k, v in sorted(bd["outcomes"].items()))
        )
    if bd.get("cached_tokens"):
        lines.append(
            f"prefix cache: {bd['cached_tokens']} prompt token(s) served from "
            f"shared pages across {bd.get('prefix_hit_requests', 0)} request(s), "
            f"{bd.get('pages_shared', 0)} page share(s)"
        )
    spec = bd.get("spec") or {}
    if spec.get("drafted_tokens"):
        lines.append(
            f"speculative decode: {spec['drafted_tokens']} drafted, "
            f"{spec['accepted_tokens']} accepted "
            f"(accept rate {spec['accept_rate']:.1%})"
        )
    slo = bd.get("slo")
    if slo:
        parts = [f"target {slo['target']:.2%}"]
        if "ttft_burn_rate" in slo:
            parts.append(
                f"TTFT<{slo['ttft_target_ms']:.0f}ms: "
                f"{slo['ttft_violations']} violation(s), "
                f"burn rate {slo['ttft_burn_rate']:.2f}x"
            )
        if "tpot_burn_rate" in slo:
            parts.append(
                f"TPOT<{slo['tpot_target_ms']:.0f}ms: "
                f"{slo['tpot_violations']} violation(s), "
                f"burn rate {slo['tpot_burn_rate']:.2f}x"
            )
        lines.append("SLO: " + "; ".join(parts))
    eng = bd.get("engine") or {}
    if eng.get("bucket_hits") or eng.get("bucket_compiles"):
        lines.append(
            f"engine buckets: {eng['bucket_hits']} hit(s), "
            f"{eng['bucket_compiles']} compile(s) "
            f"({eng['compile_s_total']:.3f} s compiling)"
        )
    kv = bd.get("kv_pool") or {}
    if kv.get("peak_used_pages"):
        lines.append(f"kv pool: peak {kv['peak_used_pages']} page(s) in use, "
                     f"{bd.get('pages_allocated', 0)} page-alloc(s) attributed")
    if bd.get("swap_windows"):
        lines.append(f"swap drain windows: {bd['swap_windows']}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.telemetry.request_trace",
        description="decompose a request-trace event log into TTFT/TPOT "
                    "components with a p99 blame table and SLO burn rate",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="summarize a JSON-lines event log")
    rp.add_argument("events", help="events.jsonl written by dump_json_lines()")
    rp.add_argument("--slo-ttft-ms", type=float, default=None)
    rp.add_argument("--slo-tpot-ms", type=float, default=None)
    rp.add_argument("--slo-target", type=float, default=0.99,
                    help="SLO attainment target for the burn rate (default 0.99)")
    rp.add_argument("--json", action="store_true",
                    help="emit the breakdown as JSON instead of the table")
    args = p.parse_args(argv)
    header, records = load_json_lines(args.events, with_header=True)
    bd = slo_breakdown(
        records,
        slo_ttft_ms=args.slo_ttft_ms,
        slo_tpot_ms=args.slo_tpot_ms,
        slo_target=args.slo_target,
    )
    # the live recorder's state is irrelevant to a loaded log: orphans are
    # request lanes with no terminal event, evictions come from the header
    finished = {r["rid"] for r in records
                if r["type"] == "event" and r["name"] == "finish"}
    traced = {r["rid"] for r in records
              if r["lane"] == "request" and r["rid"] is not None}
    bd["open_spans"] = len(traced - finished)
    bd["dropped_records"] = header.get("dropped", 0)
    if args.json:
        print(json.dumps(bd, sort_keys=True, indent=1))
    else:
        print(_format_report(bd))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
