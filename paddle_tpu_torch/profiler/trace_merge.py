"""Multi-rank chrome-trace merge: one timeline, one lane per rank
(counterpart of paddle_tpu/profiler/trace_merge.py).

Reference parity: the role of paddle.profiler's multi-worker trace
aggregation (profiler_statistic gathers per-worker NodeTrees) — here the
per-rank artifacts are the chrome://tracing JSON files the host tracer
exports (`Profiler.export` / `export_chrome_tracing`), and the merge
produces a single trace whose `pid` is the rank, so the trace viewer shows
rank lanes stacked under one clock.

Clock alignment: host-tracer timestamps are `time.perf_counter_ns()` —
monotonic but with a PER-PROCESS epoch, so raw timestamps from two ranks
are not comparable. At rendezvous every rank records a (perf_counter_ns,
unix_ns) pair via `note_rendezvous` (the distributed runtime's
`init_parallel_env` calls it once it is ported, ROADMAP Queue A item 5; a
caller may call it itself); the profiler embeds it in the export's
metadata as `clock_sync`. The merge maps each rank's
timestamps onto the wall clock with that pair:

    wall_us = ts_us + (unix_ns - perf_ns) / 1e3

Traces without `clock_sync` metadata degrade to best-effort alignment
(every such trace starts at the merged timeline's origin).

CLI:
    python -m paddle_tpu_torch.profiler.trace_merge -o merged.json \
        rank0.paddle_trace.json rank1.paddle_trace.json \
        [--requests timeline.json] [--timeline incidents.json] [--summary]

`--summary` prints the DistributedView communication table over the merged
events (feeding profiler_statistic's existing builder).

`--requests` interleaves a request-trace timeline
(`telemetry.request_trace.dump_chrome_trace`) into the merged view: request
lanes keep their own per-request pids (they are NOT flattened onto a rank
lane — `metadata.request_lanes` marks such traces) and are clock-aligned
through the same clock_sync machinery, so one chrome trace shows per-rank
host/collective spans stacked against per-request queue/prefill/decode/
preempt spans on a shared wall clock.
"""
from __future__ import annotations

import json
import time
from typing import List, Optional, Sequence, Union

# rendezvous clock-sync pair for THIS process, recorded once at bootstrap
_clock_sync: List[Optional[dict]] = [None]


def note_rendezvous(rank: int, world_size: Optional[int] = None) -> dict:
    """Record this process's rendezvous instant as a (perf_counter_ns,
    unix_ns) pair. Called right after the store join barrier, when every
    rank passes this line within one store round-trip of each other — good
    enough alignment for host-span lanes (collective spans are ms-scale).
    """
    cs = {
        "rank": int(rank),
        "world_size": int(world_size) if world_size is not None else None,
        "perf_ns": time.perf_counter_ns(),
        "unix_ns": time.time_ns(),
    }
    _clock_sync[0] = cs
    return dict(cs)


def clock_sync() -> Optional[dict]:
    """This process's recorded rendezvous pair, or None before rendezvous."""
    cs = _clock_sync[0]
    return dict(cs) if cs else None


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def load_trace(src: Union[str, dict]) -> dict:
    if isinstance(src, dict):
        return src
    with open(src) as f:
        return json.load(f)


def _trace_offset_us(trace: dict, fallback_origin_us: float) -> float:
    """Additive shift taking this trace's ts values onto the wall clock."""
    cs = (trace.get("metadata") or {}).get("clock_sync") or {}
    perf_ns, unix_ns = cs.get("perf_ns"), cs.get("unix_ns")
    if perf_ns is not None and unix_ns is not None:
        return (unix_ns - perf_ns) / 1e3
    # no sync pair: pin this trace's earliest event to the merged origin
    ts0 = min(
        (e["ts"] for e in trace.get("traceEvents", ()) if "ts" in e),
        default=0.0,
    )
    return fallback_origin_us - ts0


def merge_traces(traces: Sequence[Union[str, dict]],
                 ranks: Optional[Sequence[int]] = None) -> dict:
    """Merge per-rank chrome traces into one rank-laned timeline.

    Each input is a path or an already-loaded trace dict. The rank for each
    trace comes from its metadata (`rank`), the `ranks` argument, or its
    position. Events keep their tid (host threads stay separate lanes
    within the rank); `pid` becomes the rank, with `process_name` /
    `process_sort_index` metadata so viewers label and order the lanes.
    """
    loaded = [load_trace(t) for t in traces]
    if not loaded:
        return {"traceEvents": [], "metadata": {"merged_ranks": []}}
    rank_of = []
    for i, tr in enumerate(loaded):
        meta = tr.get("metadata") or {}
        if ranks is not None and i < len(ranks):
            rank_of.append(int(ranks[i]))
        elif meta.get("rank") is not None:
            rank_of.append(int(meta["rank"]))
        elif (meta.get("clock_sync") or {}).get("rank") is not None:
            rank_of.append(int(meta["clock_sync"]["rank"]))
        else:
            rank_of.append(i)
    if len(set(rank_of)) != len(rank_of):
        raise ValueError(f"duplicate rank lanes in merge: {rank_of}")

    def _has_sync(tr):
        cs = (tr.get("metadata") or {}).get("clock_sync") or {}
        return cs.get("perf_ns") is not None and cs.get("unix_ns") is not None

    synced = [t for t in loaded if _has_sync(t)]
    aligned = len(synced) == len(loaded)
    # wall-clock origin: the earliest SYNCED event, computed first so
    # unsynced traces can be pinned to it (not to wall-clock zero, which
    # would land them decades before the synced lanes)
    wall_starts = []
    for tr in synced:
        cs = tr["metadata"]["clock_sync"]
        ts0 = min(
            (e["ts"] for e in tr.get("traceEvents", ()) if "ts" in e),
            default=0.0,
        )
        wall_starts.append(ts0 + (cs["unix_ns"] - cs["perf_ns"]) / 1e3)
    origin = min(wall_starts) if wall_starts else 0.0
    offsets = [_trace_offset_us(t, origin) for t in loaded]

    events = []
    for tr, rank, off in zip(loaded, rank_of, offsets):
        events.append({
            "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
            "args": {"name": f"rank {rank}"},
        })
        events.append({
            "ph": "M", "name": "process_sort_index", "pid": rank, "tid": 0,
            "args": {"sort_index": rank},
        })
        for e in tr.get("traceEvents", ()):
            e2 = dict(e)
            e2["pid"] = rank
            if "ts" in e2 and e2.get("ph") != "M":
                e2["ts"] = e2["ts"] + off - origin
            args = dict(e2.get("args") or {})
            args["rank"] = rank
            e2["args"] = args
            events.append(e2)
    # stable sort by timestamp: metadata events (no ts) lead their lane
    events.sort(key=lambda e: e.get("ts", -1.0))
    return {
        "traceEvents": events,
        "metadata": {
            "merged_ranks": sorted(rank_of),
            "alignment": "clock_sync" if aligned else "best_effort",
            "origin_unix_us": origin,
            "device_trace_dirs": {
                str(r): (t.get("metadata") or {}).get("device_trace_dir")
                for t, r in zip(loaded, rank_of)
                if (t.get("metadata") or {}).get("device_trace_dir")
            },
        },
    }


def merge_request_lanes(merged: dict, req_trace: Union[str, dict]) -> dict:
    """Interleave a request-trace chrome export (one lane per request plus
    the engine/kv-pool/fleet lanes) into an already-merged rank timeline.

    The request trace keeps its own pids (allocated far above any rank id
    by `telemetry.request_trace`), so lanes never collide; its timestamps
    shift onto the merged wall clock via its embedded clock_sync pair, or
    pin to the merged origin when unsynced (same degradation contract as
    rank traces)."""
    tr = load_trace(req_trace)
    origin = (merged.get("metadata") or {}).get("origin_unix_us", 0.0)
    off = _trace_offset_us(tr, origin)
    events = merged.setdefault("traceEvents", [])
    for e in tr.get("traceEvents", ()):
        e2 = dict(e)
        if "ts" in e2 and e2.get("ph") != "M":
            e2["ts"] = e2["ts"] + off - origin
        events.append(e2)
    events.sort(key=lambda e: e.get("ts", -1.0))
    meta = merged.setdefault("metadata", {})
    meta["request_lanes"] = True
    # count only the per-request pid block — the export also carries the
    # engine/kv_pool/fleet global lanes below REQUEST_PID_BASE
    from ..telemetry.request_trace import REQUEST_PID_BASE
    meta["request_lane_count"] = len({
        e.get("pid") for e in tr.get("traceEvents", ())
        if e.get("ph") != "M" and isinstance(e.get("pid"), int)
        and e["pid"] >= REQUEST_PID_BASE
    })
    return merged


def merge_timeline_lane(merged: dict, tl_trace: Union[str, dict]) -> dict:
    """Interleave an incident-timeline chrome export
    (`telemetry.timeline.dump_chrome_trace`, one instant-event lane at pid
    90010) into an already-merged rank timeline. Timestamps shift onto the
    merged wall clock via the export's clock_sync pair (derived from the
    oldest retained record — every timeline record carries both clocks), or
    pin to the merged origin when unsynced (same degradation contract as
    rank and request lanes)."""
    tr = load_trace(tl_trace)
    origin = (merged.get("metadata") or {}).get("origin_unix_us", 0.0)
    off = _trace_offset_us(tr, origin)
    events = merged.setdefault("traceEvents", [])
    n = 0
    for e in tr.get("traceEvents", ()):
        e2 = dict(e)
        if "ts" in e2 and e2.get("ph") != "M":
            e2["ts"] = e2["ts"] + off - origin
            n += 1
        events.append(e2)
    events.sort(key=lambda e: e.get("ts", -1.0))
    meta = merged.setdefault("metadata", {})
    meta["timeline_lane"] = True
    meta["timeline_event_count"] = n
    return merged


def to_statistic_data(merged: dict):
    """Rehydrate a merged trace into a StatisticData so the existing
    summary builders (DistributedView's communication table in particular)
    run over the cross-rank timeline."""
    from .profiler_statistic import StatisticData
    from .utils import HostEvent

    events = []
    for e in merged.get("traceEvents", ()):
        if e.get("ph") == "M" or "ts" not in e or "dur" not in e:
            continue
        start_ns = int(e["ts"] * 1e3)
        events.append(HostEvent(
            e.get("name", "?"),
            e.get("cat", "UserDefined"),
            start_ns,
            start_ns + int(e["dur"] * 1e3),
            e.get("tid", 0),
            e.get("args"),
        ))
    return StatisticData(events)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.profiler.trace_merge",
        description="merge per-rank chrome traces into one rank-laned "
                    "timeline (clock-aligned via the rendezvous timestamp)",
    )
    p.add_argument("traces", nargs="+", help="per-rank *.paddle_trace.json")
    p.add_argument("-o", "--output", required=True, help="merged trace path")
    p.add_argument(
        "--ranks", default=None,
        help="comma-separated rank override (default: trace metadata)",
    )
    p.add_argument(
        "--requests", default=None, metavar="timeline.json",
        help="request-trace chrome export (telemetry.request_trace."
             "dump_chrome_trace) whose per-request lanes interleave with "
             "the rank lanes",
    )
    p.add_argument(
        "--timeline", default=None, metavar="incidents.json",
        help="incident-timeline chrome export (telemetry.timeline."
             "dump_chrome_trace) merged as one instant-event lane so "
             "fault injections / migrations / mode flips line up against "
             "the rank and request lanes on the shared wall clock",
    )
    p.add_argument(
        "--summary", action="store_true",
        help="print the merged DistributedView communication table",
    )
    args = p.parse_args(argv)
    ranks = (
        [int(r) for r in args.ranks.split(",")] if args.ranks else None
    )
    merged = merge_traces(args.traces, ranks=ranks)
    if args.requests:
        merged = merge_request_lanes(merged, args.requests)
    if args.timeline:
        merged = merge_timeline_lane(merged, args.timeline)
    with open(args.output, "w") as f:
        json.dump(merged, f)
    n = sum(1 for e in merged["traceEvents"] if e.get("ph") != "M")
    req_note = (
        f", {merged['metadata'].get('request_lane_count', 0)} request lane(s)"
        if args.requests else ""
    )
    if args.timeline:
        req_note += (
            f", {merged['metadata'].get('timeline_event_count', 0)} "
            "incident event(s)"
        )
    print(
        f"merged {len(args.traces)} trace(s) -> {args.output}: {n} events, "
        f"ranks {merged['metadata']['merged_ranks']}, "
        f"alignment={merged['metadata']['alignment']}{req_note}"
    )
    if args.summary:
        from .profiler_statistic import _build_distributed_table

        table = _build_distributed_table(to_statistic_data(merged))
        print(table or "(no Communication events in the merged trace)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
