"""Aggregation and summary tables over collected events (counterpart of
paddle_tpu/profiler/profiler_statistic.py).

Reference parity: python/paddle/profiler/profiler_statistic.py (SortedKeys,
summary tables printed by Profiler.summary) and chrometracing_logger.cc's
chrome://tracing JSON export. A record window holds the host tracer's
spans and, on the card, torch.profiler's device events (kernels, copies,
memsets), which the export places in a `device` lane (pid 1) on the host
spans' clock and the kernel table summarises.
"""
from __future__ import annotations

from enum import Enum


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4  # device tables sort by these
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class EventSummary:
    __slots__ = ("name", "call", "total_ns", "max_ns", "min_ns")

    def __init__(self, name):
        self.name = name
        self.call = 0
        self.total_ns = 0
        self.max_ns = 0
        self.min_ns = None

    def add(self, dur_ns):
        self.call += 1
        self.total_ns += dur_ns
        self.max_ns = max(self.max_ns, dur_ns)
        self.min_ns = dur_ns if self.min_ns is None else min(self.min_ns, dur_ns)

    @property
    def avg_ns(self):
        return self.total_ns / self.call if self.call else 0


DEVICE_PID = 1  # the device lane of an export; host spans are pid 0


class StatisticData:
    """Collected result for one record window: host events, the device
    events torch.profiler recorded (chrome-trace dicts already on the host
    spans' clock: name, cat, ts, dur in µs) and the directory holding its
    own export."""

    def __init__(self, host_events, device_trace_dir=None, memory_census=None,
                 device_events=()):
        self.host_events = list(host_events)
        self.device_events = [dict(e) for e in device_events]
        self.device_trace_dir = device_trace_dir
        # live-HBM census (perf_attribution.live_array_census) captured at
        # collect time; feeds the MemoryView summary table
        self.memory_census = memory_census

    def event_summaries(self):
        table = {}
        for ev in self.host_events:
            s = table.get(ev.name)
            if s is None:
                s = table[ev.name] = EventSummary(ev.name)
            s.add(ev.duration_ns)
        return table

    def to_chrome_trace(self):
        events = []
        for ev in self.host_events:
            entry = {
                "name": ev.name,
                "cat": ev.event_type,
                "ph": "X",
                "ts": ev.start_ns / 1e3,  # chrome tracing uses microseconds
                "dur": ev.duration_ns / 1e3,
                "pid": 0,
                "tid": ev.tid,
            }
            if getattr(ev, "args", None):
                entry["args"] = dict(ev.args)
            events.append(entry)
        for ev in self.device_events:
            events.append(dict(ev, ph="X", pid=DEVICE_PID))
        meta = {"device_trace_dir": self.device_trace_dir,
                "device_events": len(self.device_events)}
        # rank + rendezvous clock-sync pair: what trace_merge needs to align
        # this export with the other ranks' on one wall clock
        try:
            from .trace_merge import clock_sync

            cs = clock_sync()
            if cs:
                meta["rank"] = cs["rank"]
                meta["clock_sync"] = cs
        except Exception:
            pass
        return {"traceEvents": events, "metadata": meta}

    def kernel_summaries(self):
        """name -> EventSummary over the device events (durations in ns)."""
        table = {}
        for ev in self.device_events:
            s = table.get(ev["name"])
            if s is None:
                s = table[ev["name"]] = EventSummary(ev["name"])
            s.add(int(round(float(ev.get("dur", 0.0)) * 1e3)))
        return table

    def comm_events(self):
        return [e for e in self.host_events if e.event_type == "Communication"]


_UNIT_DIV = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}

_SORT_KEY = {
    SortedKeys.CPUTotal: lambda s: s.total_ns,
    SortedKeys.CPUAvg: lambda s: s.avg_ns,
    SortedKeys.CPUMax: lambda s: s.max_ns,
    SortedKeys.CPUMin: lambda s: s.min_ns or 0,
    SortedKeys.GPUTotal: lambda s: s.total_ns,
    SortedKeys.GPUAvg: lambda s: s.avg_ns,
    SortedKeys.GPUMax: lambda s: s.max_ns,
    SortedKeys.GPUMin: lambda s: s.min_ns or 0,
}


class CommSummary:
    """Per (op, group) communication aggregate for the DistributedView."""

    __slots__ = ("op", "group", "calls", "total_ns", "max_ns", "bytes")

    def __init__(self, op, group):
        self.op = op
        self.group = group
        self.calls = 0
        self.total_ns = 0
        self.max_ns = 0
        self.bytes = 0

    def add(self, ev):
        self.calls += 1
        self.total_ns += ev.duration_ns
        self.max_ns = max(self.max_ns, ev.duration_ns)
        args = getattr(ev, "args", None) or {}
        self.bytes += int(args.get("bytes", 0))

    @property
    def avg_ns(self):
        return self.total_ns / self.calls if self.calls else 0


def _comm_summaries(data: StatisticData):
    """Aggregate Communication spans by (op name, group label)."""
    table = {}
    for ev in data.comm_events():
        args = getattr(ev, "args", None) or {}
        key = (ev.name, str(args.get("group", "-")))
        s = table.get(key)
        if s is None:
            s = table[key] = CommSummary(*key)
        s.add(ev)
    return table


def _build_distributed_table(data: StatisticData, time_unit="ms"):
    """DistributedView parity (reference profiler_statistic.py distributed
    summary): which collective, on which group, how often, how slow, how
    many bytes."""
    rows = sorted(_comm_summaries(data).values(), key=lambda s: s.total_ns, reverse=True)
    if not rows:
        return ""
    div = _UNIT_DIV.get(time_unit, 1e6)
    name_w = max([len(r.op) for r in rows] + [24]) + 2
    grp_w = max([len(r.group) for r in rows] + [8]) + 2
    lines = []
    lines.append("-" * (name_w + grp_w + 60))
    lines.append("Distributed Summary (Communication)")
    lines.append(
        f"{'Name':<{name_w}}{'Group':<{grp_w}}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
        f"{'Avg(' + time_unit + ')':>12}{'Max(' + time_unit + ')':>12}{'Bytes':>14}"
    )
    lines.append("=" * (name_w + grp_w + 60))
    for r in rows:
        lines.append(
            f"{r.op:<{name_w}}{r.group:<{grp_w}}{r.calls:>8}{r.total_ns / div:>14.4f}"
            f"{r.avg_ns / div:>12.4f}{r.max_ns / div:>12.4f}{r.bytes:>14}"
        )
    lines.append("-" * (name_w + grp_w + 60))
    return "\n".join(lines)


def _human_bytes(n):
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0


def _build_memory_table(census, watermark=None):
    """MemoryView parity (reference profiler_statistic.py memory summary):
    live device bytes by dtype and by annotated module from the census,
    plus the process high-water mark."""
    if not census:
        return ""
    rows = sorted(
        census.get("by_dtype", {}).items(),
        key=lambda kv: kv[1]["bytes"], reverse=True,
    )
    mod_rows = sorted(
        census.get("by_module", {}).items(),
        key=lambda kv: kv[1]["bytes"], reverse=True,
    )
    name_w = max(
        [len(k) for k, _ in rows] + [len(k) for k, _ in mod_rows] + [18]
    ) + 2
    lines = []
    lines.append("-" * (name_w + 34))
    lines.append("Memory Summary (live device arrays)")
    lines.append(f"{'Dtype / Module':<{name_w}}{'Arrays':>10}{'Bytes':>14}")
    lines.append("=" * (name_w + 34))
    for dt, st in rows:
        lines.append(
            f"{dt:<{name_w}}{st['count']:>10}{_human_bytes(st['bytes']):>14}"
        )
    if mod_rows:
        lines.append("-" * (name_w + 34))
        for m, st in mod_rows:
            lines.append(
                f"{m:<{name_w}}{st['count']:>10}{_human_bytes(st['bytes']):>14}"
            )
    lines.append("=" * (name_w + 34))
    lines.append(
        f"{'TOTAL':<{name_w}}{census.get('count', 0):>10}"
        f"{_human_bytes(census.get('bytes', 0)):>14}"
    )
    if watermark and watermark.get("peak_hbm_bytes"):
        lines.append(
            f"High-water mark: {_human_bytes(watermark['peak_hbm_bytes'])} "
            f"(tag={watermark.get('peak_tag')})"
        )
    lines.append("-" * (name_w + 34))
    return "\n".join(lines)


def _build_summary_table(data: StatisticData, sorted_by=SortedKeys.CPUTotal, time_unit="ms"):
    div = _UNIT_DIV.get(time_unit, 1e6)
    rows = sorted(data.event_summaries().values(), key=_SORT_KEY[sorted_by], reverse=True)
    name_w = max([len(r.name) for r in rows] + [20]) + 2
    lines = []
    total = sum(r.total_ns for r in rows)
    lines.append("-" * (name_w + 58))
    lines.append(
        f"{'Name':<{name_w}}{'Calls':>8}{'Total(' + time_unit + ')':>14}{'Avg(' + time_unit + ')':>12}{'Max(' + time_unit + ')':>12}{'Ratio(%)':>10}"
    )
    lines.append("=" * (name_w + 58))
    for r in rows:
        ratio = 100.0 * r.total_ns / total if total else 0.0
        lines.append(
            f"{r.name:<{name_w}}{r.call:>8}{r.total_ns / div:>14.4f}{r.avg_ns / div:>12.4f}{r.max_ns / div:>12.4f}{ratio:>10.2f}"
        )
    lines.append("-" * (name_w + 58))
    if data.device_trace_dir:
        lines.append(f"Device timeline (torch.profiler): {data.device_trace_dir}")
    return "\n".join(lines)


def _build_kernel_table(data: StatisticData, sorted_by=SortedKeys.GPUTotal, time_unit="ms"):
    """KernelView: device time by kernel over the record window (the
    hand-written kernels among cuBLAS's and torch's own)."""
    rows = sorted(data.kernel_summaries().values(), key=_SORT_KEY[sorted_by], reverse=True)
    if not rows:
        return ""
    div = _UNIT_DIV.get(time_unit, 1e6)
    name_w = min(max([len(r.name) for r in rows] + [20]) + 2, 90)
    total = sum(r.total_ns for r in rows)
    lines = ["-" * (name_w + 58), "Device Summary (kernels)",
             f"{'Name':<{name_w}}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
             f"{'Avg(' + time_unit + ')':>12}{'Max(' + time_unit + ')':>12}{'Ratio(%)':>10}",
             "=" * (name_w + 58)]
    for r in rows:
        ratio = 100.0 * r.total_ns / total if total else 0.0
        lines.append(
            f"{r.name[:name_w - 2]:<{name_w}}{r.call:>8}{r.total_ns / div:>14.4f}"
            f"{r.avg_ns / div:>12.4f}{r.max_ns / div:>12.4f}{ratio:>10.2f}")
    lines.append("-" * (name_w + 58))
    return "\n".join(lines)
