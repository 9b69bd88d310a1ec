"""Port parity for the profiler (profiler/): make_scheduler's states, the
Profiler's record windows and exported host spans, the summary and
distributed tables, trace_merge over the same traces, roofline under one
pinned peak table, perf_report against the JAX package's schema check,
the benchmark timer, FLOP counting and the optimizer's span."""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

from paddle_tpu.profiler import perf_attribution as jpa
from paddle_tpu.profiler import profiler as jprof
from paddle_tpu.profiler import profiler_statistic as jstat
from paddle_tpu.profiler import trace_merge as jtm
from paddle_tpu.profiler import utils as jutils

import paddle_tpu_torch as ptt
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.profiler import perf_attribution as tpa
from paddle_tpu_torch.profiler import profiler as tprof
from paddle_tpu_torch.profiler import profiler_statistic as tstat
from paddle_tpu_torch.profiler import timer as ttimer
from paddle_tpu_torch.profiler import trace_merge as ttm
from paddle_tpu_torch.profiler import utils as tutils


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


SCHEDULES = [dict(closed=1, ready=1, record=2), dict(closed=0, ready=2, record=1, repeat=2),
             dict(closed=2, ready=0, record=3, repeat=1, skip_first=3)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=["cycle", "repeat2", "skip3"])
def test_make_scheduler_states_match_jax(kw):
    got = [tprof.make_scheduler(**kw)(s).name for s in range(20)]
    assert got == [jprof.make_scheduler(**kw)(s).name for s in range(20)]
    for bad in (dict(kw, record=0), dict(kw, closed=-1)):
        with pytest.raises(ValueError):
            tprof.make_scheduler(**bad)
        with pytest.raises(ValueError):
            jprof.make_scheduler(**bad)


def _loop(mod, sched, steps, tmp):
    """A profiled loop through one package: spans a step, a callback per
    window that keeps the window's host-event names and exports it."""
    windows = []

    def ready(prof):
        windows.append((prof.step_num, sorted({e.name for e in prof.profiler_result.host_events})))
        prof.export(os.path.join(tmp, f"w{prof.step_num}.json"))

    with mod.Profiler(targets=[mod.ProfilerTarget.CPU], scheduler=sched,
                      on_trace_ready=ready) as p:
        for i in range(steps):
            with mod.RecordEvent(f"forward#{i % 2}"):
                pass
            p.step()
    return windows


@pytest.mark.parametrize("sched", [(2, 5), "make"], ids=["tuple", "make_scheduler"])
def test_profiler_windows_match_jax(sched, tmp_path):
    """The same loop under the same schedule closes the same record windows
    (step numbers) holding the same spans (ProfileStep#n and the user's)
    in both packages; each export loads back as a chrome trace."""
    mk = (lambda m: m.make_scheduler(closed=1, ready=1, record=2, repeat=2)) \
        if sched == "make" else (lambda m: sched)
    got = _loop(tprofiler, mk(tprof), 10, str(tmp_path / "t"))
    want = _loop(__import__("paddle_tpu").profiler, mk(jprof), 10, str(tmp_path / "j"))
    assert got == want and got
    doc = tprof.load_profiler_result(str(tmp_path / "t" / f"w{got[0][0]}.json"))
    assert {e["ph"] for e in doc["traceEvents"]} == {"X"} and doc["metadata"]["device_events"] == 0


def _events(mod):
    HE = mod.HostEvent
    return [HE("matmul", "Operator", 0, 2_000_000, 1),
            HE("matmul", "Operator", 3_000_000, 4_500_000, 1),
            HE("all_reduce", "Communication", 5_000_000, 9_000_000, 2,
               {"group": "dp", "bytes": 4096}),
            HE("all_reduce", "Communication", 9_500_000, 10_000_000, 2,
               {"group": "dp", "bytes": 4096}),
            HE("Optimizer.step#AdamW", "Optimization", 10_000_000, 12_000_000, 1)]


def test_summary_tables_match_jax():
    """The operator, distributed and memory tables over the same events and
    census print the JAX package's text; the chrome trace's events too."""
    tdata, jdata = tstat.StatisticData(_events(tutils)), jstat.StatisticData(_events(jutils))
    for key in ("CPUTotal", "CPUAvg", "CPUMax", "CPUMin"):
        assert tstat._build_summary_table(tdata, getattr(tstat.SortedKeys, key)) == \
            jstat._build_summary_table(jdata, getattr(jstat.SortedKeys, key))
    assert tstat._build_distributed_table(tdata, "us") == jstat._build_distributed_table(jdata,
                                                                                          "us")
    census = {"count": 3, "bytes": 5 << 20,
              "by_dtype": {"float32": {"count": 2, "bytes": 4 << 20},
                           "bfloat16": {"count": 1, "bytes": 1 << 20}},
              "by_module": {"model": {"count": 2, "bytes": 3 << 20}}}
    wm = {"peak_hbm_bytes": 6 << 20, "peak_tag": "optimizer_step"}
    assert tstat._build_memory_table(census, wm) == jstat._build_memory_table(census, wm)
    assert tdata.to_chrome_trace()["traceEvents"] == jdata.to_chrome_trace()["traceEvents"]


def _trace(rank, base_ns, sync=True, n=3):
    evs = [{"name": f"op{i}", "cat": "Operator", "ph": "X", "ts": base_ns / 1e3 + 10.0 * i,
            "dur": 5.0, "pid": 0, "tid": 7} for i in range(n)]
    evs.append({"name": "all_reduce", "cat": "Communication", "ph": "X",
                "ts": base_ns / 1e3 + 50.0, "dur": 20.0, "pid": 0, "tid": 7,
                "args": {"group": "g", "bytes": 64}})
    meta = {"rank": rank, "device_trace_dir": f"/d{rank}"}
    if sync:
        meta["clock_sync"] = {"rank": rank, "world_size": 2, "perf_ns": base_ns,
                              "unix_ns": 1_700_000_000_000_000_000 + rank * 1000}
    return {"traceEvents": evs, "metadata": meta}


def test_trace_merge_matches_jax(tmp_path, capsys):
    """merge_traces (clock-synced and best effort), the request and
    timeline lanes, and the merged DistributedView: equal to the JAX
    package's on the same input traces; the CLI writes the same file."""
    for sync in (True, False):
        traces = [_trace(1, 5_000_000, sync), _trace(0, 9_000_000, True)]
        got, want = ttm.merge_traces(traces), jtm.merge_traces(traces)
        assert got == want
    req = {"traceEvents": [{"name": "prefill", "ph": "X", "ts": 1.0, "dur": 2.0,
                            "pid": ttm_pid(), "tid": 0}],
           "metadata": {"clock_sync": {"perf_ns": 0, "unix_ns": 1_700_000_000_000_000_000}}}
    tl = {"traceEvents": [{"name": "fault", "ph": "i", "ts": 3.0, "pid": 90010, "tid": 0}]}
    got = ttm.merge_timeline_lane(ttm.merge_request_lanes(ttm.merge_traces(traces), req), tl)
    want = jtm.merge_timeline_lane(jtm.merge_request_lanes(jtm.merge_traces(traces), req), tl)
    assert got == want and got["metadata"]["request_lane_count"] == 1
    from paddle_tpu.profiler import profiler_statistic as js

    assert tstat._build_distributed_table(ttm.to_statistic_data(got)) == \
        js._build_distributed_table(jtm.to_statistic_data(want))
    paths = []
    for i, tr in enumerate(traces):
        paths.append(str(tmp_path / f"r{i}.json"))
        json.dump(tr, open(paths[-1], "w"))
    outs = []
    for main, name in ((ttm.main, "t"), (jtm.main, "j")):
        assert main(paths + ["-o", str(tmp_path / f"{name}.json"), "--summary"]) == 0
        outs.append(json.load(open(tmp_path / f"{name}.json")))
    assert outs[0] == outs[1]
    prev = ttm._clock_sync[0]
    try:
        assert ttm.note_rendezvous(3, 4)["rank"] == 3 and ttm.clock_sync()["world_size"] == 4
    finally:
        ttm._clock_sync[0] = prev
    with pytest.raises(ValueError, match="duplicate"):
        ttm.merge_traces([_trace(0, 1), _trace(0, 2)])


def ttm_pid():
    from paddle_tpu_torch.telemetry.request_trace import REQUEST_PID_BASE

    return REQUEST_PID_BASE + 1


def test_roofline_and_peak_table_match_jax():
    """roofline under one pinned table equals the JAX package's dict; the
    port's own table holds the H100 (dense bf16, HBM3) and the CPU
    fallback, and no TPU entry."""
    table = {"card a": {"flops_per_s": 1e15, "bytes_per_s": 2e12},
             "cpu": {"flops_per_s": 1e11, "bytes_per_s": 5e10}}
    for plat in ("card a", "Card A big", "cpu", "nothing"):
        for args in ((1e12, 1e9, 0.01), (5e9, 8e10, 0.3)):
            assert tpa.roofline(*args, platform=plat, peak_table=table) == \
                jpa.roofline(*args, platform=plat, peak_table=table)
    with pytest.raises(ValueError):
        tpa.roofline(1, 1, 0.0)
    assert tpa.peak_for("nvidia h100 80gb hbm3")[1] == {"flops_per_s": 989e12,
                                                        "bytes_per_s": 3.35e12}
    assert not any("tpu" in k for k in tpa.DEFAULT_PEAK_TABLE)


def test_perf_report_passes_both_schema_checks():
    """perf_report() validates under the port's and the JAX package's
    validate_report, with a program record, a census that sees a live
    tensor of an annotated module, and the input pipeline of a
    streaming-fed run: its verdict is one of starved/input_limited/compute
    and its waits are the loader's."""
    from paddle_tpu_torch.io import Dataset
    from paddle_tpu_torch.io.streaming import StreamingLoader
    from paddle_tpu_torch.io.streaming import stats as tstats

    class Rows(Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            return np.full((4,), i, np.float32), np.int64(i)

    tpa.reset()
    tstats.reset()
    for x, y in StreamingLoader(Rows(), 4, prefetch_depth=2):
        tstats.take_step_wait()
        assert x.shape == (4, 4)
    keep = ptt.nn.Linear(64, 32)
    tpa.annotate_module("probe", keep)
    tpa.record_compiled("static_executor", "replay[1ops,1feeds]", flops=128.0,
                        compile_seconds=0.01)
    tpa.sample_watermark(tag="test", force=True)
    rep = tpa.perf_report()
    assert tpa.validate_report(rep) is rep and jpa.validate_report(json.loads(json.dumps(rep)))
    pipe = rep["input_pipeline"]
    assert pipe["verdict"] in ("starved", "input_limited", "compute"), pipe
    assert pipe["batches_total"] == 4 and pipe["samples_total"] == 16 and pipe["steps"] == 3
    assert rep["live_arrays"]["by_module"]["probe"]["bytes"] == (64 * 32 + 32) * 4
    assert rep["programs"][-1]["flops"] == 128.0
    crash = tpa.snapshot_for_crash()
    assert set(crash) == set(jpa.snapshot_for_crash()) and crash["programs"][-1]["flops"] == 128.0
    with pytest.raises(ValueError):
        tpa.validate_report({k: v for k, v in rep.items() if k != "programs"})


def test_counting_flops_and_the_optimizer_span():
    """counting_flops counts a Linear's forward and backward (2MNK each for
    y, dX and dW) and what a kernel adds through ops.launches; the
    optimizer's step runs inside an `Optimizer.step#AdamW` span."""
    from paddle_tpu_torch.ops import attention, launches

    lin = ptt.nn.Linear(16, 8)
    x = torch.randn(4, 16, requires_grad=True)
    with tpa.counting_flops() as c:
        lin(x).sum().backward()
        launches.count_flops(attention.flash_flops(1, 128, 128, 2, 64, causal=True))
    assert c.dispatched == 3 * 2 * 4 * 16 * 8
    assert c.kernels == 4 * 2 * 64 * (128 * 129 // 2) and c.total == c.dispatched + c.kernels
    assert launches.FLOP_TALLY[0] is None
    opt = ptt.optimizer.AdamW(1e-3, parameters=lin.parameters())
    with tprof.Profiler(targets=[tprof.ProfilerTarget.CPU]) as p:
        opt.step()
    names = [e.name for e in p.profiler_result.host_events]
    assert "Optimizer.step#AdamW" in names


def test_benchmark_costs_and_ips(monkeypatch):
    """benchmark(): warm-up steps skipped, reader cost, batch cost and ips
    from the clock, as the JAX package's timer computes them."""
    clock = iter(np.arange(0.0, 100.0, 0.5))
    monkeypatch.setattr(ttimer.time, "perf_counter", lambda: float(next(clock)))
    b = ttimer.Benchmark()
    for s in (b.reader_cost, b.batch_cost, b.ips_stat):
        s.skip_n = 1
    b.begin()
    for _ in range(3):
        b.before_reader()
        b.after_reader()
        b.step(num_samples=8)
    assert b.reader_cost.avg == 0.5 and b.batch_cost.avg == 1.5
    assert b.ips_stat.avg == pytest.approx(8 / 1.5)
    assert "ips: 5.33333 samples/sec" in b.step_info()
    assert tprofiler.benchmark() is ttimer.benchmark()


def test_summary_prints_views():
    with tprof.Profiler(targets=[tprof.ProfilerTarget.CPU]) as p:
        with tutils.RecordEvent("fwd"):
            pass
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        p.summary(views=tprof.SummaryView.OperatorView)
        p.summary(views=[tprof.SummaryView.MemoryView])
    text = out.getvalue()
    assert "fwd" in text and "Memory Summary" in text
