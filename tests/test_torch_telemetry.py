"""Port parity for telemetry (metrics registry, exporters, request traces,
the incident timeline) and the resilience primitives (FaultPlan, retry):
the same operations and records through the JAX package and
paddle_tpu_torch. Exports must be equal byte for byte, analyses and
decision sequences equal; all of it is host Python on the same inputs."""
import contextlib
import io
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import fault_injection as jfi
from paddle_tpu.distributed.resilience import retry as jretry
from paddle_tpu.telemetry import exporters as jexp
from paddle_tpu.telemetry import metrics as jm
from paddle_tpu.telemetry import request_trace as jrt
from paddle_tpu.telemetry import timeline as jtl

import paddle_tpu_torch as ptt
from paddle_tpu_torch.distributed.resilience import fault_injection as tfi
from paddle_tpu_torch.distributed.resilience import retry as tretry
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import engine as teng
from paddle_tpu_torch.inference import scheduler as tsch
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.telemetry import exporters as texp
from paddle_tpu_torch.telemetry import metrics as tm
from paddle_tpu_torch.telemetry import request_trace as trt
from paddle_tpu_torch.telemetry import timeline as ttl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# metrics registry and exporters
# ---------------------------------------------------------------------------

def _fill(mod, nan=False):
    """One fixed sequence of registry operations."""
    reg = mod.Registry()
    c = reg.counter("paddle_tpu_x_total", "a counter", ("event", "reason"))
    c.labels(event="shed", reason="rate_limit").inc()
    c.labels(event="shed", reason='quo"te\\back\nslash').inc(3)
    c.labels(event="completed", reason="").inc(2.5)
    reg.counter("paddle_tpu_plain_total").inc(7)
    g = reg.gauge("paddle_tpu_g", "a gauge", ("state",))
    g.labels(state="used").set(3)
    g.labels(state="free").set(0.1)
    g.labels(state="free").inc(0.2)
    g.labels(state="free").dec(0.05)
    if nan:  # non-finite samples: only the lenient mode writes them
        reg.gauge("paddle_tpu_inf").set(float("inf"))
        reg.gauge("paddle_tpu_nan").set(float("nan"))
    h = reg.histogram("paddle_tpu_h_seconds", "a histogram", ("replica",),
                      buckets=(0.5, 0.001, 0.01, 1.0))
    for i, v in enumerate([0.0005, 0.002, 0.3, 0.7, 5.0, 0.01, 1e-9]):
        h.labels(replica=str(i % 2)).observe(v)
    reg.histogram("paddle_tpu_default_seconds").observe(0.003)
    return reg


def test_prometheus_and_json_lines_equal_byte_for_byte():
    jreg, treg = _fill(jm), _fill(tm)
    assert texp.to_prometheus(treg) == jexp.to_prometheus(jreg)
    assert texp.to_json_lines(treg) == jexp.to_json_lines(jreg)
    assert texp.parse_prometheus(texp.to_prometheus(treg)) == \
        jexp.parse_prometheus(jexp.to_prometheus(jreg))
    assert texp.to_prometheus(_fill(tm, nan=True)) == jexp.to_prometheus(_fill(jm, nan=True))
    assert texp.validate_snapshot(texp.to_json_lines(treg)) == \
        jexp.validate_snapshot(jexp.to_json_lines(jreg)) == len(treg.collect())
    assert treg.collect() == jreg.collect()
    # the lenient crash-path mode skips a NaN gauge and says so, identically
    jreg, treg = _fill(jm, nan=True), _fill(tm, nan=True)
    with pytest.raises(ValueError):
        texp.to_json_lines(treg)
    assert texp.to_json_lines(treg, strict=False) == jexp.to_json_lines(jreg, strict=False)


def test_registry_schema_errors_match():
    for mod in (jm, tm):
        reg = mod.Registry()
        reg.counter("paddle_tpu_a", "", ("x",))
        with pytest.raises(TypeError):
            reg.gauge("paddle_tpu_a")
        with pytest.raises(ValueError, match="labels"):
            reg.counter("paddle_tpu_a", "", ("y",))
        with pytest.raises(ValueError):
            reg.counter("paddle_tpu_a", "", ("x",)).labels(y="1")
        with pytest.raises(ValueError):
            reg.counter("paddle_tpu_a", "", ("x",)).labels(x="1").inc(-1)
        reg.histogram("paddle_tpu_h", buckets=(1.0,))
        with pytest.raises(ValueError, match="buckets"):
            reg.histogram("paddle_tpu_h", buckets=(2.0,))


def test_dump_snapshot_files_equal(tmp_path):
    for fmt in ("jsonl", "prometheus"):
        a = jexp.dump_snapshot(str(tmp_path / f"j.{fmt}"), _fill(jm), fmt=fmt)
        b = texp.dump_snapshot(str(tmp_path / f"t.{fmt}"), _fill(tm), fmt=fmt)
        assert open(a).read() == open(b).read()


def test_telemetry_gate_follows_the_flag():
    """The cached gate (watch_flag) keeps its name and default (on)."""
    assert tflags.get_flags("PADDLE_TPU_TELEMETRY") == {"PADDLE_TPU_TELEMETRY": True}
    fired = []
    tflags.define_flag("FLAGS_test_watch_only", 0, "")
    tflags.watch_flag("FLAGS_test_watch_only", fired.append)
    tflags.set_flags({"FLAGS_test_watch_only": 3})
    assert fired == [3]
    with pytest.raises(KeyError):
        tflags.set_flags({"FLAGS_test_watch_only": 4, "FLAGS_no_such": 1})
    assert fired == [3]  # all or nothing: no watcher fired for a refused call
    try:
        ptt.telemetry.disable()
        assert not tm.enabled()
        before = tm.default_registry().collect()
        ptt.set_device("cpu")
        ptt.seed(0)
        eng = teng.InferenceEngine(tllama.llama_tiny(num_key_value_heads=2).eval(),
                                   max_seq_len=32, block_size=8, max_batch=2)
        eng.generate([[1, 2, 3]], max_new_tokens=2)
        assert tm.default_registry().collect() == before  # nothing published when off
    finally:
        ptt.telemetry.enable()
    assert tm.enabled()


# ---------------------------------------------------------------------------
# request traces
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trace_records():
    """Records of a traced port run with preemption, a prefix hit, a TTL
    expiry and a cancel, on an injected clock."""
    ptt.set_device("cpu")
    ptt.seed(0)
    model = tllama.llama_tiny(num_key_value_heads=2).eval()
    eng = teng.InferenceEngine(model, max_seq_len=64, block_size=8, max_batch=2, num_blocks=7)
    t = [0.0]

    def clock():
        t[0] += 0.002
        return t[0]
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, 1024, (16,)).tolist()
    trt.reset()
    ptt.set_flags({"FLAGS_request_trace": True})
    try:
        sched = tsch.ContinuousBatchingScheduler(eng, clock=clock)
        reqs = [tsch.Request(rid=i, prompt=prefix + rng.randint(0, 1024, (5 + i,)).tolist(),
                             max_new_tokens=16, deadline_s=(0.02 if i == 3 else None))
                for i in range(5)]
        for r in reqs:
            sched.submit(r)
        for i in range(200):
            if sched.idle():
                break
            if i == 3:
                sched.cancel(4)
            sched.step()
        trt.record_span("fleet", "swap_drain", 0.01, 0.05, replica=0)
    finally:
        ptt.set_flags({"FLAGS_request_trace": False})
    recs = [dict(r) for r in trt.recorder().records()]
    assert {r.outcome for r in reqs} == {"completed", "expired", "cancelled"}
    assert sched.preempted_total > 0 and any(r.cached_tokens for r in reqs)
    return recs


def test_request_trace_analysis_matches_jax(trace_records, tmp_path):
    assert trt.analyze(trace_records) == jrt.analyze(trace_records)
    for kw in ({}, dict(slo_ttft_ms=10.0, slo_tpot_ms=3.0, slo_target=0.9)):
        got = trt.slo_breakdown(records=trace_records, rec=trt.RequestTraceRecorder(), **kw)
        want = jrt.slo_breakdown(records=trace_records, rec=jrt.RequestTraceRecorder(), **kw)
        assert got == want and got["n_traced"] == 5
    # exports of a recorder holding the same records
    recs = []
    for mod in (trt, jrt):
        rec = mod.RequestTraceRecorder()
        for r in trace_records:
            rec._append(dict(r), r.get("t1", r.get("t", 0.0)))
        recs.append(rec)
    # the clock-sync pair pairs the first record with the wall clock of its append
    for rec in recs:
        rec._clock_sync["unix_ns"] = 0
    assert trt.to_chrome_trace(recs[0]) == jrt.to_chrome_trace(recs[1])
    assert trt.to_json_lines(recs[0]) == jrt.to_json_lines(recs[1])
    path = trt.dump_json_lines(str(tmp_path / "events.jsonl"), recs[0])
    assert trt.load_json_lines(path, with_header=True) == jrt.load_json_lines(path, with_header=True)
    outs = []
    for mod in (trt, jrt):
        for args in (["report", path], ["report", path, "--slo-ttft-ms", "10", "--json"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert mod.main(args) == 0
            outs.append(buf.getvalue())
    assert outs[:2] == outs[2:] and outs[0]


# ---------------------------------------------------------------------------
# the incident timeline
# ---------------------------------------------------------------------------

def _emit_incident(tl):
    """A fixed incident: injections, observations, a fatal, a NaN payload."""
    tl.emit("resilience", "fault.injected", severity="error",
            labels={"site": "fleet.replica_step.1", "action": "fail"}, seed=0)
    tl.emit("fleet", "replica.failure", severity="error",
            labels={"site": "fleet.replica_step.1"}, replica=1, reason="step")
    tl.emit("resilience", "fault.injected", severity="error",
            labels={"site": "fleet.kv_migrate.0.1", "action": "fail"}, seed=0)
    tl.emit("qos", "brownout", severity="warn", direction="up", step=1, rung="spec_off",
            pressure=float("nan"))
    tl.emit("resilience", "fault.injected", severity="error",
            labels={"site": "store.set", "action": "fail"}, seed=3)
    tl.emit("fleet", "no_healthy_replica", severity="fatal", held=2)
    tl.emit("scheduler", "request.finish", severity="bogus", rid=1, outcome="completed")


def test_timeline_records_and_triage_match_jax(tmp_path):
    got = []
    for mod, flags in ((ttl, ptt), (jtl, paddle)):
        prev = mod.recorder()
        mod.set_recorder(mod.TimelineRecorder(capacity=16))
        flags.set_flags({"FLAGS_incident_timeline": True})
        try:
            mod.emit("x", "dropped-when-off-is-not-tested-here")
            mod.reset()
            _emit_incident(mod)
            got.append((mod.recorder().records(), mod.tail(3), mod.dropped()))
        finally:
            flags.set_flags({"FLAGS_incident_timeline": False})
            mod.set_recorder(prev)
    strip = lambda recs: json.dumps([{k: v for k, v in r.items() if not k.startswith("t_")}  # noqa: E731
                                     for r in recs], sort_keys=True)  # NaN == NaN as text
    assert strip(got[0][0]) == strip(got[1][0])
    assert strip(got[0][1]) == strip(got[1][1]) and got[0][2] == got[1][2] == 0
    recs = got[0][0]
    cov = ttl.chaos_coverage(recs)
    assert cov == jtl.chaos_coverage(recs) and cov["unobserved_faults"] == 2
    for kw in ({}, dict(window=(recs[1]["t_perf"], recs[5]["t_perf"]), clock="perf", top=3)):
        assert ttl.triage(recs, **kw) == jtl.triage(recs, **kw)
    # a small ring counts its evictions
    small = ttl.TimelineRecorder(capacity=16)
    for i in range(20):
        small.emit("fleet", "tick", payload={"i": i})
    assert small.dropped == 4 and len(small.records()) == 16
    # exports and the report CLI on one log
    rec = ttl.TimelineRecorder()
    for r in recs:
        rec.emit(r["source"], r["kind"], r["severity"], r["labels"], r["payload"])
    path = ttl.dump_json_lines(str(tmp_path / "tl.jsonl"), rec)
    outs = []
    for mod in (ttl, jtl):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main(["report", path, "--json"]) == 0
        outs.append(json.loads(buf.getvalue()))
        assert mod.load_json_lines(path) == ttl.load_json_lines(path)
    assert outs[0] == outs[1] and outs[0]["chaos_coverage"]["unobserved_faults"] == 2
    assert ttl.to_chrome_trace(rec) == jtl.to_chrome_trace(rec)


# ---------------------------------------------------------------------------
# fault injection and retry
# ---------------------------------------------------------------------------

SPECS = [
    "store.connect=fail*2;ckpt.write_shard=corrupt;fleet.replica_step.*=fail*3:0.5",
    '[{"site":"fleet.kv_migrate.*","action":"fail","times":2},'
    '{"site":"fleet.route","action":"delay","times":1,"arg":0.001},'
    '{"site":"guardian.*","action":"corrupt","times":null,"arg":4}]',
    "a=fail*inf;b=delay:0.0005;c",
]
SITES = ["store.connect", "fleet.replica_step.0", "fleet.route", "fleet.kv_migrate.0.1",
         "fleet.replica_step.1", "a", "b", "c", "ckpt.write_shard", "guardian.grad_nan"]


def _fire_sequence(fi, spec):
    plan = fi.plan_from_spec(spec, seed=7)
    out = [plan.describe()]
    prev = fi.install_plan(plan)
    try:
        rng = random.Random(1)
        for _ in range(40):
            site = rng.choice(SITES)
            try:
                fi.fault_point(site, rid=1)
                got = "ok"
            except fi.FaultInjected as e:
                got = ("raised", e.site, e.remaining, str(e))
            cv = fi.corrupt_value(site)
            out.append((site, got, None if cv is None else (cv.site, cv.action, cv.arg, cv.fired)))
        out.append((plan.describe(), sorted(plan.triggered.items())))
    finally:
        fi.install_plan(prev)
    return out


@pytest.mark.parametrize("spec", SPECS, ids=["compact", "json", "forever_and_bare"])
def test_fault_plan_fire_sequences_match_jax(spec):
    assert _fire_sequence(tfi, spec) == _fire_sequence(jfi, spec)


def test_corrupt_file_flips_the_same_bytes(tmp_path):
    data = bytes(range(256)) * 8
    outs = []
    for name, fi in (("t", tfi), ("j", jfi)):
        path = tmp_path / name
        path.write_bytes(data)
        prev = fi.install_plan(fi.FaultPlan(seed=11).add("ckpt.*", "corrupt", times=2, arg=5))
        try:
            assert fi.corrupt_file("ckpt.write_shard", str(path))
            assert fi.corrupt_file("ckpt.write_shard", str(path))
            assert not fi.corrupt_file("ckpt.write_shard", str(path))
        finally:
            fi.install_plan(prev)
        outs.append(path.read_bytes())
    assert outs[0] == outs[1] != data


def test_fault_plan_from_env_in_a_fresh_process():
    code = ("from paddle_tpu_torch.distributed.resilience import fault_injection as fi\n"
            "p = fi.current_plan(); print(p.describe(), p.seed)\n")
    env = dict(os.environ, PYTHONPATH=REPO, PADDLE_TPU_FAULT_PLAN="fleet.route=fail*2",
               PADDLE_TPU_FAULT_SEED="9")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "fleet.route=fail*2(fired=0) 9"


def _retry_run(retry, fails, **kw):
    sleeps = []
    pol = retry.RetryPolicy(sleep=sleeps.append, rng=random.Random(4), **kw)
    calls = [0]

    def fn(x):
        calls[0] += 1
        if calls[0] <= fails:
            raise ConnectionError(f"flap {calls[0]}")
        return x * 2
    try:
        out = pol.call(fn, 21, site="store.connect")
    except retry.RetryError as e:
        out = ("gave up", e.attempts, e.site, type(e.last).__name__, str(e.last))
    return out, sleeps, calls[0]


@pytest.mark.parametrize("fails,kw", [(0, {}), (3, {}), (9, {}), (9, dict(max_attempts=3)),
                                      (2, dict(base_s=1.0, max_backoff_s=1.5))],
                         ids=["first_try", "three_flaps", "exhausted", "attempt_cap", "cap"])
def test_retry_delays_match_jax(fails, kw):
    assert _retry_run(tretry, fails, **kw) == _retry_run(jretry, fails, **kw)
    a = [tretry.backoff_delay(i, 0.05, 2.0, random.Random(i)) for i in range(8)]
    assert a == [jretry.backoff_delay(i, 0.05, 2.0, random.Random(i)) for i in range(8)]
    assert vars(tretry.default_store_policy(max_attempts=2)).keys() == \
        vars(jretry.default_store_policy(max_attempts=2)).keys()
