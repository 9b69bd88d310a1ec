"""Port parity for the training guardian (framework/guardian.py) and the
framework monitor shim: the digest bit for bit, the chaos bit flip, the
fused check's mask and grad norm, and a tiny model trained in both
packages from one set of weights under each policy with a NaN injected
through the FaultPlan: verdicts, step records, the LKG ring, GradScaler
accounting, the crash dump's keys, and the rollback's bit-exact restore."""
import json
import warnings

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import fault_injection as jfi
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import guardian as jg
from paddle_tpu.framework import monitor as jmon

import paddle_tpu_torch as ptt
from paddle_tpu_torch.distributed.resilience import fault_injection as tfi
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import guardian as tg
from paddle_tpu_torch.framework import monitor as tmon

GUARDIAN_FLAGS = ("FLAGS_guardian_policy", "FLAGS_guardian_abs_ceiling", "FLAGS_lkg_interval",
                  "FLAGS_lkg_ring", "FLAGS_desync_interval", "FLAGS_flight_recorder_len")


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    ptt.set_device("cpu")
    # every recorder alive dumps on an abort: keep them all out of the cwd
    monkeypatch.setenv("PADDLE_TPU_CRASH_DIR", str(tmp_path / "crash"))
    yield
    for lib in (paddle, ptt):
        lib.set_flags({"FLAGS_check_nan_inf": False, "FLAGS_fused_optimizer": False})
    jfi.install_plan(None)
    tfi.install_plan(None)


DIGEST_CASES = {
    "f32": lambda r: r.randn(37).astype(np.float32),
    "bf16": lambda r: r.randn(5, 7).astype(np.float32),
    "f16": lambda r: r.randn(41).astype(np.float16),
    "f64": lambda r: (r.randn(23) * 1e30).astype(np.float64),
    "int32": lambda r: r.randint(-2 ** 31, 2 ** 31 - 1, 29).astype(np.int32),
    "f32_over_2^16": lambda r: r.randn(70001).astype(np.float32),
}


def _bf16_of(jx) -> torch.Tensor:
    """The same bf16 bits as a torch tensor (torch rounds a NaN to 0xFFFF
    where jax keeps 0x7FC0, so the bits are carried, not the values)."""
    return torch.from_numpy(np.asarray(jx).view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_digest_arrays_bit_equal_jax(case, monkeypatch):
    """digest_arrays equals the JAX package's _digest_impl bit for bit (the
    uint32 wraparound, the index mix, the f64 high-word fold, the 16-bit
    lanes); over 2^16 elements with a chunk of 4096, so the chunk offsets
    are exercised too. NaN and negative values keep their bits."""
    a = DIGEST_CASES[case](np.random.RandomState(len(case)))
    if a.dtype.kind == "f":
        a.reshape(-1)[3] = np.nan
    jx = jnp.asarray(a, jnp.bfloat16) if case == "bf16" else jnp.asarray(a)
    tx = _bf16_of(jx) if case == "bf16" else torch.from_numpy(a)
    if case == "f32_over_2^16":
        monkeypatch.setattr(tg, "_CHUNK", 4096)
        monkeypatch.setattr(tg, "_mix_cache", {})
    want = jg.digest_arrays([jx, -jx])
    got = tg.digest_arrays([tx, -tx])
    assert got.dtype == np.uint32 and got.tolist() == want.tolist()


def test_flip_one_bit_matches_jax():
    """The chaos drill flips the JAX package's byte and bit for each seed
    and salt (a bf16 and an f32 tensor), in a copy."""
    r = np.random.RandomState(0)
    a32 = r.randn(6, 5).astype(np.float32)
    for seed, salt in ((0, 1), (7, 3), (123, 2)):
        want = np.asarray(jg._flip_one_bit(jnp.asarray(a32), seed, salt))
        t = torch.from_numpy(a32.copy())
        got = tg._flip_one_bit(t, seed, salt)
        assert got.numpy().tobytes() == want.tobytes() and torch.equal(t, torch.from_numpy(a32))
        jb = jnp.asarray(a32, jnp.bfloat16)
        wb = np.asarray(jg._flip_one_bit(jb, seed, salt)).view(np.uint16)
        tb = _bf16_of(jb)
        gb = tg._flip_one_bit(tb, seed, salt).view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(gb, wb)


CHECK_CASES = {
    "clean": ([np.ones(5, np.float32)], [np.arange(4, dtype=np.float32)], 0.0),
    "nan_grad": ([np.array([1.0, np.nan], np.float32)], [np.ones(3, np.float32)], 0.0),
    "inf_other": ([np.ones(3, np.float32)], [np.array([np.inf], np.float32)], 0.0),
    "over_ceiling": ([np.array([3.0, -9.0], np.float32)], [np.ones(2, np.float32)], 5.0),
    "nan_and_over": ([np.array([np.nan, 7.0], np.float32)], [], 6.0),
    "f64_beyond_f32": ([], [np.array([1e300], np.float64)], 0.0),
    "ints_skipped": ([np.arange(3, dtype=np.int32)], [np.array([2 ** 40], np.int64)], 0.0),
    "norm_overflows": ([np.array([3e19, -3e19], np.float32)], [np.ones(2, np.float32)], 0.0),
    "norm_overflows_nan_other": ([np.array([3e19, 3e19], np.float32)],
                                 [np.array([np.nan], np.float32)], 0.0),
    "norm": ([np.random.RandomState(1).randn(50).astype(np.float32),
              np.random.RandomState(2).randn(7, 3).astype(np.float32)], [], 0.0),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_arrays_matches_jax(case):
    """The fused check's mask equals the JAX package's exactly; its grad
    norm within f32 rounding (another summation order)."""
    gs, os_, ceiling = CHECK_CASES[case]
    jm, jn = jg.check_arrays([jnp.asarray(a) for a in gs], [jnp.asarray(a) for a in os_], ceiling)
    tm, tn = tg.check_arrays([torch.from_numpy(a) for a in gs], [torch.from_numpy(a) for a in os_],
                             ceiling)
    assert tm == jm
    if np.isfinite(jn):
        np.testing.assert_allclose(tn, jn, rtol=2e-6)
    else:
        assert not np.isfinite(tn)


def test_guardian_flags_have_the_jax_defaults():
    assert tflags.get_flags(list(GUARDIAN_FLAGS)) == jflags.get_flags(list(GUARDIAN_FLAGS))


# ---------------------------------------------------------------------------
# a tiny model in both packages from one set of weights
# ---------------------------------------------------------------------------

def _weights():
    r = np.random.RandomState(0)
    return [r.randn(8, 16).astype(np.float32) * 0.3, np.zeros(16, np.float32),
            r.randn(16, 4).astype(np.float32) * 0.3, np.zeros(4, np.float32)]


def _data(i):
    r = np.random.RandomState(100 + i)
    return r.randn(6, 8).astype(np.float32), r.randn(6, 4).astype(np.float32)


class _Run:
    """One package's model, optimizer and guardian."""

    def __init__(self, lib, policy, scaler=False, crash_dir=None):
        self.lib = lib
        self.jax = lib is paddle
        lib.seed(0)
        self.l1, self.l2 = lib.nn.Linear(8, 16), lib.nn.Linear(16, 4)
        params = [self.l1.weight, self.l1.bias, self.l2.weight, self.l2.bias]
        for p, w in zip(params, _weights()):
            if self.jax:
                p.set_value(w)
            else:
                with torch.no_grad():
                    p.copy_(torch.from_numpy(w))
        self.params = params
        self.opt = lib.optimizer.AdamW(1e-2, parameters=params, weight_decay=0.01)
        self.scaler = (lib.amp.GradScaler(init_loss_scaling=2.0 ** 4, incr_every_n_steps=3,
                                          decr_every_n_nan_or_inf=1) if scaler else None)
        self.g = (jg if self.jax else tg).TrainingGuardian(
            self.opt, scaler=self.scaler, policy=policy, lkg_interval=2, lkg_ring=2,
            crash_dir=crash_dir)

    def tensor(self, a):
        return self.lib.to_tensor(a) if self.jax else torch.from_numpy(a)

    def step(self, i):
        x, y = _data(i)
        F = self.lib.nn.functional
        out = self.l2(F.tanh(self.l1(self.tensor(x))))
        loss = ((out - self.tensor(y)) ** 2).mean()
        (self.scaler.scale(loss) if self.scaler else loss).backward()
        v = self.g.step(self.scaler.scale(loss) if self.scaler else loss)
        self.opt.clear_grad()
        return v

    def param_values(self):
        if self.jax:
            return [np.asarray(p._raw()) for p in self.params]
        return [p.detach().numpy().copy() for p in self.params]


def _plan(lib_fi):
    return lib_fi.FaultPlan(seed=3).add("guardian.grad_nan", "corrupt", times=1)


def _train(lib, policy, nan_at, steps=7, scaler=False, crash_dir=None):
    run = _Run(lib, policy, scaler=scaler, crash_dir=crash_dir)
    fi = jfi if lib is paddle else tfi
    lib.set_flags({"FLAGS_check_nan_inf": True})
    verdicts, raised = [], None
    for i in range(steps):
        fi.install_plan(_plan(fi) if i == nan_at else None)
        try:
            verdicts.append(run.step(i))
        except (jg.GuardianAnomaly, tg.GuardianAnomaly) as e:
            raised = e
            break
    fi.install_plan(None)
    return run, verdicts, raised


@pytest.mark.parametrize("policy", ["skip_step", "rollback", "raise"])
def test_guardian_policies_match_jax(policy, tmp_path):
    """7 AdamW steps of a 2-layer MLP, a NaN injected into the first grad at
    step 5 (`guardian.grad_nan`), LKG every 2 steps in a ring of 2: the
    verdicts, the step records (step, loss, grad norm, lr), the anomaly
    event, the ring's snapshot steps and the parameters equal the JAX
    package's; the rollback restores the snapshot bit for bit; `raise`
    dumps a flight recorder with the JAX package's keys."""
    jrun, jv, jraised = _train(paddle, policy, 4, crash_dir=str(tmp_path / "jax"))
    trun, tv, traised = _train(ptt, policy, 4, crash_dir=str(tmp_path / "port"))
    assert tv == jv
    expect = {"skip_step": ["ok"] * 4 + ["skipped", "ok", "ok"],
              "rollback": ["ok"] * 4 + ["rolled_back", "ok", "ok"], "raise": ["ok"] * 4}[policy]
    assert tv == expect
    jrec, trec = jrun.g.recorder.records(), trun.g.recorder.records()
    assert [(r["kind"], r.get("event"), r.get("step")) for r in trec] == \
        [(r["kind"], r.get("event"), r.get("step")) for r in jrec]
    for a, b in zip(trec, jrec):
        for k in ("loss", "grad_norm", "lr"):
            if b.get(k) is not None and np.isfinite(b[k]):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    assert [s["step"] for s in trun.g.snapshots] == [s["step"] for s in jrun.g.snapshots]
    assert len(trun.g.snapshots) <= 2
    assert trun.opt._step_count == int(jrun.opt._step_count._raw())
    for a, b in zip(trun.param_values(), jrun.param_values()):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    if policy == "rollback":
        assert trun.g.rollbacks == 1 == jrun.g.rollbacks
    if policy == "raise":
        assert isinstance(traised, tg.GuardianAnomaly) and traised.kind == jraised.kind
        assert traised.dump_paths and jraised.dump_paths
        tdump = json.load(open(next(p for p in traised.dump_paths if "/port/" in p)))
        jdump = json.load(open(next(p for p in jraised.dump_paths if "/jax/" in p)))
        assert set(tdump) == set(jdump) and tdump["reason"] == jdump["reason"]
        assert [r["kind"] for r in tdump["records"]] == [r["kind"] for r in jdump["records"]]


def test_rollback_restores_every_state_bit_for_bit(tmp_path):
    """The port's rollback on the flat-bucket engine (FLAGS_fused_optimizer,
    bf16 moment2) and on the stacked path: parameters, moments, beta
    powers and @step equal the snapshot (digest and values), and the
    retried step equals the step the snapshot's state takes."""
    for fused in (True, False):
        ptt.set_flags({"FLAGS_fused_optimizer": fused, "FLAGS_check_nan_inf": True})
        run = _Run(ptt, "rollback", crash_dir=str(tmp_path))
        run.opt._m2_dtype = torch.bfloat16
        for i in range(4):
            assert run.step(i) == "ok"
        snap = run.g.snapshots[-1]
        want = tg.digest_arrays(run.g.snapshot_tensors(snap))
        hosts = {(id(h), k): v for h, k, v in snap["slots"] if not isinstance(v, torch.Tensor)}
        tfi.install_plan(tfi.FaultPlan().add("guardian.grad_nan", "corrupt"))
        assert run.step(4) == "rolled_back"
        tfi.install_plan(None)
        assert tg.digest_arrays(run.g.state_tensors()).tolist() == want.tolist()
        for (h, k, v) in run.g._slots():
            if (id(h), k) in hosts:
                assert h[k] == hosts[(id(h), k)]
        assert run.opt._step_count == snap["step"] == 4
        assert all(p.grad is None for p in run.params)
        assert run.opt._fused_state_entries()
        ptt.set_flags({"FLAGS_fused_optimizer": False})


def test_gradscaler_skip_accounting_matches_jax(tmp_path):
    """skip_step under a GradScaler (2^4, decr every 1 bad step, incr every
    3 good ones): the skipped step counts as a bad step in both packages,
    so the scale and the step counters agree after the run."""
    jrun, jv, _ = _train(paddle, "skip_step", 3, steps=7, scaler=True,
                            crash_dir=str(tmp_path))
    trun, tv, _ = _train(ptt, "skip_step", 3, steps=7, scaler=True, crash_dir=str(tmp_path))
    assert tv == jv and tv.count("skipped") == 1
    want = {k: float(np.asarray(v._raw() if hasattr(v, "_raw") else v))
            for k, v in jrun.scaler.state_dict().items()}
    got = {k: float(v) for k, v in trun.scaler.state_dict().items()}
    assert got == want


def test_desync_detector_single_rank_and_the_wait_for_distributed():
    """One rank has nothing to compare (None, as in the JAX package); the
    local digest's parameter units equal the JAX package's digests of the
    same weights; a group of two ranks raises naming Queue A item 5."""
    run = _Run(ptt, "raise")
    jrun = _Run(paddle, "raise")
    assert run.g.check_desync() is None and jrun.g.check_desync() is None
    names, vec = run.g.detector.local_digest()
    jnames, jvec = jrun.g.detector.local_digest()
    assert names[-2:] == jnames[-2:] == ["rng_state", "step_count"]
    assert vec[:4].tolist() == jvec[:4].tolist() and len(vec) == len(jvec)

    class _Group:
        nranks = 2

    with pytest.raises(NotImplementedError, match="item 5"):
        tg.DesyncDetector(run.opt, group=_Group()).check()


def test_guardian_under_capture_runs_a_plain_step():
    """Inside a static capture's dry run the guardian runs a plain step with
    one warning and checks no placeholder."""
    from paddle_tpu_torch import static

    run = _Run(ptt, "raise")
    ptt.set_flags({"FLAGS_check_nan_inf": True})
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [6, 8], "float32")
        loss = (run.l2(ptt.nn.functional.tanh(run.l1(x))) ** 2).mean()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert run.g.step(loss) == "ok"
            assert run.g.step(loss) == "ok"
        assert sum("static capture" in str(m.message) for m in w) == 1


def test_check_compiled_state_raises_with_a_dump(tmp_path):
    rec = tg.FlightRecorder(name="static", crash_dir=str(tmp_path))
    tg.check_compiled_state([torch.ones(3)], origin="static_executor")
    with pytest.raises(tg.GuardianAnomaly, match="static_executor") as e:
        tg.check_compiled_state([torch.tensor([1.0, float("inf")])], origin="static_executor")
    dump = json.load(open(next(p for p in e.value.dump_paths if str(tmp_path) in p)))
    assert dump["records"][-1]["event"] == "compiled_state_anomaly" and rec.records()


def test_monitor_counters_match_jax():
    """The monitor shim: add (with a decrement), set_gauge on a counter's
    name, get of an unknown name, snapshot and reset, the same in both."""
    out = []
    for mon in (jmon, tmon):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mon.reset()
            mon.add("guardian_test_steps", 3)
            mon.add("guardian_test_steps", -1)
            mon.set_gauge("guardian_test_steps", 7.5)
            mon.set_gauge("guardian_test_mem", 2)
            res = [mon.get("guardian_test_steps"), mon.get("guardian_test_mem"),
                   mon.get("guardian_test_never"), mon.snapshot()]
            mon.reset("guardian_test_mem")
            res.append(mon.snapshot())
            mon.reset()
            res.append(mon.snapshot())
        out.append(res)
    assert out[0] == out[1]
