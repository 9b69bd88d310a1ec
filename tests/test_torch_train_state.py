"""Port parity for the training state: the optimizer's state_dict and
set_state_dict in the JAX package's format on the per-tensor, stacked and
flat (FLAGS_fused_optimizer) paths, loading before the first step,
checkpoints that cross between the two packages through paddle.save and
paddle.load, bf16 state without ml_dtypes, and param groups with
ParamAttr's lr scale, regularizer and need_clip against the JAX package."""
import builtins
import os
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.regularizer as jregularizer
from paddle_tpu import nn as jnn

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import io as tio

SHAPES = [(4, 3), (3,), (4, 3), (3,), (5,)]  # two stacked shape groups and a lone param
SEEDS = [(0x2545F491 * (i + 7)) & 0xFFFFFFFF for i in range(256)]


@pytest.fixture(autouse=True)
def _reset():
    ptt.set_device("cpu")
    yield
    paddle.set_flags({"FLAGS_fused_optimizer": False})
    ptt.set_flags({"FLAGS_fused_optimizer": False})


def _np(x):
    """A JAX package Tensor, torch tensor or number as numpy (bf16 widened)."""
    if hasattr(x, "_value"):
        return np.asarray(x._value.astype(jnp.float32) if x._value.dtype == jnp.bfloat16
                          else x._value)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _dtype(x) -> str:
    v = x._value if hasattr(x, "_value") else x
    return str(v.dtype).replace("torch.", "")


class _Run:
    """One package's params (SHAPES, from seed 0), a loss sum(c * p * p)
    and an optimizer whose stochastic-rounding seeds come from SEEDS."""

    def __init__(self, pkg, opt_name="adamw", fused=False, m2="bfloat16", sched=False):
        self.pkg = pkg
        rng = np.random.RandomState(0)
        init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
        coef = [rng.rand(*s).astype(np.float32) + 0.5 for s in SHAPES]
        self.drawn = 0
        lib = paddle if pkg == "jax" else ptt
        lib.set_flags({"FLAGS_fused_optimizer": fused})
        if pkg == "jax":
            self.ps = [jnn.Parameter(a.copy()) for a in init]
            self.cs = [paddle.to_tensor(c) for c in coef]
        else:
            self.ps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
            self.cs = [torch.from_numpy(c) for c in coef]
        lr = lib.optimizer.lr.CosineAnnealingDecay(0.02, T_max=8) if sched else 0.02
        if opt_name == "adamw":
            self.opt = lib.optimizer.AdamW(lr, parameters=self.ps, weight_decay=0.05,
                                           moment2_dtype=m2)
            self.opt._m2_key = ((lambda: jnp.uint32(self._key())) if pkg == "jax"
                                else self._key)
        else:
            self.opt = lib.optimizer.Momentum(lr, momentum=0.9, parameters=self.ps,
                                              weight_decay=0.01)

    def _key(self):
        self.drawn += 1
        return SEEDS[self.drawn - 1]

    def steps(self, n):
        for _ in range(n):
            sum((c * p * p).sum() for c, p in zip(self.cs, self.ps)).backward()
            self.opt.step()
            self.opt.clear_grad()
            sched = self.opt._lr_scheduler
            if sched is not None:
                sched.step()
        return [np.array(_np(p)) for p in self.ps]


@pytest.mark.parametrize("opt_name,fused", [("adamw", False), ("adamw", True), ("momentum", False)])
def test_state_dict_format_matches_jax(opt_name, fused):
    """After 2 steps: the same keys (`<acc>_<i>`, `@step`, `LR_Scheduler`),
    shapes and dtypes (bf16 moment2, f32 beta powers, int64 `@step`) as
    the JAX package's on the stacked + per-tensor path, the flat engine and
    Momentum, with values within f32 rounding (moment2 within a bf16 ulp)."""
    runs = [_Run(pkg, opt_name, fused, sched=True) for pkg in ("jax", "port")]
    for r in runs:
        r.steps(2)
    sj, st = (r.opt.state_dict() for r in runs)
    assert set(st) == set(sj)
    for k in sj:
        if k == "LR_Scheduler":
            assert st[k] == sj[k]
            continue
        assert _dtype(st[k]) == _dtype(sj[k]), k
        a, b = _np(st[k]), _np(sj[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=1e-2 if "moment2" in k else 1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("src_fused,dst_fused", [(False, False), (True, True), (True, False),
                                                 (False, True)])
def test_set_state_dict_before_first_step(src_fused, dst_fused):
    """3 steps, the state dict into a fresh optimizer before its first step
    (every value waits in _pending_state), 2 more steps: equal to 5 steps
    straight, across the stacked and the flat path (the format is
    fusion-agnostic). On one path the stochastic-rounding seeds continue
    where the first optimizer left them (the flat path draws one a step
    here, the stacked path one per shape group, 3); across paths, whose
    steps round with other seeds, moment2 is f32."""
    m2 = "bfloat16" if src_fused == dst_fused else "float32"
    straight = _Run("port", fused=src_fused, m2=m2)
    straight.steps(3)
    drawn_at_3 = straight.drawn
    sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in straight.opt.state_dict().items()}
    params = [p.detach().clone() for p in straight.ps]
    want = straight.steps(2)
    resumed = _Run("port", fused=dst_fused, m2=m2)
    with torch.no_grad():
        for p, v in zip(resumed.ps, params):
            p.copy_(v)
    resumed.opt.set_state_dict(sd)
    resumed.drawn = drawn_at_3
    assert resumed.opt._pending_state and int(resumed.opt.state_dict()["@step"]) == 3
    got = resumed.steps(2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert int(resumed.opt.state_dict()["@step"]) == 5


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer, fused):
    """One package trains 3 steps and saves its params and optimizer state
    (bf16 moment2, a cosine schedule) with paddle.save; the other package
    loads them with paddle.load, set_state_dict before its first step, and
    both take 2 more steps with the same seeds: params within f32 rounding."""
    src = _Run(writer, fused=fused, sched=True)
    src.steps(3)
    lib = paddle if writer == "jax" else ptt
    path = os.path.join(tmp_path, "ckpt.pdopt")
    lib.save({"params": list(src.ps), "opt": src.opt.state_dict()}, path)
    want = src.steps(2)
    reader = "port" if writer == "jax" else "jax"
    dst = _Run(reader, fused=fused, sched=True)
    rlib = paddle if reader == "jax" else ptt
    ck = rlib.load(path)
    for p, v in zip(dst.ps, ck["params"]):
        if reader == "jax":
            p.set_value(v)
        else:
            with torch.no_grad():
                p.copy_(v)
    assert _dtype(ck["opt"]["moment2_0"]) == "bfloat16"
    dst.opt.set_state_dict(ck["opt"])
    dst.drawn = src.drawn - 2 * (1 if fused else 3)  # seeds a step: 1 flat bucket, 3 shape groups
    got = dst.steps(2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert float(_np(dst.opt.state_dict()["@step"])) == 5


def test_bf16_round_trip_without_ml_dtypes(tmp_path, monkeypatch):
    """With ml_dtypes unimportable, the port saves and loads bf16 tensors
    (O2 params, a bf16 moment2) bit for bit, and reads a file the JAX
    package wrote with bf16 arrays; a plain pickle load of the port's file
    (ml_dtypes present) gives ml_dtypes.bfloat16 arrays, as the JAX
    package's own files do."""
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(6, 5).astype(np.float32)).to(torch.bfloat16)
    jpath = os.path.join(tmp_path, "jax.pd")
    paddle.save({"w": paddle.to_tensor(np.asarray(w.float())).astype("bfloat16")}, jpath)
    run = _Run("port")
    run.steps(2)
    sd = run.opt.state_dict()
    assert sd["moment2_0"].dtype == torch.bfloat16
    real_import = builtins.__import__

    def no_ml_dtypes(name, *a, **kw):
        if name.split(".")[0] == "ml_dtypes":
            raise ImportError("ml_dtypes is blocked in this test")
        return real_import(name, *a, **kw)

    for mod in [m for m in sys.modules if m.split(".")[0] == "ml_dtypes"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", no_ml_dtypes)
    assert tio._ml_dtypes() is None
    path = os.path.join(tmp_path, "port.pd")
    ptt.save({"w": w, "opt": sd, "n": 3}, path)
    back = ptt.load(path)
    assert back["n"] == 3 and back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            assert back["opt"][k].dtype == v.dtype, k
            assert torch.equal(back["opt"][k].view(torch.int16) if v.dtype == torch.bfloat16
                               else back["opt"][k], v.view(torch.int16)
                               if v.dtype == torch.bfloat16 else v), k
    from_jax = ptt.load(jpath)["w"]
    assert from_jax.dtype == torch.bfloat16 and torch.equal(from_jax.view(torch.int16),
                                                            w.view(torch.int16))
    with pytest.raises(RuntimeError, match="ml_dtypes"):
        ptt.load(path, return_numpy=True)
    monkeypatch.undo()
    import ml_dtypes
    import pickle

    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert raw["w"]["data"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(raw["w"]["data"].view(np.int16), w.view(torch.int16).numpy())
    jback = paddle.load(path)
    assert str(jback["w"]._value.dtype) == "bfloat16"


def _group_run(pkg, opt_name, fused):
    """Param groups over SHAPES: group 0 (params 0, 1) at lr scale 0.5 with
    no decay; group 1 (params 2-4) with the optimizer's decay and its own
    global-norm clip. Param 2 carries an lr scale of 0.25 in its
    optimize_attr, param 3 an L2Decay(0.2) regularizer, param 4
    need_clip=False. 3 steps; -> params."""
    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    coef = [rng.rand(*s).astype(np.float32) + 0.5 for s in SHAPES]
    lib = paddle if pkg == "jax" else ptt
    lib.set_flags({"FLAGS_fused_optimizer": fused})
    if pkg == "jax":
        ps = [jnn.Parameter(a.copy()) for a in init]
        cs = [paddle.to_tensor(c) for c in coef]
    else:
        ps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
        cs = [torch.from_numpy(c) for c in coef]
    ps[2].optimize_attr = {"learning_rate": 0.25}
    ps[3].regularizer = (jregularizer if pkg == "jax" else ptt.regularizer).L2Decay(0.2)
    ps[4].need_clip = False
    groups = [{"params": ps[:2], "learning_rate": 0.5, "weight_decay": 0.0},
              {"params": ps[2:], "grad_clip": lib.nn.ClipGradByGlobalNorm(0.5)}]
    if opt_name == "adamw":
        opt = lib.optimizer.AdamW(0.05, parameters=groups, weight_decay=0.1)
    elif opt_name == "sgd":
        opt = lib.optimizer.SGD(0.05, parameters=groups, weight_decay=0.1)
    else:
        opt = lib.optimizer.Momentum(0.05, momentum=0.9, parameters=groups, weight_decay=0.1)
    for _ in range(3):
        sum((c * p * p).sum() for c, p in zip(cs, ps)).backward()
        opt.step()
        opt.clear_grad()
    return [np.array(_np(p)) for p in ps], opt


@pytest.mark.parametrize("opt_name,fused", [("adamw", False), ("adamw", True), ("sgd", False),
                                            ("momentum", False)])
def test_param_groups_and_param_attr_match_jax(opt_name, fused):
    """Group lr scales, decays and clips, and a param's own lr scale,
    regularizer and need_clip=False, as the JAX package applies them
    (tests/test_optimizer.py:78, tests/test_nn.py:317): params after 3
    steps within f32 rounding. On the flat path the groups and lr scales
    make separate buckets, keyed as the JAX engine keys them."""
    pj, oj = _group_run("jax", opt_name, fused)
    pt, ot = _group_run("port", opt_name, fused)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    if fused:
        kj = [(str(k[0]), k[1], k[2], k[3]) for k in oj._flat_engine.buckets]
        kt = [(_dtype(torch.empty(0, dtype=k[0])), k[1], k[2], k[3])
              for k in ot._flat_engine.buckets]
        assert kt == kj and len(kt) == 4
