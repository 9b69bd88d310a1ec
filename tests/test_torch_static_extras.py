"""Port parity for the rest of paddle.static (static/extras.py): the
strategies and CompiledProgram, places, create_global_var, gradients in
and out of capture, Print, ExponentialMovingAverage (bit-equal in f32),
the metrics accuracy / auc / ctr_metric_bundle, and the
leftovers jit.set_code_level / set_verbosity and Tensor.apply_nograd.
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu import static as jstatic

import paddle_tpu_torch as ptt
from paddle_tpu_torch import static as tstatic

from test_torch_static_nn import jax_numpy_inits

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _numpy_inits():
    with pytest.MonkeyPatch.context() as mp:
        jax_numpy_inits(mp)
        yield


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t._value)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


# ---------------------------------------------------------------------------
# strategies, places, guards
# ---------------------------------------------------------------------------

def test_strategies_carry_the_jax_packages_fields():
    for name in ("BuildStrategy", "ExecutionStrategy"):
        assert vars(getattr(tstatic, name)()) == vars(getattr(jstatic, name)())
    bs = tstatic.BuildStrategy()
    bs.fuse_bn_act_ops = True
    assert "fuse_bn_act_ops=True" in repr(bs)
    assert tstatic.BuildStrategy.ReduceStrategy.Reduce == jstatic.BuildStrategy.ReduceStrategy.Reduce


def test_compiled_program_runs_the_program_it_wraps():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [-1, 3])
        y = tstatic.nn.fc(x, 2)
    compiled = tstatic.CompiledProgram(main, tstatic.BuildStrategy())
    assert compiled.ops is main.ops and compiled._build_strategy.fuse_bn_add_act_ops
    exe = tstatic.Executor()
    feed = {"x": _rand(4, 3)}
    (a,) = exe.run(compiled, feed=feed, fetch_list=[y])
    (b,) = exe.run(main, feed=feed, fetch_list=[y])
    np.testing.assert_array_equal(a, b)


def test_places_and_guards():
    assert len(tstatic.cpu_places(3)) == len(jstatic.cpu_places(3)) == 3
    assert all(p.is_cpu_place() for p in tstatic.cpu_places()) if hasattr(
        ptt.CPUPlace(), "is_cpu_place") else True
    with tstatic.name_scope("a"), tstatic.name_scope("b"), tstatic.device_guard("gpu"):
        z = ptt.to_tensor([1.0]) + 1.0
    assert _np(z).tolist() == [2.0]


def test_cuda_places_name_the_cards_or_raise_without_cuda(monkeypatch):
    """The JAX package raises ("the TPU build"); the port returns a
    CUDAPlace a card, and raises as paddle's CPU build does."""
    with pytest.raises(RuntimeError, match="CUDA"):
        jstatic.cuda_places()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstatic.cuda_places()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    places = tstatic.cuda_places()
    assert [type(p).__name__ for p in places] == ["CUDAPlace", "CUDAPlace"]
    assert [str(p) for p in tstatic.cuda_places([1])] == [str(ptt.CUDAPlace(1))]


def test_create_global_var_matches_jax():
    for dtype in ("float32", "int64"):
        t = tstatic.create_global_var([2, 3], 7, dtype, persistable=True)
        j = jstatic.create_global_var([2, 3], 7, dtype, persistable=True)
        assert str(_np(t).dtype) == str(_np(j).dtype) == dtype
        np.testing.assert_array_equal(_np(t), _np(j))
        assert t.persistable and tstatic.Variable is torch.Tensor


def test_weight_norm_param_attr_is_a_param_attr():
    init = ptt.nn.initializer.Constant(0.5)
    attr = tstatic.WeightNormParamAttr(dim=0, initializer=init, learning_rate=0.5)
    lin = ptt.nn.Linear(3, 2, weight_attr=attr)
    assert attr.dim == 0 and float(lin.weight.detach().mean()) == 0.5
    assert lin.weight.optimize_attr["learning_rate"] == 0.5
    j = jstatic.WeightNormParamAttr(dim=0)
    assert j.dim == attr.dim and j.trainable == attr.trainable


def test_leftovers_set_code_level_verbosity_and_apply_nograd():
    for pk in (paddle, ptt):
        pk.jit.set_code_level(5)
        pk.jit.set_verbosity(2, also_to_stdout=True)
    assert ptt.jit._CODE_LEVEL == paddle.jit._CODE_LEVEL == [5]
    assert ptt.jit._VERBOSITY == paddle.jit._VERBOSITY == [2]
    x = _rand(3)
    t = ptt.to_tensor(x, stop_gradient=False)
    y = t.apply_nograd(lambda a, b: a * b, t, t)  # the tensor binds as the op's name
    want = paddle.to_tensor(x).apply_nograd(lambda a, b: a * b, paddle.to_tensor(x),
                                            paddle.to_tensor(x))
    np.testing.assert_array_equal(_np(y), _np(want))
    assert not y.requires_grad
    got = ptt.core.record.apply_nograd("square", lambda a: a * a, t)
    assert not got.requires_grad and _np(got).tolist() == _np(y).tolist()


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _grad_case(pk):
    a = pk.to_tensor(np.array([1.0, 2.0, 3.0], "float32"), stop_gradient=False)
    w = pk.to_tensor(np.array([0.5, -1.0, 2.0], "float32"), stop_gradient=False)
    y = a * a * w
    z = y * 3.0
    return a, w, y, z


def test_gradients_outside_capture_match_jax():
    seed = np.array([1.0, 2.0, 3.0], "float32")
    got = {}
    for pk in (paddle, ptt):
        a, w, y, z = _grad_case(pk)
        gs = pk.static.gradients([z], [a, y, w], target_gradients=[pk.to_tensor(seed)])
        got[pk] = [_np(g) for g in gs]
        plain = pk.static.gradients(z, [a], no_grad_set=None)
        got[pk].append(_np(plain[0]))
    for g, w in zip(got[ptt], got[paddle]):
        np.testing.assert_allclose(g, w, **F32)


def test_gradients_under_capture_are_computed_at_every_run():
    """A grad request over feeds, activations and parameters, seeded by
    target_gradients, fetched at each run. The JAX package's gradients
    under capture differentiate its dry run (a feed's grad is None,
    the rest baked from the zero placeholders), so its eager gradients
    on the same values are the oracle."""
    seed = np.array([1.0, 2.0, 3.0], "float32")
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        a = tstatic.data("a", [3])
        w = tstatic.create_parameter([3], "float32")
        y = a * a * w
        z = y * 3.0
        ga, gy, gw = tstatic.gradients([z], [a, y, w], target_gradients=[ptt.to_tensor(seed)])
    exe = tstatic.Executor()
    with torch.no_grad():
        w.copy_(torch.tensor([0.5, -1.0, 2.0]))
    for av in (np.array([1.0, 2.0, 3.0], "float32"), np.array([-2.0, 0.5, 4.0], "float32")):
        got = exe.run(main, feed={"a": av}, fetch_list=[ga, gy, gw])
        ja = paddle.to_tensor(av, stop_gradient=False)
        jw = paddle.to_tensor(np.array([0.5, -1.0, 2.0], "float32"), stop_gradient=False)
        jy = ja * ja * jw
        want = paddle.static.gradients([jy * 3.0], [ja, jy, jw],
                                       target_gradients=[paddle.to_tensor(seed)])
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g, _np(wv), **F32)
    assert main.var_name(main.resolve_fetch(ga)).endswith("@GRAD")


# ---------------------------------------------------------------------------
# Print
# ---------------------------------------------------------------------------

def test_print_eager_matches_jax(capfd):
    x = np.array([1.0, 2.0, 3.0], "float32")
    paddle.static.Print(paddle.to_tensor(x), message="hello")
    want = capfd.readouterr().out
    out = tstatic.Print(ptt.to_tensor(x), message="hello")
    got = capfd.readouterr().out
    assert got == want == "hello [1. 2. 3.]\n"
    assert _np(out).tolist() == x.tolist()


def test_print_under_capture_prints_at_every_run_and_survives_dce(capfd):
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2])
        tstatic.Print(x * 2.0, message="twice")
        y = x + 1.0
    assert capfd.readouterr().out == ""  # the dry run prints nothing
    exe = tstatic.Executor()
    for v in ([1.0, 2.0], [3.0, 4.0]):
        exe.run(main, feed={"x": np.array(v, "float32")}, fetch_list=[y])
    assert capfd.readouterr().out == "twice [2. 4.]\ntwice [6. 8.]\n"
    assert tstatic.dead_op_elimination(main.clone(), fetch_list=[y]) == 0


# ---------------------------------------------------------------------------
# ExponentialMovingAverage
# ---------------------------------------------------------------------------

def _ema_program(pk, st):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [2, 3])
        y = st.nn.fc(x, 4)
        ema = st.ExponentialMovingAverage(0.9)
    return main, ema, main.all_parameters()


def test_ema_is_bit_equal_to_jax_in_f32():
    rng = np.random.RandomState(0)
    (jmain, jema, jps), (tmain, tema, tps) = (_ema_program(paddle, jstatic),
                                             _ema_program(ptt, tstatic))
    assert [tuple(p.shape) for p in tps] == [tuple(p.shape) for p in jps]
    for _ in range(3):
        vals = [rng.randn(*p.shape).astype("float32") for p in tps]
        for jp, tp, v in zip(jps, tps, vals):
            jp.set_value(v)
            with torch.no_grad():
                tp.copy_(torch.from_numpy(v))
        jema.update()
        tema.update()
    before = [_np(p).copy() for p in tps]
    with jema.apply(), tema.apply():
        for jp, tp in zip(jps, tps):
            np.testing.assert_array_equal(_np(tp), _np(jp))
            assert tp.device == tmain.all_parameters()[0].device
    for tp, b in zip(tps, before):
        np.testing.assert_array_equal(_np(tp), b)  # restored
    for jp, tp in zip(jps, tps):  # the shadows themselves
        np.testing.assert_array_equal(_np(tema._ema[id(tp)]), jema._ema[id(jp)])


def test_ema_needs_parameters():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        ema = tstatic.ExponentialMovingAverage()
    with pytest.raises(ValueError, match="no trainable parameters"):
        ema.update()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metric_inputs(n=16, c=10, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, c).astype("float32")
    labels = rng.randint(0, c, (n, 1)).astype("int64")
    prob = rng.rand(n, 2).astype("float32")
    prob[:3, 1] = [0.25, 0.5, 1.0]  # on thresholds of the 4-step grid
    binary = rng.randint(0, 2, (n, 1)).astype("int64")
    return logits, labels, prob, binary


def _metrics(pk, st, logits, labels, prob, binary):
    t = pk.to_tensor
    out = [st.accuracy(t(logits), t(labels), k=k) for k in (1, 5)]
    for curve in ("ROC", "PR"):
        for nt in (4, 4095):
            out.append(st.auc(t(prob), t(binary), curve=curve, num_thresholds=nt)[0])
    out += list(st.ctr_metric_bundle(t(prob), t(binary)))
    return [_np(o) for o in out]


# in _metrics' list: the auc values (f64) and ctr_metric_bundle's float sums (f32)
AUC_AT, SUMS_AT = (2, 3, 4, 5, 6), (7, 8, 9, 10)


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    """accuracy, the positives and the total exactly; auc's threshold
    counts exactly (the grid is numpy's, and so the JAX package's, bit
    for bit, and a prediction on a threshold counts as there). A float
    sum (auc's f64 trapezoid, the bundle's f32 sums) is held within a few
    ulp: XLA's reduction order is not torch's."""
    ins = _metric_inputs(seed=seed)
    want = _metrics(paddle, jstatic, *ins)
    got = _metrics(ptt, tstatic, *ins)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if i in AUC_AT:
            np.testing.assert_allclose(g, w, rtol=1e-15, atol=0)
        elif i in SUMS_AT:
            np.testing.assert_allclose(g, w, rtol=3e-7, atol=0)
        else:
            np.testing.assert_array_equal(g, w)
    # top-k from the logits themselves
    logits, labels, prob, binary = ins
    top5 = np.argsort(-logits, -1)[:, :5]
    assert got[1] == np.float32(np.mean((top5 == labels).any(-1)))
    # the counts at each threshold
    from paddle_tpu_torch.static.extras import auc_thresholds

    import jax.numpy as jnp

    grid = np.asarray(jnp.linspace(0.0, 1.0, 5))
    np.testing.assert_array_equal(auc_thresholds(4).numpy(), grid)
    ge = prob[None, :, 1] >= grid[:, None]
    assert ge[1, 0] and ge[2, 1] and ge[4, 2]  # 0.25, 0.5 and 1.0 count at their threshold
    roc = np.trapezoid((ge & (binary.T == 1)).sum(1) / max((binary == 1).sum(), 1),
                       (ge & (binary.T == 0)).sum(1) / max((binary == 0).sum(), 1))
    np.testing.assert_allclose(got[2], abs(roc), rtol=1e-15, atol=0)


def test_metrics_under_capture():
    logits, labels, prob, binary = _metric_inputs()
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        lg = tstatic.data("logits", [-1, 10])
        lb = tstatic.data("labels", [-1, 1], "int64")
        pr = tstatic.data("prob", [-1, 2])
        bn = tstatic.data("binary", [-1, 1], "int64")
        acc = tstatic.accuracy(lg, lb, k=5)
        a, _ = tstatic.auc(pr, bn)
        bundle = tstatic.ctr_metric_bundle(pr, bn)
    got = tstatic.Executor().run(main, feed={"logits": logits, "labels": labels, "prob": prob,
                                             "binary": binary},
                                 fetch_list=[acc, a, *bundle[1:]])
    eager = _metrics(ptt, tstatic, logits, labels, prob, binary)
    np.testing.assert_array_equal(got[0], eager[1])
    np.testing.assert_array_equal(got[1], eager[3])
    for g, w in zip(got[2:], eager[-6:]):
        np.testing.assert_array_equal(g, w)


def test_auc_grid_is_numpys_linspace():
    from paddle_tpu_torch.static.extras import auc_thresholds

    for nt in (1, 3, 4, 1000, 4095):
        grid = auc_thresholds(nt).numpy()
        assert grid.dtype == np.float64
        np.testing.assert_array_equal(grid, np.linspace(0, 1, nt + 1))
