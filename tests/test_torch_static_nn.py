"""Port parity for paddle.static.nn: each layer builder, the control flow
and the sequence ops against the JAX package's, on seeded numpy inputs.

A builder makes its own parameters. Each case is captured in the JAX
package and run by its Executor; the port then runs it twice from the
JAX package's parameter values: captured (the values written into the
Program's parameters, in the order the Program first reads them) and
eagerly (the values handed out by a global initializer in the order the
builder creates them, which is the same order). Tolerances: f32 1e-5
(rtol and atol), integers and lengths exact.
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import static as jstatic

import paddle_tpu_torch as ptt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.nn import initializer as tinit

from torch_static_nn_table import BUILDERS, SEQUENCE
from torch_static_nn_table import int_ids as _ids
from torch_static_nn_table import randn as _rand

F32 = dict(rtol=1e-5, atol=1e-5)


class _NumpyRandom:
    """Stand-ins for the jax.random draws of the JAX package's initializers,
    from a seeded numpy generator: the weights are carried into the port,
    and jax.random would compile once a parameter shape."""

    def __init__(self, seed=0):
        self.rng = np.random.RandomState(seed)

    def uniform(self, key, shape, dtype, low=0.0, high=1.0):
        return jnp.asarray(self.rng.uniform(low, high, shape).astype("float32"))

    def normal(self, key, shape, dtype):
        return jnp.asarray(self.rng.randn(*shape).astype("float32"))

    def truncated_normal(self, key, lower, upper, shape, dtype):
        return jnp.asarray(np.clip(self.rng.randn(*shape), lower, upper).astype("float32"))


def jax_numpy_inits(mp, seed=0):
    """Every random initializer of the JAX package draws from numpy."""
    from types import SimpleNamespace

    from paddle_tpu.nn import initializer as jinit

    mp.setattr(jinit, "jax", SimpleNamespace(random=_NumpyRandom(seed)))


@pytest.fixture(autouse=True, scope="module")
def _numpy_inits():
    with pytest.MonkeyPatch.context() as mp:
        jax_numpy_inits(mp)
        yield


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")
    yield
    tinit.set_global_initializer(None, None)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t._value)


class _Queue(tinit.Initializer):
    """Hands out the given arrays in turn, each checked against the shape
    asked for."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape, dtype, device):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.tensor(a, dtype=dtype, device=device)


def _outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def run_jax(build, feeds):
    main = jstatic.Program()
    with jstatic.program_guard(main, jstatic.Program()):
        xs = [jstatic.data(n, list(a.shape), str(a.dtype)) for n, a in feeds]
        outs = _outs(build(paddle, jstatic, *xs))
    params = [np.array(_np(p)) for p in main.all_parameters()]
    got = jstatic.Executor().run(main, feed=dict(feeds), fetch_list=outs)
    return [np.asarray(g) for g in got], params, main


def run_port_captured(build, feeds, params):
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        xs = [tstatic.data(n, list(a.shape), str(a.dtype)) for n, a in feeds]
        outs = _outs(build(ptt, tstatic, *xs))
    # in order; a parameter the port's program never reads is skipped
    # (spectral_norm's weight_v: its first power step overwrites it)
    it = iter(params)
    with torch.no_grad():
        for p in main.all_parameters():
            a = next(a for a in it if a.shape == tuple(p.shape))
            p.copy_(torch.from_numpy(a))
    return tstatic.Executor().run(main, feed=dict(feeds), fetch_list=outs), main


def run_port_eager(build, feeds, params):
    q = _Queue(params)
    tinit.set_global_initializer(q, q)
    try:
        out = build(ptt, tstatic, *[ptt.to_tensor(a) for _, a in feeds])
    finally:
        tinit.set_global_initializer(None, None)
    assert q.arrays == []
    return [_np(o) for o in _outs(out)]


@pytest.mark.parametrize("build,feeds", [c[1:] for c in BUILDERS + SEQUENCE],
                         ids=[c[0] for c in BUILDERS + SEQUENCE])
def test_builder_matches_jax_captured_and_eager(build, feeds):
    want, params, jprog = run_jax(build, feeds)
    got, tprog = run_port_captured(build, feeds, params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **F32)
    for g, w in zip(run_port_eager(build, feeds, params), want):
        np.testing.assert_allclose(g, w, **F32)
    # the port records paddle's ops under the JAX package's names, in its
    # order; the JAX package records a few more (batch norm's "bn_stats")
    jnames = iter(op.name for op in jprog.ops)
    assert all(any(n == j for j in jnames) for n in (op.name for op in tprog.ops)), (
        [op.name for op in tprog.ops], [op.name for op in jprog.ops])


def test_sequence_ops_that_read_lengths_on_the_host():
    x = _rand(3, 6, 2)
    off = np.array([0, 2, 1], "int64")
    ln = np.array([3, 3, 3], "int64")
    want = paddle.static.nn.sequence_slice(paddle.to_tensor(x), paddle.to_tensor(off),
                                           paddle.to_tensor(ln))
    got = tstatic.nn.sequence_slice(ptt.to_tensor(x), ptt.to_tensor(off), ptt.to_tensor(ln))
    np.testing.assert_array_equal(_np(got), _np(want))
    lens = np.array([2, 4, 1], "int64")
    want = paddle.static.nn.sequence_unpad(paddle.to_tensor(x), paddle.to_tensor(lens))
    got = tstatic.nn.sequence_unpad(ptt.to_tensor(x), ptt.to_tensor(lens))
    np.testing.assert_array_equal(_np(got), _np(want))
    _, jlen = paddle.static.nn.sequence_pad(paddle.to_tensor(x), 0.0, maxlen=8)
    _, tlen = tstatic.nn.sequence_pad(ptt.to_tensor(x), 0.0, maxlen=8)
    assert _np(tlen).tolist() == _np(jlen).tolist() == [6, 6, 6]
    # captured, the slice length is read at every run
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        xs = tstatic.data("x", [3, 6, 2])
        o = tstatic.data("off", [3], "int64")
        n = tstatic.data("len", [3], "int64")
        out = tstatic.nn.sequence_slice(xs, o, n)
    (res,) = tstatic.Executor().run(main, feed={"x": x, "off": off, "len": ln}, fetch_list=[out])
    np.testing.assert_array_equal(res, _np(got := tstatic.nn.sequence_slice(
        ptt.to_tensor(x), ptt.to_tensor(off), ptt.to_tensor(ln))))
    assert res.shape == (3, 3, 2)


def test_nce_loss_is_the_jax_formula_on_the_ports_noise():
    """The threefry draw cannot be matched (C-trap3): the port's loss is
    held to the JAX file's formula in numpy over the port's own noise
    ids, which every replay and the eager call reuse."""
    x, lbl = _rand(4, 3), _ids(7, 4, 1, seed=1)
    ptt.seed(5)
    eager = tstatic.nn.nce(ptt.to_tensor(x), ptt.to_tensor(lbl), 7, num_neg_samples=3)
    ptt.seed(5)
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        xs = tstatic.data("x", [4, 3])
        ls = tstatic.data("lbl", [4, 1], "int64")
        loss = tstatic.nn.nce(xs, ls, 7, num_neg_samples=3)
    (op,) = [o for o in main.ops if o.name == "nce"]
    w, b = (_np(p) for p in main.all_parameters())
    exe = tstatic.Executor()
    runs = [exe.run(main, feed={"x": x, "lbl": lbl}, fetch_list=[loss])[0] for _ in range(2)]
    ids = op.fn.target.noise.ids(4).numpy()
    assert ids.shape == (4, 3) and ids.min() >= 0 and ids.max() < 7
    softplus = lambda z: np.log1p(np.exp(-np.abs(z))) + np.maximum(z, 0)
    lv = lbl.reshape(4)
    pos = np.sum(x * w[lv], -1) + b[lv]
    neg = np.einsum("bd,bkd->bk", x, w[ids]) + b[ids]
    want = (softplus(-pos) + np.sum(softplus(neg), -1)).reshape(4, 1)
    for got in runs + [_np(eager)]:
        np.testing.assert_allclose(got, want, **F32)


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------

def _both(fn):
    return [fn(pk, pk.static) for pk in (paddle, ptt)]


@pytest.mark.parametrize("flag", [True, False])
def test_eager_control_flow_matches_jax(flag):
    x = _rand(3)

    def run(pk, st):
        t = pk.to_tensor(x)
        a = st.nn.cond(pk.to_tensor(flag), lambda: t * 2.0, lambda: t - 1.0)
        b = st.nn.case([(pk.to_tensor(not flag), lambda: t + 10.0),
                        (pk.to_tensor(flag), lambda: t + 20.0)], default=lambda: t)
        c = st.nn.switch_case(pk.to_tensor(1 if flag else 7),
                              {0: lambda: t * 0.0, 1: lambda: t * 3.0}, default=lambda: -t)
        i, s = st.nn.while_loop(lambda i, s: i < 4, lambda i, s: (i + 1, s + t),
                                [pk.to_tensor(np.int64(0)), pk.to_tensor(np.zeros(3, "float32"))])
        return [_np(v) for v in (a, b, c, i, s)]

    (want, got) = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F32)


def test_captured_control_flow_is_fixed_by_the_dry_run():
    """Under capture the zero placeholders pick the branch and the trip
    count, as in the JAX package: the Program holds what ran."""
    x = _rand(3)
    res = {}
    for pk, st in ((paddle, jstatic), (ptt, tstatic)):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            t = st.data("x", [3])
            p = st.data("p", [1])
            a = st.nn.cond(p.sum() > 0.5, lambda: t * 2.0, lambda: t - 1.0)
            (s,) = st.nn.while_loop(lambda s: s.sum() < 0.5, lambda s: (s + 1.0,), [t])
        out = st.Executor().run(main, feed={"x": x, "p": np.ones(1, "float32")},
                                fetch_list=[a, s])
        res[pk] = [np.asarray(o) for o in out]
    np.testing.assert_allclose(res[ptt][0], x - 1.0, **F32)  # the dry run's branch
    for g, w in zip(res[ptt], res[paddle]):
        np.testing.assert_allclose(g, w, **F32)


def test_jit_cond_decides_at_every_run():
    """jit.cond (static.cond) is one op whose replay reads the predicate:
    one captured Program takes both branches."""
    x = _rand(3)
    outs = {}
    for pk, st in ((paddle, jstatic), (ptt, tstatic)):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            t = st.data("x", [3])
            p = st.data("p", [], "bool")
            y = pk.jit.cond(p, lambda v: v * 2.0, lambda v: v - 1.0, t)
        exe = st.Executor()
        outs[pk] = [np.asarray(exe.run(main, feed={"x": x, "p": np.array(f)}, fetch_list=[y])[0])
                    for f in (True, False)]
        if pk is ptt:
            assert [op.name for op in main.ops] == ["cond"]
    np.testing.assert_allclose(outs[ptt][0], x * 2.0, **F32)
    np.testing.assert_allclose(outs[ptt][1], x - 1.0, **F32)
    for g, w in zip(outs[ptt], outs[paddle]):
        np.testing.assert_allclose(g, w, **F32)
    assert tstatic.cond is ptt.jit.cond


def test_static_pylayer_and_py_func():
    x = _rand(4)
    got = {}
    for pk in (paddle, ptt):
        t = pk.to_tensor(x, stop_gradient=False)
        y = pk.static.nn.static_pylayer(lambda v: v * 3.0, [t], backward_fn=lambda g: g * 10.0)
        y.sum().backward()
        z = pk.static.nn.py_func(lambda v: v + 1.0, t)
        w = pk.static.py_func(lambda v: v - 1.0, t)
        got[pk] = [_np(y), _np(t.grad), _np(z), _np(w)]
    for g, w in zip(got[ptt], got[paddle]):
        np.testing.assert_allclose(g, w, **F32)
    np.testing.assert_allclose(got[ptt][1], np.full(4, 10.0, "float32"))
    # captured: one op each, replayed with the run's values
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        t = tstatic.data("x", [4])
        y = tstatic.nn.py_func(lambda v: v * v, t)
        z = tstatic.nn.static_pylayer(lambda v: v + 2.0, [y])
    assert [op.name for op in main.ops] == ["py_func", "static_pylayer"]
    (res,) = tstatic.Executor().run(main, feed={"x": x}, fetch_list=[z])
    np.testing.assert_allclose(res, x * x + 2.0, **F32)
