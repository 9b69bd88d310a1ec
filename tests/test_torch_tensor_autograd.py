"""Port parity of the Tensor surface and autograd (paddle_tpu_torch/core,
autograd, metric, and the ops the parity table cannot hold: random ops,
decompositions), against the JAX package on the same inputs."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.core import autograd_engine as jengine
from paddle_tpu_torch.core import autograd_engine as tengine


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np(t):
    return np.asarray(t._value) if isinstance(t, paddle.Tensor) else ptt.ops._common._t(t).numpy()


# ---- stop_gradient, hooks, grad, PyLayer ----

def _stop_gradient_program(pkg):
    x = pkg.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    assert not x.stop_gradient
    y = x * 2.0
    y.stop_gradient = True  # gradients stop here
    z = pkg.sum(y * x + x * x)
    z.backward()
    return _np(x.grad)


def test_stop_gradient_matches_jax():
    np.testing.assert_allclose(_stop_gradient_program(ptt), _stop_gradient_program(paddle))
    t = ptt.to_tensor([1, 2])
    assert t.stop_gradient and t.dtype == torch.int64
    t.stop_gradient = False  # an integer tensor cannot require grad: nothing changes
    assert t.stop_gradient
    f = ptt.to_tensor([1.0])
    f.stop_gradient = False
    assert f.requires_grad and f.is_leaf


def test_tensor_hook_matches_jax():
    out = []
    for pkg in (ptt, paddle):
        x = pkg.to_tensor([1.0, -2.0], stop_gradient=False)
        h = x.register_hook(lambda g: g * 3.0)
        pkg.sum(x * x).backward()
        h.remove()
        out.append(_np(x.grad))
    np.testing.assert_allclose(out[0], out[1])
    np.testing.assert_allclose(out[0], [6.0, -12.0])


def test_backward_end_hook():
    seen = []
    handle = tengine.register_backward_end_hook(
        lambda completed: seen.append((completed, tengine.grad_collection_active())))
    leaf_seen = []
    try:
        x = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
        (x * x).sum().backward()
        x.register_hook(lambda g: leaf_seen.append(tengine.grad_collection_active()))
        ptt.grad((x * x).sum(), x)
        ptt.autograd.backward([(x * 3.0).sum()])
        with pytest.raises(RuntimeError):
            (x * 2.0).sum().backward(torch.ones(3))  # a wrong grad shape raises in the walk
    finally:
        handle.remove()
    (x * x).sum().backward()
    assert leaf_seen[0] is True  # inside grad(): per-leaf observers can sit it out
    assert seen == [(True, False), (True, False), (False, False)]  # grad() fires none
    # the JAX package: the same sequence of calls fires the same pattern
    jseen = []
    jh = jengine.register_backward_end_hook(
        lambda completed: jseen.append((completed, jengine.grad_collection_active())))
    try:
        x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
        (x * x).sum().backward()
        paddle.grad((x * x).sum(), x)
        paddle.autograd.backward([(x * 3.0).sum()])
    finally:
        jh.remove()
    assert jseen == seen[:2]


def _double_grad(pkg):
    x = pkg.to_tensor([0.5, -1.5, 2.0], stop_gradient=False)
    y = pkg.sum(x * x * x)
    (g,) = pkg.grad(y, x, create_graph=True)
    (gg,) = pkg.grad(pkg.sum(g * g), x)
    return _np(g), _np(gg)


def test_grad_create_graph_matches_jax():
    for a, b in zip(_double_grad(ptt), _double_grad(paddle)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_grad_unused_and_no_grad_vars():
    for pkg in (ptt, paddle):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        w = pkg.to_tensor([3.0, 4.0], stop_gradient=False)
        y = pkg.sum(x * 2.0)
        with pytest.raises(RuntimeError, match="unused"):
            pkg.grad(y, [x, w], retain_graph=True)
        gx, gw = pkg.grad(y, [x, w], allow_unused=True, retain_graph=True)
        assert gw is None and np.allclose(_np(gx), [2.0, 2.0])
        z = pkg.sum(x * w)
        gx, gw = pkg.grad(z, [x, w], no_grad_vars=[w], allow_unused=True)
        assert gw is None and np.allclose(_np(gx), [3.0, 4.0])
        assert x.grad is None and w.grad is None  # grad() never touches .grad


def _pylayer_run(pkg, call_form):
    class Cube(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale):
            ctx.save_for_backward(x)
            return x * x * x * scale

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor() if call_form else ctx.saved_tensor
            return dy * 3.0 * x * x * 2.0

    x = pkg.to_tensor([1.0, -2.0, 0.5], stop_gradient=False)
    y = Cube.apply(x, 2.0)
    pkg.sum(y * y).backward()
    return _np(y), _np(x.grad)


def test_pylayer_matches_jax():
    want = _pylayer_run(paddle, call_form=False)
    for call_form in (True, False):
        for a, b in zip(_pylayer_run(ptt, call_form), want):
            np.testing.assert_allclose(a, b, rtol=1e-6)


def test_pylayer_mark_non_differentiable():
    class ArgmaxAndValue(ptt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            idx = torch.argmax(x).reshape(1).float()
            ctx.mark_non_differentiable(idx)
            return x * 2.0, idx

        @staticmethod
        def backward(ctx, dy, didx):
            return dy * 2.0

    x = ptt.to_tensor([1.0, 3.0], stop_gradient=False)
    y, idx = ArgmaxAndValue.apply(x)
    assert not idx.requires_grad and y.requires_grad
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])


def test_saved_tensors_hooks_identity():
    packed = []
    x = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    with ptt.autograd.saved_tensors_hooks(lambda t: packed.append(1) or t, lambda t: t):
        y = ptt.sum(ptt.exp(x))
    y.backward()
    assert packed and np.allclose(x.grad.numpy(), np.exp([1.0, 2.0]))


def test_grad_mode_helpers():
    x = ptt.to_tensor([1.0], stop_gradient=False)
    with ptt.no_grad():
        assert not ptt.is_grad_enabled() and not (x * 2).requires_grad
        with ptt.enable_grad():
            assert (x * 2).requires_grad
    with ptt.set_grad_enabled(False):
        assert not ptt.is_grad_enabled()
    assert ptt.is_grad_enabled()

    @ptt.no_grad()
    def f(t):
        return t * 2

    assert not f(x).requires_grad


# ---- inplace ops that change dtype; the Tensor's own methods ----

def test_inplace_ops():
    """tests/test_tensor.py::test_inplace_ops in the port, and the dtype rule."""
    x = ptt.to_tensor([1.0, 2.0])
    x.add_(1.0)
    np.testing.assert_array_equal(x.numpy(), [2.0, 3.0])
    x.scale_(2.0)
    np.testing.assert_array_equal(x.numpy(), [4.0, 6.0])
    x.zero_()
    assert x.numpy().sum() == 0
    y = ptt.to_tensor([1.0, 2.0])
    same = y.greater_than_(ptt.to_tensor([1.5, 1.5]))  # paddle-only: y becomes bool, as in JAX
    j = paddle.to_tensor([1.0, 2.0])
    j.greater_than_(paddle.to_tensor([1.5, 1.5]))
    assert same is y and y.dtype == torch.bool and str(j.dtype) == "bool"
    np.testing.assert_array_equal(y.numpy(), np.asarray(j._value))
    c = ptt.to_tensor([1.5, 2.5])
    c.cast_("int32")
    assert c.dtype == torch.int32
    w = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    h = w * 1.0
    with pytest.raises(RuntimeError, match="autograd graph"):
        ptt.equal_(h, 1.0)  # inside the graph: a dtype change raises, nothing silently kept
    with pytest.raises(RuntimeError):
        ptt.sigmoid_(w)  # a leaf that requires grad: torch's error
    g = ptt.sigmoid_(h)  # a non-leaf: written in place, its gradient still right
    assert g is h
    g.sum().backward()
    sig = 1 / (1 + np.exp(-np.array([1.0, 2.0])))
    np.testing.assert_allclose(w.grad.numpy(), sig * (1 - sig), rtol=1e-6)


def test_tensor_methods_match_jax():
    a = np.array([[1.5, -2.0], [0.25, 4.0]], np.float32)
    for pkg in (ptt, paddle):
        x = pkg.to_tensor(a)
        assert str(x.astype("float64").dtype).endswith("float64")
        assert str(x.cast("int32").dtype).endswith("int32")
        np.testing.assert_array_equal(_np(x[[1, 0]]), a[[1, 0]])
        np.testing.assert_array_equal(_np(x[np.array([True, False])]), a[[0]])
        np.testing.assert_array_equal(_np(x[pkg.to_tensor([1])]), a[[1]])
        x[0] = pkg.to_tensor([7, 8])  # an int64 value into a float tensor
        assert float(_np(x)[0, 1]) == 8.0
        np.testing.assert_array_equal(_np(x.T), _np(x).T)
        x.set_value(np.zeros((3,), np.float64))
        assert list(x.shape) == [3]
        p = pkg.to_tensor([1.0], stop_gradient=False)
        (p * 2).sum().backward()
        p.clear_grad()
        assert p.grad is None
    t = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert t.place == t.device and t.value is t and t.persistable is False
    t.persistable = True
    assert t.persistable
    (t * 3).sum().backward()
    np.testing.assert_array_equal(t.gradient(), [3.0, 3.0])
    param = ptt.create_parameter([2, 3], "float32")
    assert param.requires_grad and param.shape == (2, 3)
    e = ptt.Tensor.create_tensor("int64")
    assert e.shape == (0,) and e.dtype == torch.int64
    ptt.set_printoptions(precision=3)
    assert "1.235" in repr(ptt.to_tensor([1.23456]))
    ptt.set_printoptions(precision=4)


# ---- AMP: each op casts as the JAX package's op of its name ----

AMP_OPS = [("matmul", 2, lambda m, a, b: m.matmul(a, b)), ("exp", 1, lambda m, a: m.exp(a)),
           ("add", 2, lambda m, a, b: m.add(a, b)), ("sum", 1, lambda m, a: m.sum(a)),
           ("bmm", 2, lambda m, a, b: m.bmm(a[None], b[None])),
           ("einsum", 2, lambda m, a, b: m.einsum("ij,jk->ik", a, b)),
           ("mean", 1, lambda m, a: m.mean(a)), ("sqrt", 1, lambda m, a: m.sqrt(a)),
           ("concat", 2, lambda m, a, b: m.concat([a, b])), ("tanh", 1, lambda m, a: m.tanh(a)),
           ("cumsum", 1, lambda m, a: m.cumsum(a, axis=0)), ("norm", 1, lambda m, a: m.norm(a))]


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype_in", ["float32", "bfloat16"])
def test_amp_casts_per_op_name(level, dtype_in):
    a = np.random.RandomState(0).rand(4, 4).astype(np.float32)
    for name, n, fn in AMP_OPS:
        dts = []
        for pkg in (ptt, paddle):
            xs = [pkg.to_tensor(a).astype(dtype_in) for _ in range(n)]
            with pkg.amp.auto_cast(level=level, dtype="bfloat16"):
                dts.append(str(fn(pkg, *xs).dtype).split(".")[-1])
        assert dts[0] == dts[1], (name, level, dtype_in, dts)


# ---- random ops: shape, dtype, range, determinism, moments ----

N = 20000
RANDOM = [
    ("rand", lambda m: m.rand([N]), 0.5, 1 / 12 ** 0.5, (0.0, 1.0)),
    ("uniform", lambda m: m.uniform([N], min=-2.0, max=4.0), 1.0, 6 / 12 ** 0.5, (-2.0, 4.0)),
    ("randn", lambda m: m.randn([N]), 0.0, 1.0, None),
    ("standard_normal", lambda m: m.standard_normal([N]), 0.0, 1.0, None),
    ("normal", lambda m: m.normal(1.0, 2.0, [N]), 1.0, 2.0, None),
    ("normal_tensor", lambda m: m.normal(m.to_tensor(np.full(N, 3.0, np.float32)), 0.5), 3.0,
     0.5, None),
    ("randint", lambda m: m.randint(0, 10, [N]), 4.5, (99 / 12) ** 0.5, (0, 9)),
    ("randint_like", lambda m: m.randint_like(m.zeros([N], "int32"), 2, 6), 3.5,
     (15 / 12) ** 0.5, (2, 5)),
    ("randperm", lambda m: m.randperm(N), (N - 1) / 2, None, (0, N - 1)),
    ("bernoulli", lambda m: m.bernoulli(m.full([N], 0.3)), 0.3, 0.21 ** 0.5, (0, 1)),
    ("poisson", lambda m: m.poisson(m.full([N], 4.0)), 4.0, 2.0, (0, None)),
    ("binomial", lambda m: m.binomial(m.full([N], 10, "int64"), m.full([N], 0.4)), 4.0,
     2.4 ** 0.5, (0, 10)),
    ("standard_gamma", lambda m: m.standard_gamma(m.full([N], 2.0)), 2.0, 2 ** 0.5, (0, None)),
    ("multinomial", lambda m: m.multinomial(m.to_tensor([0.1, 0.2, 0.7]), N, True), 1.6,
     (0.1 * 1.6 ** 2 + 0.2 * 0.6 ** 2 + 0.7 * 0.4 ** 2) ** 0.5, (0, 2)),
]


@pytest.mark.parametrize("name,fn,mean,std,bounds", RANDOM, ids=[r[0] for r in RANDOM])
def test_random_op(name, fn, mean, std, bounds):
    """Shape and dtype as the JAX package's; bounds; the same draws again
    after seed(); the mean within 5 standard errors, the std within 5%."""
    ptt.seed(123)
    a = fn(ptt)
    ptt.seed(123)
    b = fn(ptt)
    c = fn(ptt)
    j = fn(paddle)
    assert tuple(a.shape) == tuple(j.shape) and str(a.dtype).split(".")[-1] == str(j.dtype)
    assert torch.equal(a, b) and not torch.equal(b, c)
    v = a.double().numpy()
    if bounds is not None:
        assert v.min() >= bounds[0] and (bounds[1] is None or v.max() <= bounds[1])
    if name == "randperm":
        assert np.array_equal(np.sort(v), np.arange(N))
        return
    assert abs(v.mean() - mean) < 5 * std / N ** 0.5, (v.mean(), mean)
    assert abs(v.std() - std) < 0.05 * std, (v.std(), std)


def test_random_fills_and_sampling():
    ptt.seed(5)
    moments = {"normal_": (0.5, 2.0), "uniform_": (1.0, 3 / 12 ** 0.5),
               "exponential_": (0.5, 0.5)}
    for name, args in (("normal_", (0.5, 2.0)), ("uniform_", (-0.5, 2.5)),
                       ("exponential_", (2.0,))):
        x = torch.zeros(N)
        assert getattr(ptt, name)(x, *args) is x
        m, s = moments[name]
        assert abs(float(x.mean()) - m) < 5 * s / N ** 0.5 and abs(float(x.std()) - s) < 0.05 * s
    g = ptt.geometric_(torch.zeros(N), 0.25)
    assert float(g.min()) >= 1 and abs(float(g.mean()) - 4.0) < 0.15
    cauchy = ptt.cauchy_(torch.zeros(N), 1.0, 2.0)
    assert abs(float(cauchy.median()) - 1.0) < 0.1
    w = ptt.where_(ptt.to_tensor([True, False]), ptt.to_tensor([1.0, 2.0]), 0.0)
    np.testing.assert_array_equal(w.numpy(), [1.0, 0.0])
    soft = ptt.gumbel_softmax(ptt.to_tensor(np.zeros((3, 4), np.float32)))
    hard = ptt.gumbel_softmax(ptt.to_tensor(np.zeros((3, 4), np.float32)), hard=True)
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert set(np.unique(hard.numpy())) <= {0.0, 1.0} and np.all(hard.numpy().sum(-1) == 1)
    probs = ptt.to_tensor(np.array([[0.05, 0.6, 0.35], [0.9, 0.05, 0.05]], np.float32))
    val, ids = ptt.top_p_sampling(probs, ptt.to_tensor([0.5, 0.5]), seed=3)
    assert ids.dtype == torch.int64 and ids.tolist() == [[1], [0]]  # only the top id is kept
    np.testing.assert_allclose(val.numpy(), [[0.6], [0.9]])
    jv, jids = paddle.top_p_sampling(paddle.to_tensor(probs.numpy()), paddle.to_tensor([0.5, 0.5]))
    assert np.asarray(jids._value).tolist() == ids.tolist()
    mn = ptt.multinomial(ptt.to_tensor([0.2, 0.3, 0.5]), 3)
    assert sorted(mn.tolist()) == [0, 1, 2]  # without replacement: each once
    sl = ptt.linalg.svd_lowrank(ptt.to_tensor(np.outer(np.arange(1, 6), np.arange(1, 5))
                                              .astype(np.float32)), q=2)
    np.testing.assert_allclose((sl[0] * sl[1]) @ sl[2].T, np.outer(np.arange(1, 6),
                                                                    np.arange(1, 5)), atol=1e-3)


# ---- decompositions: reconstructions and invariants against the JAX package ----

def test_decompositions_match_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(5, 4).astype(np.float32)
    sym = (a.T @ a + np.eye(4)).astype(np.float32)
    sq = rng.rand(4, 4).astype(np.float32) + np.eye(4, dtype=np.float32)
    T, J = ptt.to_tensor, paddle.to_tensor
    q, r = ptt.linalg.qr(T(a))
    np.testing.assert_allclose((q @ r).numpy(), a, atol=1e-5)
    np.testing.assert_allclose(np.abs(r.numpy()), np.abs(np.asarray(paddle.linalg.qr(J(a))[1]
                                                                     ._value)), atol=1e-5)
    (rr,) = ptt.linalg.qr(T(a), mode="r")
    np.testing.assert_allclose(np.abs(rr.numpy()), np.abs(r.numpy()), atol=1e-5)
    u, s, vh = ptt.linalg.svd(T(a))
    np.testing.assert_allclose(((u * s) @ vh).numpy(), a, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(paddle.linalg.svd(J(a))[1]._value),
                               rtol=1e-5)
    w, v = ptt.linalg.eigh(T(sym))
    np.testing.assert_allclose(((v * w) @ v.T).numpy(), sym, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(paddle.linalg.eigh(J(sym))[0]._value),
                               rtol=1e-5)
    ew, ev = ptt.linalg.eig(T(sq))
    np.testing.assert_allclose((ev @ torch.diag(ew) @ torch.linalg.inv(ev)).numpy().real, sq,
                               atol=1e-4)
    jw = np.sort_complex(np.asarray(paddle.linalg.eigvals(J(sq))._value))
    np.testing.assert_allclose(np.sort_complex(ptt.linalg.eigvals(T(sq)).numpy()), jw,
                               rtol=1e-4, atol=1e-5)
    lu, piv = ptt.linalg.lu(T(sq))
    jlu, jpiv = paddle.linalg.lu(J(sq))
    assert piv.dtype == torch.int32 and piv.tolist() == np.asarray(jpiv._value).tolist()
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu._value), rtol=1e-5, atol=1e-6)
    P, L, U = ptt.linalg.lu_unpack(lu, piv)
    np.testing.assert_allclose((P @ L @ U).numpy(), sq, atol=1e-5)
    pu, ps, pv = ptt.linalg.pca_lowrank(T(a), q=2)
    jps = np.asarray(paddle.linalg.pca_lowrank(J(a), q=2)[1]._value)
    np.testing.assert_allclose(ps.numpy(), jps, rtol=1e-5)
    z = ptt.as_real(ptt.as_complex(T(a[:, :2].copy())))
    np.testing.assert_array_equal(z.numpy(), a[:, :2])


# ---- metric ----

def test_metric_matches_jax():
    rng = np.random.RandomState(1)
    pred = rng.rand(16, 5).astype(np.float32)
    label = rng.randint(0, 5, (16, 1)).astype(np.int64)
    for k in (1, 2):
        np.testing.assert_allclose(
            float(ptt.metric.accuracy(ptt.to_tensor(pred), ptt.to_tensor(label), k=k)),
            float(paddle.metric.accuracy(paddle.to_tensor(pred), paddle.to_tensor(label), k=k)))
    res = []
    prob = rng.rand(40).astype(np.float32)
    lab = (rng.rand(40) < prob).astype(np.int64)
    for pkg in (ptt, paddle):
        acc = pkg.metric.Accuracy(topk=(1, 3))
        acc.update(acc.compute(pkg.to_tensor(pred), pkg.to_tensor(label)))
        acc.update(acc.compute(pkg.to_tensor(pred[:5]), pkg.to_tensor(label[:5])))
        pr, rc, auc = pkg.metric.Precision(), pkg.metric.Recall(), pkg.metric.Auc()
        for m in (pr, rc, auc):
            m.update(pkg.to_tensor(prob), pkg.to_tensor(lab))
        res.append((acc.accumulate(), acc.name(), pr.accumulate(), rc.accumulate(),
                    auc.accumulate()))
    assert res[0][1] == res[1][1]
    np.testing.assert_allclose(np.hstack([np.ravel(r) for i, r in enumerate(res[0]) if i != 1]),
                               np.hstack([np.ravel(r) for i, r in enumerate(res[1]) if i != 1]))
