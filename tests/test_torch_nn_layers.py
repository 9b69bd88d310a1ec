"""Port parity of the nn layers, nn.Layer, the initializers, gradient
clipping and nn.utils (paddle_tpu_torch/nn/{layer,layers,initializer,
clip,utils}): each layer class built in both packages, the JAX layer's
state carried into the port's by `Layer.set_state_dict`, the same numpy
input through both, outputs and the gradients of sum(w * out) (inputs
and parameters) compared; and the names of nn, nn.functional,
nn.initializer, nn.Layer and the top level against the JAX package's."""
import math

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
import paddle_tpu_torch as ptt

from torch_op_table import TOL, Arr, F, I, make_args, weights, R

IMG = (2, 4, 6, 6)
S = (2, 3, 4)
SIGNS = Arr((1.0, -1.0, 1.0, -1.0, 1.0))

# (layer name, constructor args, constructor kwargs, input specs); each
# row runs in eval mode unless it names train
_ACT = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "GELU", "Silu", "Swish", "Mish", "LeakyReLU", "ELU",
        "SELU", "CELU", "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink", "Hardsigmoid",
        "Hardswish", "Softplus", "Softsign", "LogSigmoid", "ThresholdedReLU", "Softmax",
        "LogSoftmax"]
LAYERS = [(n, (), {}, (F(S, -4.0, 4.0),)) for n in _ACT] + [
    ("Maxout", (2,), {}, (F(IMG),)), ("GLU", (), {}, (F((3, 6)),)),
    ("PReLU", (4, 0.1), {}, (F(IMG),)), ("Softmax2D", (), {}, (F(IMG),)),
    ("AlphaDropout", (0.2,), {}, (F(S),)), ("Dropout2D", (0.2,), {}, (F(IMG),)),
    ("Dropout3D", (0.2,), {}, (F((2, 3, 2, 2, 2)),)),
    ("Flatten", (), {}, (F(IMG),)), ("Unflatten", (1, [2, 2]), {}, (F((2, 4, 3)),)),
    ("Identity", (), {}, (F(S),)),
    ("Upsample", (), dict(scale_factor=2), (F(IMG),)),
    ("UpsamplingBilinear2D", (), dict(size=[9, 7]), (F(IMG),)),
    ("UpsamplingNearest2D", (), dict(scale_factor=2), (F(IMG),)),
    ("Bilinear", (4, 5, 3), {}, (F((3, 4)), F((3, 5)))),
    ("PixelShuffle", (2,), {}, (F((2, 8, 3, 3)),)), ("PixelUnshuffle", (2,), {}, (F(IMG),)),
    ("ChannelShuffle", (2,), {}, (F(IMG),)),
    ("Pad1D", ([1, 2],), dict(mode="reflect"), (F((2, 3, 5)),)),
    ("Pad2D", ([1, 2, 0, 1],), dict(mode="replicate"), (F(IMG),)),
    ("Pad3D", ([1, 0, 0, 1, 2, 1],), dict(value=0.5), (F((1, 2, 3, 3, 3)),)),
    ("ZeroPad2D", ([1, 1, 2, 0],), {}, (F(IMG),)),
    ("CosineSimilarity", (), dict(axis=-1), (F(S), F(S))),
    ("PairwiseDistance", (), {}, (F((3, 4)), F((3, 4)))),
    ("Unfold", (2,), dict(strides=2), (F(IMG),)),
    ("Fold", ([5, 5], 2), {}, (F((2, 16, 16)),)),
    ("MSELoss", (), {}, (F(S), F(S))), ("L1Loss", (), {}, (F(S), F(S))),
    ("NLLLoss", (), {}, (F((3, 4), -3.0, 0.0), I((3,), 0, 4))),
    ("BCELoss", (), {}, (F((3, 4), 0.05, 0.95), F((3, 4), 0.0, 1.0))),
    ("BCEWithLogitsLoss", (), {}, (F((3, 4)), F((3, 4), 0.0, 1.0))),
    ("KLDivLoss", (), dict(reduction="batchmean"), (F((3, 4), -3.0, -0.1),
                                                    F((3, 4), 0.01, 1.0))),
    ("SmoothL1Loss", (), {}, (F(S), F(S))),
    ("CTCLoss", (), {}, (F((6, 2, 5)), I((2, 3), 1, 5, "int32"), Arr((6, 5), "int64"),
                        Arr((3, 2), "int64"))),
    ("MarginRankingLoss", (0.2,), {}, (F((5,)), F((5,)), SIGNS)),
    ("TripletMarginLoss", (), {}, (F((3, 4)), F((3, 4)), F((3, 4)))),
    ("SigmoidFocalLoss", (), {}, (F((3, 4)), F((3, 4), 0.0, 1.0))),
    ("GaussianNLLLoss", (), {}, (F((3, 4)), F((3, 4)), F((3, 4), 0.1, 1.0))),
    ("PoissonNLLLoss", (), {}, (F((3, 4)), F((3, 4), 0.0, 3.0))),
    ("HingeEmbeddingLoss", (), {}, (F((5,)), SIGNS)),
    ("CosineEmbeddingLoss", (), {}, (F((5, 4)), F((5, 4)), SIGNS)),
    ("SoftMarginLoss", (), {}, (F((5,)), SIGNS)),
    ("MultiLabelSoftMarginLoss", (), {}, (F((3, 4)), F((3, 4), 0.0, 1.0))),
    ("MultiMarginLoss", (), {}, (F((3, 4)), I((3,), 0, 4))),
    ("TripletMarginWithDistanceLoss", (), {}, (F((3, 4)), F((3, 4)), F((3, 4)))),
    ("HSigmoidLoss", (3, 5), {}, (F((4, 3)), I((4,), 0, 5))),
    ("RNNTLoss", (), {}, (F((2, 3, 3, 4)), I((2, 2), 1, 4, "int32"), Arr((3, 2), "int32"),
                         Arr((2, 1), "int32"))),
    ("GroupNorm", (2, 4), {}, (F(IMG),)), ("InstanceNorm1D", (3,), {}, (F((2, 3, 7)),)),
    ("InstanceNorm2D", (4,), {}, (F(IMG),)), ("InstanceNorm3D", (2,), {}, (F((1, 2, 3, 3, 3)),)),
    ("LocalResponseNorm", (3,), {}, (F(IMG),)),
    ("SpectralNorm", ((4, 3),), dict(power_iters=2), (F((4, 3)),)),
    ("AdaptiveMaxPool1D", (3,), {}, (F((2, 3, 7)),)), ("AdaptiveMaxPool2D", ([3, 2],), {},
                                                       (F(IMG),)),
    ("AdaptiveMaxPool3D", (2,), {}, (F((1, 2, 4, 4, 5)),)),
    ("FractionalMaxPool2D", (3,), dict(random_u=0.3), (F((2, 2, 7, 7)),)),
    ("FractionalMaxPool3D", (3,), dict(random_u=0.5), (F((1, 2, 6, 6, 6)),)),
]


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _inputs(specs, tag):
    args, _ = make_args(R(tag, *specs))
    return [v for _, v in args]


def _run(pkg, layer, arrays):
    """Outputs and the grads of sum(w * out) over the float outputs, by
    parameter name and by float input, as numpy."""
    if pkg is paddle:
        xs = [paddle.to_tensor(a, stop_gradient=a.dtype.kind != "f") for a in arrays]
    else:
        xs = [torch.from_numpy(a).requires_grad_(a.dtype.kind == "f") for a in arrays]
    out = layer(*xs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    loss = 0
    for i, o in enumerate(outs):
        if pkg is paddle:
            if np.issubdtype(np.asarray(o._value).dtype, np.floating):
                loss = loss + (o.astype("float32") * paddle.to_tensor(
                    weights(tuple(o.shape), i))).sum()
        elif o.is_floating_point():
            loss = loss + (o.float() * torch.from_numpy(weights(tuple(o.shape), i))).sum()
    if not isinstance(loss, int):
        loss.backward()

    def arr(t):
        return np.asarray(t._value) if pkg is paddle else t.detach().numpy()

    def grad(t):  # torch leaves an input the loss does not reach without one
        return arr(t.grad) if t.grad is not None else np.zeros(tuple(t.shape), np.float32)

    grads = {n: grad(p) for n, p in layer.named_parameters() if not p.stop_gradient}
    grads.update({f"input{i}": grad(x) for i, x in enumerate(xs) if not x.stop_gradient})
    return [arr(o) for o in outs], grads


@pytest.mark.parametrize("name,args,kwargs,specs", LAYERS, ids=[r[0] for r in LAYERS])
def test_layer_matches_jax(name, args, kwargs, specs):
    paddle.seed(0)
    jl = getattr(paddle.nn, name)(*args, **kwargs)
    tl = getattr(ptt.nn, name)(*args, **kwargs)
    jl.eval()
    tl.eval()
    missing, unexpected = tl.set_state_dict({k: np.asarray(v._value)
                                             for k, v in jl.state_dict().items()})
    assert missing == [] and unexpected == []
    arrays = _inputs(specs, name)
    want, wgrads = _run(paddle, jl, arrays)
    got, ggrads = _run(ptt, tl, arrays)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, **TOL["f32"], err_msg=name)
    assert set(ggrads) == set(wgrads), (name, set(ggrads), set(wgrads))
    for k, w in wgrads.items():
        # CTC: the JAX package's gradient is NaN where the port's is finite
        # (ROADMAP's reference-side faults); held where the JAX one is finite
        ok = np.isfinite(w)
        assert np.isfinite(ggrads[k]).all() and (ok.all() or name == "CTCLoss"), (name, k)
        np.testing.assert_allclose(ggrads[k][ok], w[ok], **TOL["f32_grad"],
                                   err_msg=f"{name} {k}")


def test_rrelu_layer_and_random_functionals():
    """RReLU in eval takes the mean slope; in training its slopes lie in
    [lower, upper] and are drawn again equal after seed() (the JAX
    package's layer always trains: ROADMAP's reference-side faults). The
    training dropouts keep p of the values (moments over 2^16), alpha
    dropout keeps the mean and variance, gumbel_softmax rows sum to one
    (hard: one-hot)."""
    x = -torch.rand(1 << 16) - 0.1
    layer = ptt.nn.RReLU(0.1, 0.3)
    layer.eval()
    assert torch.allclose(layer(x), 0.2 * x)
    layer.train()
    ptt.seed(3)
    a = layer(x)
    ptt.seed(3)
    assert torch.equal(a, layer(x))
    slope = a / x
    assert slope.min() >= 0.1 and slope.max() <= 0.3 and abs(slope.mean().item() - 0.2) < 2e-3
    F = ptt.nn.functional
    ones = torch.ones(1 << 16)
    kept = (F.dropout(ones, 0.3) != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.01
    down = F.dropout(ones, 0.3, mode="downscale_in_infer")
    assert set(down.unique().tolist()) <= {0.0, 1.0}
    cols = F.dropout(torch.ones(64, 512), 0.5, axis=1)
    assert torch.equal(cols, cols[:1].expand(64, -1))
    ch = F.dropout2d(torch.ones(4, 64, 3, 3), 0.5)
    assert torch.equal(ch, ch[..., :1, :1].expand_as(ch))
    z = torch.randn(1 << 16)
    ad = F.alpha_dropout(z, 0.2)
    assert abs(ad.mean().item()) < 0.02 and abs(ad.std().item() - 1.0) < 0.02
    g = F.gumbel_softmax(torch.randn(8, 5), temperature=0.5)
    assert torch.allclose(g.sum(-1), torch.ones(8))
    h = F.gumbel_softmax(torch.randn(8, 5, requires_grad=True), hard=True)
    assert torch.equal(h.detach().sum(-1), torch.ones(8)) and set(h.detach().unique().tolist()) \
        == {0.0, 1.0}


def test_class_center_sample_and_max_unpool():
    """class_center_sample keeps every positive class first (ascending),
    fills with distinct negatives and remaps the labels, as the JAX package
    does (equal when no negative is drawn); max_unpool2d scatters a pool's
    values back to the JAX package's positions."""
    label = np.array([5, 1, 5, 7], np.int64)
    for pkg, to in ((paddle, paddle.to_tensor), (ptt, torch.from_numpy)):
        remap, sampled = pkg.nn.functional.class_center_sample(to(label), 10, 3)
        assert np.asarray(getattr(sampled, "_value", sampled)).tolist() == [1, 5, 7]
        assert np.asarray(getattr(remap, "_value", remap)).tolist() == [1, 0, 1, 2]
    remap, sampled = ptt.nn.functional.class_center_sample(torch.from_numpy(label), 10, 6)
    s = sampled.tolist()
    assert s[:3] == [1, 5, 7] and len(set(s)) == 6 and remap.tolist() == [1, 0, 1, 2]
    x = np.random.RandomState(0).randn(2, 3, 6, 6).astype(np.float32)
    jo, jm = paddle.nn.functional.max_pool2d(paddle.to_tensor(x), 2, return_mask=True)
    to, tm = ptt.nn.functional.max_pool2d(torch.from_numpy(x), 2, return_mask=True)
    want = paddle.nn.MaxUnPool2D(2)(jo, jm)
    got = ptt.nn.MaxUnPool2D(2)(to, tm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))
    x1 = x.reshape(2, 3, 36)
    jo, jm = paddle.nn.functional.max_pool1d(paddle.to_tensor(x1), 3, return_mask=True)
    to, tm = ptt.nn.functional.max_pool1d(torch.from_numpy(x1), 3, return_mask=True)
    np.testing.assert_array_equal(ptt.nn.MaxUnPool1D(3)(to, tm).numpy(),
                                  np.asarray(paddle.nn.MaxUnPool1D(3)(jo, jm)._value))
    x3 = x.reshape(1, 2, 3, 6, 6)
    jo, jm = paddle.nn.functional.max_pool3d(paddle.to_tensor(x3), 3, return_mask=True)
    to, tm = ptt.nn.functional.max_pool3d(torch.from_numpy(x3), 3, return_mask=True)
    np.testing.assert_array_equal(ptt.nn.MaxUnPool3D(3)(to, tm).numpy(),
                                  np.asarray(paddle.nn.MaxUnPool3D(3)(jo, jm)._value))


# ---- initializers -----------------------------------------------------------

_N = (256, 1024)  # 2^18 draws: the std of a draw within 0.2% (1 sigma) of the true one
_RANDOM_INITS = [("Normal", (0.5, 2.0), _N), ("Uniform", (-0.5, 1.5), _N),
                 ("TruncatedNormal", (0.0, 1.0), _N),
                 ("TruncatedNormal", (1.0, 0.5, -1.0, 1.5), _N),
                 ("XavierUniform", (), _N), ("XavierNormal", (), _N),
                 ("XavierNormal", (None, None, 2.0), (256, 128, 3, 3)),
                 ("KaimingUniform", (), (256, 128, 3, 3)), ("KaimingNormal", (), _N),
                 ("KaimingNormal", (None, 0.2), _N),
                 ("Orthogonal", (), (512, 512)), ("Orthogonal", (1.5,), (128, 512, 2, 2))]
_BOUNDED = ("Uniform", "XavierUniform", "KaimingUniform", "TruncatedNormal")


@pytest.mark.parametrize("name,args,shape", _RANDOM_INITS,
                         ids=[f"{n}{list(a)}{list(s)}" for n, a, s in _RANDOM_INITS])
def test_random_initializer_moments_match_jax(name, args, shape):
    """RNG streams differ (C-trap3): a random initializer's draw of 2^18
    values is held to the JAX package's by its mean (the two within 5
    standard errors of their difference) and its std within 1%; a bounded
    draw stays within the JAX draw's range (plus 1% of it); Orthogonal also
    by W W^T = gain^2 I on its short side."""
    paddle.seed(0)
    ptt.seed(0)
    want = np.asarray(getattr(paddle.nn.initializer, name)(*args)(shape, "float32"))
    got = getattr(ptt.nn.initializer, name)(*args)(shape, torch.float32, "cpu").numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert abs(got.mean() - want.mean()) <= 5 * want.std() * math.sqrt(2.0 / want.size)
    assert abs(got.std() / want.std() - 1.0) < 0.01
    if name in _BOUNDED:
        span = 0.01 * (want.max() - want.min())
        assert want.min() - span <= got.min() and got.max() <= want.max() + span
    if name == "Orthogonal":
        flat = got.reshape(shape[0], -1)
        short = flat @ flat.T if flat.shape[0] <= flat.shape[1] else flat.T @ flat
        gain = args[0] if args else 1.0
        np.testing.assert_allclose(short, gain ** 2 * np.eye(short.shape[0]), atol=1e-4)


def test_deterministic_initializers_match_jax_exactly():
    """Assign, Dirac, Bilinear and calculate_gain equal the JAX package's;
    set_global_initializer's weight and bias initializers apply to every
    parameter made after it whose attr names none, ahead of the layer's
    default, until it is reset (the JAX package's raises)."""
    value = np.arange(12, dtype=np.float32).reshape(3, 4)
    cases = [("Assign", (value,), (3, 4)), ("Assign", (value.tolist(),), (4, 3)),
             ("Dirac", (), (4, 2, 3, 3)), ("Dirac", (2,), (6, 3, 3)),
             ("Bilinear", (), (2, 3, 4, 4)), ("Bilinear", (), (1, 1, 3, 3))]
    for name, args, shape in cases:
        want = np.asarray(getattr(paddle.nn.initializer, name)(*args)(shape, "float32"))
        got = getattr(ptt.nn.initializer, name)(*args)(shape, torch.float32, "cpu").numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    for nl, param in (("sigmoid", None), ("tanh", None), ("relu", None), ("leaky_relu", None),
                      ("leaky_relu", 0.2), ("selu", None), ("conv2d", None), ("unknown", None)):
        assert ptt.nn.initializer.calculate_gain(nl, param) == \
            paddle.nn.initializer.calculate_gain(nl, param)
    init = ptt.nn.initializer
    init.set_global_initializer(init.Constant(0.5), init.Constant(-1.0))
    try:
        lin = ptt.nn.Linear(3, 2)
        own = ptt.nn.Linear(3, 2, weight_attr=ptt.ParamAttr(initializer=init.Constant(2.0)))
        assert torch.all(lin.weight == 0.5) and torch.all(lin.bias == -1.0)
        assert torch.all(own.weight == 2.0) and torch.all(own.bias == -1.0)
    finally:
        init.set_global_initializer(None, None)
    assert not torch.all(ptt.nn.Linear(3, 2).weight == 0.5)


# ---- nn.Layer --------------------------------------------------------------

class _JNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(4, 3)
        self.block = paddle.nn.Sequential(paddle.nn.Linear(3, 5), paddle.nn.ReLU())
        self.norm = paddle.nn.BatchNorm1D(5)


class _TNet(ptt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = ptt.nn.Linear(4, 3)
        self.block = ptt.nn.Sequential(ptt.nn.Linear(3, 5), ptt.nn.ReLU())
        self.norm = ptt.nn.BatchNorm1D(5)


def test_layer_methods_match_jax():
    """sublayers/named_sublayers order and names, full_name, state_dict
    names and shapes (Linear [in, out]), set_state_dict/load_dict from the
    JAX package's state with its (missing, unexpected) and shape errors,
    to(dtype="bfloat16")/astype, add_parameter, create_tensor,
    clear_gradients, Parameter.trainable and the forward post hook."""
    paddle.seed(0)
    jn, tn = _JNet(), _TNet()
    assert [n for n, _ in tn.named_sublayers()] == [n for n, _ in jn.named_sublayers()]
    assert [n for n, _ in tn.named_sublayers(prefix="m.", include_self=True)] == \
        [n for n, _ in jn.named_sublayers(prefix="m.", include_self=True)]
    assert [type(layer).__name__.lower() for layer in tn.sublayers()] == \
        [type(layer).__name__.lower() for layer in jn.sublayers()]
    assert (tn.full_name(), jn.full_name()) == ("_tnet", "_jnet")
    assert tn.fc.full_name() == jn.fc.full_name() == "linear"
    jstate = {k: np.asarray(v._value) for k, v in jn.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in tn.state_dict().items()} == \
        {k: v.shape for k, v in jstate.items()}
    assert tn.set_state_dict(jstate) == ([], [])
    assert all(np.array_equal(tn.state_dict()[k].numpy(), v) for k, v in jstate.items())
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    tn.eval()
    jn.eval()
    np.testing.assert_allclose(tn.block(tn.fc(torch.from_numpy(x))).detach().numpy(),
                               np.asarray(jn.block(jn.fc(paddle.to_tensor(x)))._value),
                               rtol=1e-5, atol=1e-6)
    extra = dict(jstate, **{"nope": np.zeros(1, np.float32)})
    del extra["fc.bias"]
    assert tn.load_dict(extra) == (["fc.bias"], ["nope"])
    with pytest.raises(ValueError):
        tn.set_state_dict({"fc.weight": np.zeros((3, 4), np.float32)})
    tn.to(dtype="bfloat16")
    assert tn.fc.weight.dtype == torch.bfloat16 and tn.norm._mean.dtype == torch.bfloat16
    tn.astype("float32")
    assert tn.fc.weight.dtype == torch.float32
    tn.to("cpu", "float64")
    assert tn.fc.weight.dtype == torch.float64 and tn.fc.weight.device.type == "cpu"
    tn.to(dtype=torch.float32)
    p = ptt.nn.Parameter(torch.zeros(3), trainable=False)
    assert not p.trainable and p.stop_gradient
    p.trainable = True
    assert p.requires_grad
    assert tn.add_parameter("extra", p) is p and "extra" in dict(tn.named_parameters())
    t = tn.create_tensor(dtype="int64")
    assert t.dtype == torch.int64 and t.shape == ()
    tn.fc(torch.ones(1, 4)).sum().backward()
    assert tn.fc.weight.grad is not None
    tn.clear_gradients()
    assert tn.fc.weight.grad is None
    seen = []
    h = tn.fc.register_forward_post_hook(lambda layer, ins, out: seen.append(out.shape) or out * 0)
    assert torch.count_nonzero(tn.fc(torch.ones(1, 4))) == 0 and seen == [(1, 3)]
    h.remove()
    assert torch.count_nonzero(tn.fc(torch.ones(1, 4))) > 0


def test_containers():
    """LayerDict keeps insertion order and its sublayers' parameters;
    ParameterList names its parameters by index, as the JAX package's do."""
    paddle.seed(0)
    jd = paddle.nn.LayerDict({"a": paddle.nn.Linear(2, 3), "b": paddle.nn.Linear(3, 1)})
    td = ptt.nn.LayerDict({"a": ptt.nn.Linear(2, 3), "b": ptt.nn.Linear(3, 1)})
    assert list(td.keys()) == list(jd.keys()) and "a" in td and len(td) == 2
    assert [n for n, _ in td.named_parameters()] == [n for n, _ in jd.named_parameters()]
    td["c"] = ptt.nn.ReLU()
    assert isinstance(td.pop("c"), ptt.nn.ReLU) and len(td) == 2
    jp = paddle.nn.ParameterList([paddle.nn.Layer().create_parameter([2]) for _ in range(3)])
    tp = ptt.nn.ParameterList([ptt.nn.Layer().create_parameter([2]) for _ in range(3)])
    assert [n for n, _ in tp.named_parameters()] == [n for n, _ in jp.named_parameters()]
    assert len(tp) == 3 and tp[-1] is list(tp)[2]


# ---- clipping and nn.utils -------------------------------------------------

def _pair_grads(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(3, 4).astype(np.float32) * 3, rng.randn(5).astype(np.float32)]


def test_clip_layers_match_jax():
    """ClipGradByValue and ClipGradByNorm on (param, grad) pairs, a
    need_clip=False parameter passing through, against the JAX package's."""
    grads = _pair_grads()
    for jc, tc in ((paddle.nn.ClipGradByValue(0.5, -0.2), ptt.nn.ClipGradByValue(0.5, -0.2)),
                   (paddle.nn.ClipGradByNorm(1.5), ptt.nn.ClipGradByNorm(1.5))):
        jps = [paddle.nn.Layer().create_parameter(list(g.shape)) for g in grads]
        tps = [ptt.nn.Layer().create_parameter(list(g.shape)) for g in grads]
        jps[1].need_clip = tps[1].need_clip = False
        want = jc([(p, paddle.to_tensor(g)) for p, g in zip(jps, grads)])
        got = tc([(p, torch.from_numpy(g)) for p, g in zip(tps, grads)])
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w._value), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("where,norm_type", [("nn", 2.0), ("utils", 2.0), ("utils", 1.0),
                                             ("utils", float("inf"))])
def test_clip_grad_norm_matches_jax(where, norm_type):
    grads = _pair_grads(1)
    res = {}
    for pkg in (paddle, ptt):
        ps = [pkg.nn.Layer().create_parameter(list(g.shape)) for g in grads]
        for p, g in zip(ps, grads):
            if pkg is paddle:
                p.grad = paddle.to_tensor(g)
            else:
                p.grad = torch.from_numpy(g.copy())
        fn = pkg.nn.clip_grad_norm_ if where == "nn" else pkg.nn.utils.clip_grad_norm_
        total = fn(ps, 2.0, norm_type=norm_type) if where == "utils" else fn(ps, 2.0)
        res[pkg] = ([np.asarray(p.grad._value) if pkg is paddle else p.grad.numpy() for p in ps],
                    float(np.asarray(getattr(total, "_value", total))))
    (tg, tt), (jg, jt) = res[ptt], res[paddle]
    assert math.isclose(tt, jt, rel_tol=1e-5)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_clip_grad_value_and_vectors():
    ps = [ptt.nn.Layer().create_parameter([3, 2]), ptt.nn.Layer().create_parameter([4])]
    vec = ptt.nn.utils.parameters_to_vector(ps)
    assert tuple(vec.shape) == (10,)
    ptt.nn.utils.vector_to_parameters(torch.arange(10.0), ps)
    assert ps[0].tolist() == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]] and ps[1].tolist()[0] == 6.0
    ps[0].grad = torch.full((3, 2), 5.0)
    ptt.nn.utils.clip_grad_value_(ps, 1.5)
    assert torch.all(ps[0].grad == 1.5)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(dim):
    """weight_norm(Linear) over a non-square [in, out] weight (C1 makes
    dim=0 mean paddle's axis): weight_v/weight_g parameters in the JAX
    package's order and shapes, the same forward and gradients, and
    remove_weight_norm folding back to one weight."""
    paddle.seed(0)
    jl, tl = paddle.nn.Linear(4, 3), ptt.nn.Linear(4, 3)
    tl.set_state_dict({k: np.asarray(v._value) for k, v in jl.state_dict().items()})
    paddle.nn.utils.weight_norm(jl, dim=dim)
    ptt.nn.utils.weight_norm(tl, dim=dim)
    jnames = {n: tuple(p.shape) for n, p in jl.named_parameters()}
    assert {n: tuple(p.shape) for n, p in tl.named_parameters()} == jnames
    assert list(dict(tl.named_parameters())) == list(jnames)
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    got, ggrads = _run(ptt, tl, [x])
    want, wgrads = _run(paddle, jl, [x])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for k, w in wgrads.items():
        np.testing.assert_allclose(ggrads[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
    paddle.nn.utils.remove_weight_norm(jl)
    ptt.nn.utils.remove_weight_norm(tl)
    assert [n for n, _ in tl.named_parameters()] == [n for n, _ in jl.named_parameters()]
    np.testing.assert_allclose(tl.weight.detach().numpy(), np.asarray(jl.weight._value),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("iters", [1, 3])
def test_spectral_norm_matches_jax(iters):
    """spectral_norm(Linear): weight_orig and the weight_u buffer (from the
    same fixed numpy draw), w / sigma and its gradients equal the JAX
    package's over two calls (u carried between them)."""
    paddle.seed(0)
    jl, tl = paddle.nn.Linear(5, 3), ptt.nn.Linear(5, 3)
    tl.set_state_dict({k: np.asarray(v._value) for k, v in jl.state_dict().items()})
    paddle.nn.utils.spectral_norm(jl, n_power_iterations=iters)
    ptt.nn.utils.spectral_norm(tl, n_power_iterations=iters)
    assert list(tl.state_dict()) == list(jl.state_dict())
    x = np.random.RandomState(2).randn(2, 5).astype(np.float32)
    for _ in range(2):
        got, ggrads = _run(ptt, tl, [x])
        want, wgrads = _run(paddle, jl, [x])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl.weight_u.numpy(), np.asarray(jl.weight_u._value),
                                   rtol=1e-5, atol=1e-6)
        for k, w in wgrads.items():
            np.testing.assert_allclose(ggrads[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
        for p in tl.parameters():
            p.grad = None
        for p in jl.parameters():
            p.clear_grad()


# ---- the names ---------------------------------------------------------------

JAX_ONLY = {"jax", "jnp", "np", "apply", "annotations", "search_ops_addendum", "dtype_mod",
            "random_mod"}
# the top level's names that wait for later slices (ROADMAP Queue A items 2-6)
LATER = {"DataParallel", "Model", "audio", "callbacks", "cost_model", "distribution", "fft",
         "flops", "geometric", "hapi", "hub", "io", "native", "onnx", "signal", "sparse",
         "static", "summary", "sysconfig", "telemetry", "text", "version", "apply_nograd",
         "builtins", "builtins_max", "exponent_bits", "logit_raw", "compile_cache"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("path", ["nn", "nn.functional", "nn.initializer"])
def test_nn_names_cover_the_jax_package(path):
    jmod, tmod = paddle, ptt
    for part in path.split("."):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    assert sorted(_public(jmod) - _public(tmod) - JAX_ONLY) == []
    layer_methods = {n for n in dir(paddle.nn.Layer) if not n.startswith("_")}
    assert sorted(n for n in layer_methods if not hasattr(ptt.nn.Layer, n)) == []


def test_top_level_names():
    """Every top-level name of the JAX package is in the port but those of
    later slices; the new ones behave as paddle's: places, dtypes and
    their info, the rng states, device queries, TPU truth."""
    assert sorted(_public(paddle) - _public(ptt) - JAX_ONLY - LATER) == []
    assert ptt.ParamAttr is ptt.nn.ParamAttr and ptt.to_static is ptt.jit.to_static
    assert ptt.TrainingGuardian is ptt.framework.guardian.TrainingGuardian
    assert issubclass(ptt.GuardianAnomaly, FloatingPointError)
    assert ptt.DesyncDetector and ptt.FlightRecorder and ptt.profiler.Profiler
    assert ptt.bool_ is ptt.bool8 is torch.bool and isinstance(ptt.float32, ptt.dtype)
    assert ptt.float8_e4m3fn == torch.float8_e4m3fn
    assert ptt.finfo("bfloat16").eps == float(paddle.finfo("bfloat16").eps)
    assert ptt.iinfo("int32").max == paddle.iinfo("int32").max
    assert ptt.CPUPlace() == ptt.Place("cpu") == "cpu" and ptt.CPUPlace().is_cpu_place()
    assert ptt.CUDAPlace(0).device_type == "gpu" and ptt.CUDAPinnedPlace().is_cpu_place()
    assert not ptt.is_compiled_with_tpu() and not ptt.device.is_compiled_with_tpu()
    with pytest.raises(RuntimeError):
        ptt.TPUPlace()
    assert ptt.convert_dtype("float16") == torch.float16 and ptt.in_dynamic_or_pir_mode()
    assert ptt.device_count("cpu") == 1 and hasattr(ptt.device, "cuda")
    with ptt.device_guard("cpu"), ptt.LazyGuard():
        pass
    assert list(ptt.batch(lambda: iter(range(5)), 2)()) == [[0, 1], [2, 3], [4]]
    assert list(ptt.batch(lambda: iter(range(5)), 2, drop_last=True)()) == [[0, 1], [2, 3]]
    with pytest.raises(ValueError):
        ptt.check_shape([2, -1])
    ptt.check_shape([2, torch.tensor(3)])
    ptt.seed(5)
    ptt.rand([3])
    state, cuda_state = ptt.get_rng_state(), ptt.get_cuda_rng_state()
    a = ptt.rand([4])
    ptt.set_rng_state(state)
    assert torch.equal(ptt.rand([4]), a)
    ptt.set_cuda_rng_state(cuda_state)
    assert torch.equal(ptt.rand([4]), a)
    np.testing.assert_allclose(ptt.pdist(torch.tensor([[0.0, 0.0], [3.0, 4.0]])).numpy(), [5.0])


@pytest.mark.parametrize("causal,scale", [(False, None), (True, 0.2)])
def test_flash_attn_unpadded_matches_jax_per_sequence(causal, scale):
    """flash_attn_unpadded over sequences packed by cu_seqlens equals the
    JAX package's scaled_dot_product_attention of each sequence (with q
    scaled by scale * sqrt(D) for another scale); the JAX package's own
    flash_attn_unpadded raises."""
    rng = np.random.RandomState(0)
    cu = np.array([0, 3, 8, 12], np.int64)
    q, k, v = (rng.randn(12, 2, 8).astype(np.float32) for _ in range(3))
    got, none = ptt.nn.functional.flash_attn_unpadded(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(cu), torch.from_numpy(cu),
        5, 5, scale=scale, causal=causal)
    assert none is None and tuple(got.shape) == (12, 2, 8)
    qs = q * (scale * np.sqrt(8.0)) if scale is not None else q
    for a, b in zip(cu[:-1], cu[1:]):
        want = paddle.nn.functional.scaled_dot_product_attention(
            *(paddle.to_tensor(t[None, a:b]) for t in (qs, k, v)), is_causal=causal)
        np.testing.assert_allclose(got[a:b].numpy(), np.asarray(want._value)[0], rtol=1e-5,
                                   atol=1e-6)
    from paddle_tpu.nn.functional import attention as jattention

    with pytest.raises(NotImplementedError):
        jattention.flash_attn_unpadded(q, k, v, cu, cu, 5, 5)
    with pytest.raises(NotImplementedError, match="distributed"):
        ptt.nn.SyncBatchNorm(4)
