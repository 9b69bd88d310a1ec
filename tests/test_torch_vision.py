"""Port parity for the ResNet slice: conv, pooling, batch norm and
cross_entropy against the JAX package on the same seeded numpy inputs (f32
at rtol 1e-5, and under AMP O1 bf16 at 2e-2 relative L2 with every dtype
equal), and bench.py's build_resnet_step run as written in the port. The
ResNet family's names and its training against the JAX package are in
test_torch_vision_resnet.py (their JAX runs are one module fixture of
~160 s on an 8-core CPU host: a file of its own, so it is handed to a
worker apart from this one's tests)."""
import os
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import detection as tdet
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import ocr as tocr
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu, state_to_paddle_tpu
from paddle_tpu_torch.vision import models as tmodels

AMP_REL_L2 = 2e-2
F32_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v._value, jnp.float32))


def _dtype(v) -> str:
    return str(v.dtype).split(".")[-1] if isinstance(v, torch.Tensor) else str(v._value.dtype)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close(got, want, amp, what=""):
    """f32: each element within rtol 1e-5 (and 1e-5 of the largest value
    absolute); AMP: the tensor within 2e-2 relative L2. Dtypes equal."""
    assert _dtype(got) == _dtype(want), (what, _dtype(got), _dtype(want))
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if amp:
        assert _rel_l2(g, w) <= AMP_REL_L2, (what, _rel_l2(g, w))
    else:
        np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_RTOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=what)


def _run_both(fn_j, fn_t, arrays, amp, low_inputs=(), cot_seed=0):
    """fn over leaves made from `arrays` in both packages (under auto_cast
    O1 bf16 with amp; inputs named in `low_inputs` enter as bf16, as a
    bf16 op's output would), a seeded cotangent on the output; -> the
    outputs and the leaves' grads, JAX's and the port's."""
    res = {}
    for pkg in ("jax", "port"):
        leaves, args = {}, {}
        for k, a in arrays.items():
            if a.dtype.kind == "f":
                leaf = (paddle.to_tensor(a, stop_gradient=False) if pkg == "jax"
                        else torch.from_numpy(a.copy()).requires_grad_(True))
                leaves[k] = leaf
                args[k] = leaf.astype("bfloat16") if pkg == "jax" and k in low_inputs else (
                    leaf.to(torch.bfloat16) if k in low_inputs else leaf)
            else:
                args[k] = paddle.to_tensor(a) if pkg == "jax" else torch.from_numpy(a.copy())
        cast = paddle.amp.auto_cast if pkg == "jax" else ptt.amp.auto_cast
        with cast(enable=amp, level="O1", dtype="bfloat16"):
            out = (fn_j if pkg == "jax" else fn_t)(**args)
        cot = np.asarray(np.random.RandomState(cot_seed).randn(*_np(out).shape), np.float32)
        if pkg == "jax":
            (out * paddle.to_tensor(cot)).sum().backward()
        else:
            (out * torch.from_numpy(cot)).sum().backward()
        res[pkg] = (out, {k: v.grad for k, v in leaves.items()})
    return res["jax"], res["port"]


def _check(jax_res, port_res, amp):
    (oj, gj), (ot, gt) = jax_res, port_res
    _close(ot, oj, amp, "out")
    for k in gj:
        _close(gt[k], gj[k], amp, f"grad {k}")


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

CONV_CASES = {
    "int_pad": ((2, 4, 9, 9), (6, 4, 3, 3), dict(padding=1)),
    "per_dim_pad_stride": ((2, 4, 9, 9), (6, 4, 3, 3), dict(padding=[1, 2], stride=[2, 1])),
    "asym_2n_pad": ((2, 4, 9, 9), (6, 4, 3, 3), dict(padding=[0, 1, 2, 0], stride=2)),
    "full_rank_pad_1d": ((2, 4, 11), (6, 4, 3), dict(padding=[[0, 0], [0, 0], [1, 2]])),
    "full_rank_pad_3d": ((2, 4, 5, 6, 5), (6, 4, 3, 3, 3),
                         dict(padding=[[0, 0], [0, 0], [1, 0], [0, 1], [1, 1]])),
    "same_stride2": ((2, 4, 10, 10), (6, 4, 3, 3), dict(padding="SAME", stride=2)),  # pads (0, 1)
    "same_k4": ((2, 4, 9, 9), (6, 4, 4, 4), dict(padding="same")),  # pads (1, 2)
    "valid": ((2, 4, 9, 9), (6, 4, 3, 3), dict(padding="VALID", stride=2)),
    "groups": ((2, 4, 9, 9), (6, 2, 3, 3), dict(padding=1, groups=2)),
    "dilation": ((2, 4, 9, 9), (6, 4, 3, 3), dict(padding=2, dilation=2)),
    "nhwc": ((2, 9, 9, 4), (6, 4, 3, 3), dict(padding=1, stride=2, data_format="NHWC")),
    "bias": ((2, 4, 9, 9), (6, 4, 3, 3), dict(padding=1, bias=True)),
    "conv1d": ((2, 4, 11), (6, 4, 3), dict(padding=[1, 0], stride=2)),
    "conv3d": ((2, 4, 5, 6, 5), (6, 4, 3, 3, 3), dict(padding=1, stride=[1, 2, 1])),
}


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp_o1"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_jax(case, amp):
    """conv over the padding forms (int, per dim, 2n asymmetric, full-rank,
    SAME at stride 2 and an even kernel, VALID), stride, groups, dilation,
    NHWC, a bias, 1-d and 3-d: the output and the grads of x, the weight
    and the bias. Under O1 the conv runs in bf16 (a white-listed op)."""
    xs, ws, kw = CONV_CASES[case]
    kw = dict(kw)
    rng = np.random.RandomState(len(case))
    arrays = dict(x=rng.randn(*xs).astype(np.float32), weight=rng.randn(*ws).astype(np.float32))
    if kw.pop("bias", False):
        arrays["bias"] = rng.randn(ws[0]).astype(np.float32)
    fname = {3: "conv1d", 4: "conv2d", 5: "conv3d"}[len(xs)]
    jf, tf = getattr(paddle.nn.functional, fname), getattr(ptt.nn.functional, fname)
    jr, tr = _run_both(lambda **a: jf(**a, **kw), lambda **a: tf(**a, **kw), arrays, amp)
    assert _dtype(tr[0]) == ("bfloat16" if amp else "float32")
    _check(jr, tr, amp)


def test_padding_forms_the_jax_package_refuses():
    """Two reference-side faults the port does not copy. A 2-d full-rank
    padding has 2n entries: the JAX package reads it as the 2n form and
    fails; the port reads the last two pairs, as at every other rank. The
    JAX package's pools fail on "SAME"/"VALID"; the port pads them as XLA
    pads a SAME window (total // 2 low), as its convs do."""
    rng = np.random.RandomState(2)
    x, w = rng.randn(2, 4, 9, 9).astype(np.float32), rng.randn(6, 4, 3, 3).astype(np.float32)
    full = [[0, 0], [0, 0], [1, 0], [0, 2]]
    with pytest.raises(ValueError):
        paddle.nn.functional.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), padding=full)
    F = ptt.nn.functional
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(F.conv2d(xt, wt, padding=full), F.conv2d(xt, wt, padding=[1, 0, 0, 2]))
    assert torch.equal(F.max_pool2d(xt, 3, padding=full), F.max_pool2d(xt, 3, padding=[1, 0, 0, 2]))
    with pytest.raises(TypeError):
        paddle.nn.functional.max_pool2d(paddle.to_tensor(x), 3, 2, padding="SAME")
    # 9 -> 5 windows of 3 at stride 2: 2 cells of padding, one each side
    assert torch.equal(F.max_pool2d(xt, 3, 2, padding="SAME"), F.max_pool2d(xt, 3, 2, padding=1))
    assert torch.equal(F.avg_pool2d(xt[..., :8], 3, 2, padding="SAME"),
                       F.avg_pool2d(xt[..., :8], 3, 2, padding=[1, 1, 0, 1]))


def test_conv_layer_init_and_refusals():
    """Conv2D draws its weight from U(-k, k), k = 1/sqrt(in/groups * kh *
    kw), its bias zeros; bias_attr=False gives none. The transposed convs
    draw their [in, out/groups, *k] weight from the JAX package's U(-k, k)
    with the same fan_in = in/groups * prod(k) (not torch's init), their
    bias zeros. A padding mode other than zeros raises; max_pool2d's
    return_mask gives the JAX package's flat indices of the maxima."""
    ptt.seed(0)
    conv = ptt.nn.Conv2D(64, 128, 3, groups=2)
    k = 1.0 / np.sqrt(32 * 9)
    w = conv.weight.detach()
    assert tuple(w.shape) == (128, 32, 3, 3) and w.abs().max().item() <= k
    assert abs(w.std().item() / (k / np.sqrt(3.0)) - 1.0) < 0.05
    assert torch.count_nonzero(conv.bias).item() == 0
    assert ptt.nn.Conv2D(3, 4, 1, bias_attr=False).bias is None
    for layer, shape, fan_in in ((ptt.nn.Conv2DTranspose(64, 96, 3, groups=2), (64, 48, 3, 3), 32 * 9),
                                 (ptt.nn.Conv1DTranspose(48, 64, 5), (48, 64, 5), 48 * 5),
                                 (ptt.nn.Conv3DTranspose(32, 16, 2, stride=2), (32, 16, 2, 2, 2),
                                  32 * 8)):
        k = 1.0 / np.sqrt(fan_in)
        w = layer.weight.detach()
        assert tuple(w.shape) == shape and w.abs().max().item() <= k, type(layer).__name__
        assert abs(w.std().item() / (k / np.sqrt(3.0)) - 1.0) < 0.05, type(layer).__name__
        assert tuple(layer.bias.shape) == (shape[1] * layer._groups,)
        assert torch.count_nonzero(layer.bias).item() == 0
    assert ptt.nn.Conv2DTranspose(4, 4, 2, bias_attr=False).bias is None
    up = ptt.nn.Conv2DTranspose(4, 6, 2, stride=2)
    assert tuple(up(torch.zeros(1, 4, 3, 5)).shape) == (1, 6, 6, 10)
    with pytest.raises(NotImplementedError):
        ptt.nn.Conv2D(3, 4, 3, padding_mode="reflect")
    x = np.random.RandomState(0).randn(1, 2, 5, 5).astype(np.float32)
    out, mask = ptt.nn.functional.max_pool2d(torch.from_numpy(x), 2, 2, padding=1,
                                             return_mask=True)
    jout, jmask = paddle.nn.functional.max_pool2d(paddle.to_tensor(x), 2, 2, padding=1,
                                                  return_mask=True)
    assert torch.equal(out, torch.from_numpy(np.asarray(jout._value)))
    assert torch.equal(mask, torch.from_numpy(np.asarray(jmask._value)))


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

POOL_CASES = {
    "max2d_stem": ("max_pool2d", (2, 3, 10, 10), dict(kernel_size=3, stride=2, padding=1)),
    "max2d_ceil": ("max_pool2d", (2, 3, 10, 10), dict(kernel_size=3, stride=2, ceil_mode=True)),
    "max2d_ceil_pad": ("max_pool2d", (2, 3, 9, 11), dict(kernel_size=3, stride=2, padding=1,
                                                         ceil_mode=True)),
    "max2d_asym": ("max_pool2d", (2, 3, 10, 10), dict(kernel_size=2, padding=[0, 1, 1, 0])),
    "max2d_nhwc": ("max_pool2d", (2, 10, 10, 3), dict(kernel_size=3, stride=2, padding=1,
                                                      data_format="NHWC")),
    "avg2d_exclusive": ("avg_pool2d", (2, 3, 10, 10), dict(kernel_size=3, stride=2, padding=1)),
    "avg2d_inclusive": ("avg_pool2d", (2, 3, 10, 10), dict(kernel_size=3, stride=2, padding=1,
                                                           exclusive=False)),
    "avg2d_ceil_exclusive": ("avg_pool2d", (2, 3, 10, 11), dict(kernel_size=3, stride=2, padding=1,
                                                                ceil_mode=True)),
    "avg2d_ceil_inclusive": ("avg_pool2d", (2, 3, 10, 11), dict(kernel_size=3, stride=2,
                                                                ceil_mode=True, exclusive=False)),
    "avg2d_divisor": ("avg_pool2d", (2, 3, 10, 10), dict(kernel_size=3, stride=2, padding=1,
                                                         divisor_override=5)),
    "avg2d_nhwc": ("avg_pool2d", (2, 10, 10, 3), dict(kernel_size=2, data_format="NHWC")),
    "adaptive2d_non_dividing": ("adaptive_avg_pool2d", (2, 3, 10, 9), dict(output_size=(3, 4))),
    "adaptive2d_one": ("adaptive_avg_pool2d", (2, 3, 7, 7), dict(output_size=1)),
    "adaptive2d_none": ("adaptive_avg_pool2d", (2, 3, 10, 9), dict(output_size=(None, 4))),
    "max1d_ceil": ("max_pool1d", (2, 3, 20), dict(kernel_size=3, stride=2, ceil_mode=True)),
    "avg1d_ceil": ("avg_pool1d", (2, 3, 20), dict(kernel_size=4, stride=3, padding=1,
                                                  ceil_mode=True)),
    "adaptive1d": ("adaptive_avg_pool1d", (2, 3, 20), dict(output_size=6)),
    "max3d": ("max_pool3d", (2, 2, 5, 6, 7), dict(kernel_size=2, stride=2, padding=1)),
    "avg3d_ceil": ("avg_pool3d", (2, 2, 5, 6, 7), dict(kernel_size=3, stride=2, ceil_mode=True)),
    "adaptive3d": ("adaptive_avg_pool3d", (2, 2, 5, 6, 7), dict(output_size=(2, 4, 3))),
}


def _distinct(shape, rng):
    """Values k/16 - c with the k distinct within each map (spatial extent
    < 256 cells): exact in bf16 and without ties, so a max pool's
    gradient goes to one cell in both packages."""
    spatial = int(np.prod(shape[2:])) if len(shape) > 2 else shape[-1]
    n = int(np.prod(shape)) // spatial
    maps = np.stack([rng.permutation(spatial) for _ in range(n)]).astype(np.float32)
    return ((maps - spatial / 2) / 16.0).reshape(shape)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp_o1_bf16_input"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_jax(case, amp):
    """max/avg/adaptive pools in 1-3 dims against the JAX package: ceil_mode
    (the JAX package extends the high pad to a whole window; torch's own
    ceil_mode would drop some), -inf pads for max, exclusive and inclusive
    averages, divisor_override, SAME, NHWC, non-dividing adaptive bins.
    Pools are on no AMP list: with amp the input enters as bf16 and the
    output stays bf16 in both."""
    fname, shape, kw = POOL_CASES[case]
    x = _distinct(shape, np.random.RandomState(len(case)))
    jf, tf = getattr(paddle.nn.functional, fname), getattr(ptt.nn.functional, fname)
    jr, tr = _run_both(lambda x: jf(x, **kw), lambda x: tf(x, **kw), dict(x=x), amp,
                       low_inputs=("x",) if amp else ())
    assert _dtype(tr[0]) == ("bfloat16" if amp else "float32")
    _check(jr, tr, amp)


def test_pool_layers_call_their_functional():
    x = torch.from_numpy(_distinct((2, 3, 10, 10), np.random.RandomState(0)))
    F = ptt.nn.functional
    assert torch.equal(ptt.nn.MaxPool2D(kernel_size=3, stride=2, padding=1)(x),
                       F.max_pool2d(x, 3, 2, 1))
    assert torch.equal(ptt.nn.AvgPool2D(3, 2, 1, ceil_mode=True, exclusive=False)(x),
                       F.avg_pool2d(x, 3, 2, 1, ceil_mode=True, exclusive=False))
    assert torch.equal(ptt.nn.AdaptiveAvgPool2D((1, 1))(x), F.adaptive_avg_pool2d(x, 1))
    assert tuple(ptt.nn.MaxPool2D(3, 2, ceil_mode=True)(x).shape) == (2, 3, 5, 5)


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp_o1"])
@pytest.mark.parametrize("training,shape", [(True, (4, 6, 5, 5)), (False, (4, 6, 5, 5)),
                                            (True, (8, 6))])
def test_batch_norm_matches_jax(training, shape, amp):
    """functional batch_norm, 3 calls on 3 inputs from the same buffers:
    each output and the grads of x, weight and bias, and both buffers
    after the 3 calls (training: paddle's momentum, the biased batch
    variance; eval: the buffers, unchanged). Under O1 x enters as bf16
    (a conv's output): its statistics are bf16 and the output f32."""
    rng = np.random.RandomState(7)
    c = shape[1]
    w = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    b = (0.2 * rng.randn(c)).astype(np.float32)
    mean0 = (0.1 * rng.randn(c)).astype(np.float32)
    var0 = (1.0 + 0.3 * rng.rand(c)).astype(np.float32)
    bufs = {"jax": (paddle.to_tensor(mean0), paddle.to_tensor(var0)),
            "port": (torch.from_numpy(mean0.copy()), torch.from_numpy(var0.copy()))}
    for call in range(3):
        x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
        jm, jv = bufs["jax"]
        tm, tv = bufs["port"]
        jr, tr = _run_both(
            lambda x, weight, bias: paddle.nn.functional.batch_norm(
                x, jm, jv, weight, bias, training=training, momentum=0.9, epsilon=1e-5),
            lambda x, weight, bias: ptt.nn.functional.batch_norm(
                x, tm, tv, weight, bias, training=training, momentum=0.9, epsilon=1e-5),
            dict(x=x, weight=w, bias=b), amp, low_inputs=("x",) if amp else (), cot_seed=call)
        assert _dtype(tr[0]) == "float32"
        _check(jr, tr, amp)
    for j, t, name in zip(bufs["jax"], bufs["port"], ("_mean", "_variance")):
        assert t.dtype == torch.float32
        # the buffers mix the batch statistics in at 0.1; in bf16 those
        # are rounded the same way in both packages, so the buffers agree
        # far below bf16's precision (f32 statistics would miss by ~2e-4)
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-6, err_msg=name)
        moved = not np.array_equal(_np(t), mean0 if name == "_mean" else var0)
        assert moved == training, name


def test_batch_norm_layers():
    """Weight ones, bias zeros, f32 buffers _mean (zeros) and _variance
    (ones) under those names; eval and use_global_stats normalize with the
    buffers and leave them alone; the legacy BatchNorm applies `act`."""
    bn = ptt.nn.BatchNorm2D(3)
    assert [n for n, _ in bn.named_parameters()] == ["weight", "bias"]
    assert [n for n, _ in bn.named_buffers()] == ["_mean", "_variance"]
    assert bool((bn.weight == 1).all()) and bool((bn._variance == 1).all())
    x = torch.randn(4, 3, 5, 5) + 3.0
    bn(x)
    assert abs(bn._mean.mean().item() - 0.3) < 0.05
    for layer in (bn.eval(), ptt.nn.BatchNorm2D(3, use_global_stats=True)):
        before = layer._mean.clone()
        out = layer(x)
        assert torch.equal(layer._mean, before)
        want = (x - before[None, :, None, None]) / torch.sqrt(layer._variance[None, :, None, None]
                                                              + 1e-5)
        torch.testing.assert_close(out, want)
    relu_bn = ptt.nn.BatchNorm(3, act="relu")
    assert bool((relu_bn(x - 3.0) >= 0).all())


# ---------------------------------------------------------------------------
# cross_entropy
# ---------------------------------------------------------------------------

CE_CASES = {
    "hard": dict(),
    "hard_n1_labels": dict(label_shape="n1"),
    "ignore_index": dict(ignore=True),
    "ignore_custom": dict(ignore_index=3),
    "weight": dict(weight=True),
    "weight_ignore": dict(weight=True, ignore=True),
    "smoothing": dict(label_smoothing=0.1),
    "weight_smoothing_ignore": dict(weight=True, ignore=True, label_smoothing=0.2),
    "soft": dict(soft_label=True),
    "soft_smoothing": dict(soft_label=True, label_smoothing=0.1),
    "no_softmax": dict(use_softmax=False),
    "axis1": dict(axis=1),
    "sum": dict(reduction="sum", ignore=True),
    "none": dict(reduction="none", ignore=True),
    "soft_none": dict(soft_label=True, reduction="none"),
}


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp_o1"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_jax(case, amp):
    """cross_entropy in every mode: hard labels [N] or [N, 1], ignore_index,
    class weights, label smoothing, soft labels, use_softmax=False, axis=1
    and reductions none/sum/mean; the loss and the input's grad. Under O1
    the logits enter as bf16 (a linear's output) and the op runs in f32."""
    spec = dict(CE_CASES[case])
    rng = np.random.RandomState(11)
    n, c = 6, 7
    kw = {k: spec[k] for k in ("ignore_index", "label_smoothing", "soft_label", "use_softmax",
                               "reduction", "axis") if k in spec}
    xshape = (3, c, 4) if spec.get("axis") == 1 else (n, c)
    x = rng.randn(*xshape).astype(np.float32) * 2.0
    if spec.get("use_softmax") is False:
        e = np.exp(x - x.max(-1, keepdims=True))
        x = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    arrays = dict(input=x)
    if spec.get("soft_label"):
        s = rng.rand(n, c).astype(np.float32)
        arrays["label"] = s / s.sum(-1, keepdims=True)
    else:
        lbl = rng.randint(0, c, (3, 4) if spec.get("axis") == 1 else (n,)).astype(np.int64)
        if spec.get("ignore"):
            lbl[[1, 4]] = -100
        if "ignore_index" in spec:
            lbl[:3] = 3
        arrays["label"] = lbl[:, None] if spec.get("label_shape") == "n1" else lbl
    if spec.get("weight"):
        arrays["weight"] = (0.5 + rng.rand(c)).astype(np.float32)
    jr, tr = _run_both(lambda **a: paddle.nn.functional.cross_entropy(**a, **kw),
                       lambda **a: ptt.nn.functional.cross_entropy(**a, **kw), arrays, amp,
                       low_inputs=("input",) if amp else ())
    assert _dtype(tr[0]) == "float32"
    _check(jr, tr, amp)
    args = {k: torch.from_numpy(a) for k, a in arrays.items()}
    layer = ptt.nn.CrossEntropyLoss(weight=args.pop("weight", None), **kw)
    assert torch.equal(layer(args["input"], args["label"]),
                       ptt.nn.functional.cross_entropy(args["input"], args["label"],
                                                       weight=layer.weight, **kw))


def test_bench_build_resnet_step_runs_in_port(monkeypatch):
    """bench.py's build_resnet_step, as written, with the port standing in
    for the JAX package (`import paddle_tpu as paddle` and
    `from paddle_tpu.vision.models import resnet50` resolve to the port):
    seed, resnet50(num_classes=1000), Momentum(0.1, weight_decay=1e-4),
    to_tensor, auto_cast O1 bf16, cross_entropy, to_static; 2 steps at
    batch 2, 3x224x224."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        import bench
    finally:
        sys.path.pop(0)
    monkeypatch.setitem(sys.modules, "paddle_tpu", ptt)
    monkeypatch.setitem(sys.modules, "paddle_tpu.vision", ptt.vision)
    monkeypatch.setitem(sys.modules, "paddle_tpu.vision.models", ptt.vision.models)
    model, static_step, eager_step, imgs, labels = bench.build_resnet_step(batch=2)
    assert isinstance(model, tmodels.ResNet) and isinstance(static_step, ptt.jit.StaticFunction)
    assert tuple(imgs.shape) == (2, 3, 224, 224) and len(model.state_dict()) == 267
    losses = [static_step(imgs, labels).item(), eager_step(imgs, labels).item()]
    assert all(np.isfinite(losses)), losses


def test_every_linear_weight_converts():
    """Each nn.Linear of every ported model (Llama, ERNIE MLM and classifier,
    ResNet, CRNN) keeps paddle's [in, out] weight, and every parameter and
    buffer (conv, transposed conv, LSTM, batch norm) crosses to the JAX
    package's numpy layout and back unchanged: utils/convert transposes
    nothing. PPYOLOE and DBNet have no Linear."""
    ptt.seed(0)
    models = [tllama.llama_tiny(), ternie.ErnieForMaskedLM(ternie.ernie_tiny()),
              ternie.ErnieForSequenceClassification(ternie.ernie_tiny(), num_classes=3),
              tmodels.resnet18(num_classes=10), tocr.CRNN(num_classes=11, hidden_size=32),
              tocr.DBNet(8, 32), tdet.PPYOLOE(num_classes=4, base_channels=8, neck_channels=32)]
    for model in models:
        linears = [m for m in model.modules() if isinstance(m, ptt.nn.Linear)]
        assert bool(linears) == (type(model).__name__ not in ("DBNet", "PPYOLOE")), type(model)
        for m in linears:
            assert tuple(m.weight.shape) == (m.in_features, m.out_features), type(model).__name__
        sd = model.state_dict()
        back = state_from_paddle_tpu(state_to_paddle_tpu(sd))
        assert all(torch.equal(back[k], v) for k, v in sd.items()), type(model).__name__
