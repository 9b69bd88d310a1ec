"""Port parity for the PP-OCR slice against the JAX package on the same
seeded numpy inputs, f32: the transposed convs, interpolate, the recurrent
cells and layers, ctc_loss, and the host-side postprocess, decode and
resize. Forward values within rtol 1e-5 / atol 1e-5, gradients within
1e-4 relative L2, the host functions exactly. DBNet, CRNN and OCRSystem
are in test_torch_ocr_models.py: their JAX runs are one module fixture of
~65 s on an 8-core CPU host, in a file of few tests, which the xdist
scheduler hands out after the heavy JAX files."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import ocr as jocr
from paddle_tpu.vision.transforms import functional as jvtf

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import ocr as tocr
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu
from paddle_tpu_torch.vision.transforms import functional as tvtf

RTOL = ATOL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    if isinstance(v, np.ndarray):
        return v
    return np.asarray(jnp.asarray(v._value, jnp.float32))


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close(got, want, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)


def _grad_close(got, want, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert _rel_l2(g, w) <= GRAD_REL, (what, _rel_l2(g, w))


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(pkg, fn, arrays, layer=None, cot_seed=0):
    """fn(**leaves) in one package, then sum(out_k * cot_k) backward with
    seeded cotangents; -> (outputs, input grads, the layer's param grads)."""
    leaves, args = {}, {}
    for k, a in arrays.items():
        if a.dtype.kind == "f":
            leaf = (paddle.to_tensor(a, stop_gradient=False) if pkg == "jax"
                    else torch.from_numpy(a.copy()).requires_grad_(True))
            leaves[k] = args[k] = leaf
        else:
            args[k] = paddle.to_tensor(a) if pkg == "jax" else torch.from_numpy(a.copy())
    outs = _flat(fn(**args))
    rng = np.random.RandomState(cot_seed)
    loss = None
    for o in outs:
        cot = rng.randn(*_np(o).shape).astype(np.float32)
        term = (o * (paddle.to_tensor(cot) if pkg == "jax" else torch.from_numpy(cot))).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    params = {n: p.grad for n, p in layer.named_parameters()} if layer is not None else {}
    return outs, {k: v.grad for k, v in leaves.items()}, params


def _check_both(jres, tres):
    (oj, gj, pj), (ot, gt, pt) = jres, tres
    assert len(oj) == len(ot)
    for i, (a, b) in enumerate(zip(ot, oj)):
        _close(a, b, f"out {i}")
    for k in gj:
        _grad_close(gt[k], gj[k], f"grad {k}")
    assert set(pt) == set(pj)
    for k in pj:
        _grad_close(pt[k], pj[k], f"param grad {k}")


def _np_state(layer):
    return {k: np.array(v._value) for k, v in layer.state_dict().items()}


def _carry(jlayer, tlayer):
    tlayer.load_state_dict(state_from_paddle_tpu(_np_state(jlayer)))
    return tlayer


# ---------------------------------------------------------------------------
# transposed convs
# ---------------------------------------------------------------------------

TCONV_CASES = {  # x shape, weight [in, out/groups, *k], kwargs
    "1d_stride2_output_padding": ((2, 4, 9), (4, 3, 3), dict(stride=2, padding=1,
                                                             output_padding=1)),
    "2d_groups2_bias": ((2, 4, 7, 7), (4, 3, 3, 3), dict(stride=2, padding=1, groups=2,
                                                         bias=True)),
    "2d_dilation2": ((2, 4, 7, 7), (4, 5, 3, 3), dict(padding=2, dilation=2)),
    "2d_stride2_output_padding1": ((2, 4, 6, 6), (4, 5, 3, 3), dict(stride=2, padding=1,
                                                                    output_padding=1)),
    "2d_output_size": ((2, 4, 6, 6), (4, 5, 3, 3), dict(stride=3, padding=1,
                                                        output_size=[17, 18])),
    "2d_asym_pad": ((2, 4, 6, 6), (4, 5, 3, 3), dict(stride=2, padding=[0, 1, 2, 1])),
    "2d_nhwc_bias": ((2, 6, 6, 4), (4, 5, 2, 2), dict(stride=2, data_format="NHWC", bias=True)),
    "3d_stride_dilation": ((1, 2, 3, 4, 3), (2, 3, 2, 3, 2), dict(stride=[2, 1, 2],
                                                                  padding=[1, 0, 1],
                                                                  dilation=[1, 2, 1])),
}


@pytest.mark.parametrize("case", sorted(TCONV_CASES))
def test_conv_transpose_matches_jax(case):
    """conv1d/2d/3d_transpose over stride, padding (symmetric, 2n
    asymmetric), output_padding, output_size, groups, dilation, NHWC and a
    bias: the output and the grads of x, the weight and the bias."""
    xs, ws, kw = TCONV_CASES[case]
    kw = dict(kw)
    rng = np.random.RandomState(len(case))
    arrays = dict(x=rng.randn(*xs).astype(np.float32), weight=rng.randn(*ws).astype(np.float32))
    if kw.pop("bias", False):
        arrays["bias"] = rng.randn(ws[1] * kw.get("groups", 1)).astype(np.float32)
    fname = {3: "conv1d_transpose", 4: "conv2d_transpose", 5: "conv3d_transpose"}[len(xs)]
    jf, tf = getattr(paddle.nn.functional, fname), getattr(ptt.nn.functional, fname)
    _check_both(_run("jax", lambda **a: jf(**a, **kw), arrays),
                _run("port", lambda **a: tf(**a, **kw), arrays))


def test_conv_transpose_refusals():
    """output_padding (given, or from output_size) outside [0, stride) has
    no forward conv to transpose: the JAX package fails on it and the port
    raises ValueError; string padding raises in both."""
    x, w = np.zeros((1, 4, 6, 6), np.float32), np.zeros((4, 5, 3, 3), np.float32)
    F = ptt.nn.functional
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert tuple(F.conv2d_transpose(xt, wt, stride=2, output_size=[14, 14]).shape) == (1, 5, 14, 14)
    with pytest.raises(Exception):
        paddle.nn.functional.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w), stride=2,
                                              output_size=[15, 15])
    for kw in (dict(stride=2, output_size=[15, 15]), dict(stride=2, output_size=[12, 13]),
               dict(stride=2, output_padding=2), dict(output_padding=1)):
        with pytest.raises(ValueError):
            F.conv2d_transpose(xt, wt, **kw)
    for pkg, f, a, b in (("jax", paddle.nn.functional.conv2d_transpose, paddle.to_tensor(x),
                          paddle.to_tensor(w)), ("port", F.conv2d_transpose, xt, wt)):
        with pytest.raises(NotImplementedError):
            f(a, b, padding="SAME")


# ---------------------------------------------------------------------------
# interpolate
# ---------------------------------------------------------------------------

INTERP_CASES = {
    "nearest_up2": ((2, 3, 5, 6), dict(scale_factor=2, mode="nearest")),
    "nearest_down_5to3": ((2, 3, 5, 7), dict(size=[3, 4], mode="nearest")),
    "nearest_1d": ((2, 3, 7), dict(size=[4], mode="nearest", data_format="NCL")),
    "nearest_align_corners_ignored": ((2, 3, 5, 6), dict(size=[7, 4], mode="nearest",
                                                         align_corners=True)),
    "bilinear_up": ((2, 3, 5, 6), dict(size=[9, 13], mode="bilinear")),
    "bilinear_down_antialiased": ((2, 3, 8, 8), dict(size=[4, 3], mode="bilinear")),
    "bilinear_align_corners": ((2, 3, 5, 6), dict(size=[9, 4], mode="bilinear",
                                                  align_corners=True)),
    "bicubic_up": ((2, 3, 8, 8), dict(size=[16, 11], mode="bicubic")),
    "bicubic_down_antialiased": ((2, 3, 8, 8), dict(size=[5, 3], mode="bicubic")),
    "bicubic_align_corners_is_linear": ((2, 3, 5, 6), dict(size=[9, 4], mode="bicubic",
                                                           align_corners=True)),
    "linear_1d_down": ((2, 3, 9), dict(size=[4], mode="linear", data_format="NCL")),
    "trilinear_3d_mixed": ((1, 2, 4, 6, 5), dict(size=[7, 3, 5], mode="trilinear",
                                                 data_format="NCDHW")),
    "area_down": ((2, 3, 8, 9), dict(size=[3, 4], mode="area")),
    "area_up_fractional": ((2, 3, 3, 4), dict(size=[5, 7], mode="area")),
    "bilinear_nhwc_scale": ((2, 8, 8, 3), dict(scale_factor=[0.5, 1.5], mode="bilinear",
                                               data_format="NHWC")),
}


@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interpolate_matches_jax(case):
    """interpolate in every mode, up and down, in 1-3 spatial dims, NCHW and
    NHWC, by size or scale_factor: the output and the input's grad."""
    xs, kw = INTERP_CASES[case]
    arrays = dict(x=np.random.RandomState(len(case)).randn(*xs).astype(np.float32))
    _check_both(_run("jax", lambda x: paddle.nn.functional.interpolate(x, **kw), arrays),
                _run("port", lambda x: ptt.nn.functional.interpolate(x, **kw), arrays))
    t = ptt.nn.functional.upsample(torch.from_numpy(arrays["x"]), **kw)
    assert torch.equal(t, ptt.nn.functional.interpolate(torch.from_numpy(arrays["x"]), **kw))


def test_interpolate_refusals():
    """align_mode=1 (paddle's src = dst * scale) raises: the JAX package
    ignores it and computes align_mode 0. An unknown mode raises."""
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(NotImplementedError):
        ptt.nn.functional.interpolate(x, size=[6, 6], mode="bilinear", align_mode=1)
    with pytest.raises(ValueError):
        ptt.nn.functional.interpolate(x, size=[6, 6], mode="lanczos")


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------

B, T, IN, HID = 3, 5, 4, 6


def _rnn_case(name):
    """(JAX layer, port layer, arrays, call) for one recurrent case; the
    port layer holds the JAX layer's weights."""
    rng = np.random.RandomState(7)
    x1, xs = rng.randn(B, IN).astype(np.float32), rng.randn(B, T, IN).astype(np.float32)
    h = lambda n=None: (rng.randn(B, HID) if n is None else rng.randn(n, B, HID)).astype(np.float32)
    paddle.seed(11)
    if name == "simple_rnn_cell":
        j, t = paddle.nn.SimpleRNNCell(IN, HID), ptt.nn.SimpleRNNCell(IN, HID)
        arrays, call = dict(x=x1, h=h()), lambda m, x, h: m(x, h)
    elif name == "simple_rnn_cell_relu_no_state":
        j = paddle.nn.SimpleRNNCell(IN, HID, activation="relu")
        t = ptt.nn.SimpleRNNCell(IN, HID, activation="relu")
        arrays, call = dict(x=x1), lambda m, x: m(x)
    elif name == "lstm_cell":
        j, t = paddle.nn.LSTMCell(IN, HID), ptt.nn.LSTMCell(IN, HID)
        arrays, call = dict(x=x1, h=h(), c=h()), lambda m, x, h, c: m(x, (h, c))
    elif name == "gru_cell":
        j, t = paddle.nn.GRUCell(IN, HID), ptt.nn.GRUCell(IN, HID)
        arrays, call = dict(x=x1, h=h()), lambda m, x, h: m(x, h)
    elif name == "birnn_lstm":
        j = paddle.nn.BiRNN(paddle.nn.LSTMCell(IN, HID), paddle.nn.LSTMCell(IN, HID))
        t = ptt.nn.BiRNN(ptt.nn.LSTMCell(IN, HID), ptt.nn.LSTMCell(IN, HID))
        arrays, call = dict(x=xs), lambda m, x: m(x)
    elif name == "lstm_2layer_bidirect":
        j = paddle.nn.LSTM(IN, HID, num_layers=2, direction="bidirect")
        t = ptt.nn.LSTM(IN, HID, num_layers=2, direction="bidirect")
        arrays, call = dict(x=xs, h=h(4), c=h(4)), lambda m, x, h, c: m(x, (h, c))
    else:  # gru_2layer_bidirect_time_major
        j = paddle.nn.GRU(IN, HID, num_layers=2, direction="bidirectional", time_major=True)
        t = ptt.nn.GRU(IN, HID, num_layers=2, direction="bidirectional", time_major=True)
        arrays = dict(x=np.ascontiguousarray(xs.transpose(1, 0, 2)), h=h(4))
        call = lambda m, x, h: m(x, h)
    return j, _carry(j, t), arrays, call


RNN_CASES = ["simple_rnn_cell", "simple_rnn_cell_relu_no_state", "lstm_cell", "gru_cell",
             "birnn_lstm", "lstm_2layer_bidirect", "gru_2layer_bidirect_time_major"]


@pytest.mark.parametrize("case", RNN_CASES)
def test_rnn_matches_jax(case):
    """The cells and the time-looped layers: outputs and final states, and
    the grads of the inputs, the initial states and every weight and bias.
    The parameter names are the JAX package's (the state loads strictly)."""
    j, t, arrays, call = _rnn_case(case)
    _check_both(_run("jax", lambda **a: call(j, **a), arrays, layer=j),
                _run("port", lambda **a: call(t, **a), arrays, layer=t))


def test_rnn_init_states_and_sequence_length():
    """Every weight and bias draws U(-1/sqrt(hidden), 1/sqrt(hidden));
    get_initial_states gives f32 zeros; sequence_length raises (the JAX
    package ignores it)."""
    ptt.seed(0)
    lstm = ptt.nn.LSTM(16, 64, num_layers=2, direction="bidirect")
    names = sorted(n for n, _ in lstm.named_parameters())
    assert names[:4] == ["cell_0.bias_hh", "cell_0.bias_ih", "cell_0.weight_hh", "cell_0.weight_ih"]
    assert len(names) == 16 and "cell_1_reverse.weight_ih" in names
    k = 1.0 / np.sqrt(64)
    for n, p in lstm.named_parameters():
        assert p.abs().max().item() <= k and abs(p.std().item() / (k / np.sqrt(3.0)) - 1) < 0.2, n
    assert tuple(lstm.cell_1.weight_ih.shape) == (256, 128)
    cell = ptt.nn.LSTMCell(4, 8)
    h0 = cell.get_initial_states(torch.zeros(3, 4, dtype=torch.float64))
    assert h0.dtype == torch.float32 and tuple(h0.shape) == (3, 8) and not h0.any()
    x, lens = torch.zeros(2, 5, 4), torch.tensor([5, 3])
    for layer in (ptt.nn.RNN(cell), ptt.nn.BiRNN(cell, ptt.nn.LSTMCell(4, 8)),
                  ptt.nn.LSTM(4, 8), ptt.nn.GRU(4, 8)):
        with pytest.raises(NotImplementedError):
            layer(x, sequence_length=lens)


# ---------------------------------------------------------------------------
# ctc_loss
# ---------------------------------------------------------------------------

def _ctc_inputs():
    rng = np.random.RandomState(0)
    Tn, N, C, S = 12, 3, 7, 4
    logits = rng.randn(Tn, N, C).astype(np.float32)
    labels = rng.randint(1, C, (N, S)).astype(np.int64)
    labels[0, 1] = labels[0, 2]  # a repeat: no skip between them
    return logits, labels, np.array([12, 10, 9], np.int64), np.array([4, 3, 2], np.int64)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_value_matches_jax(reduction):
    """The value against the JAX package over ragged input and label
    lengths (a repeated label included), each reduction."""
    logits, labels, il, ll = _ctc_inputs()
    want = paddle.nn.functional.ctc_loss(paddle.to_tensor(logits), paddle.to_tensor(labels),
                                         paddle.to_tensor(il), paddle.to_tensor(ll),
                                         reduction=reduction)
    got = ptt.nn.functional.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                     torch.from_numpy(il), torch.from_numpy(ll),
                                     reduction=reduction)
    _close(got, want, reduction)


def test_ctc_loss_infeasible_costs_1e30():
    """4 distinct labels cannot align to 3 frames: the JAX package's NEG
    (-1e30) makes that row's loss 1e30, and the port's too (torch's
    ctc_loss gives inf); the feasible rows beside it keep their values."""
    logits, labels, il, ll = _ctc_inputs()
    labels[2] = [1, 2, 3, 4]
    il[2], ll[2] = 3, 4
    args_j = [paddle.to_tensor(a) for a in (logits, labels, il, ll)]
    args_t = [torch.from_numpy(a) for a in (logits, labels, il, ll)]
    want = _np(paddle.nn.functional.ctc_loss(*args_j, reduction="none"))
    got = _np(ptt.nn.functional.ctc_loss(*args_t, reduction="none"))
    assert want[2] == np.float32(1e30) and got[2] == np.float32(1e30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    lp = torch.log_softmax(args_t[0], -1)
    assert torch.isinf(torch.nn.functional.ctc_loss(lp, args_t[1], args_t[2], args_t[3],
                                                    reduction="none")[2])


def test_ctc_loss_grad_matches_torch_where_jax_is_nan():
    """The input gradient (the logits' gradient: log_softmax is applied
    inside) against torch's ctc_loss fed log_softmax(x), an independent
    implementation, for "mean" and "sum". The JAX package's gradient has
    NaN rows (log of a zero sum under a where, at unreachable states);
    where it is finite it agrees with the port's."""
    logits, labels, il, ll = _ctc_inputs()
    for reduction in ("mean", "sum"):
        x = torch.from_numpy(logits.copy()).requires_grad_(True)
        ptt.nn.functional.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(il),
                                   torch.from_numpy(ll), reduction=reduction).backward()
        xr = torch.from_numpy(logits.copy()).requires_grad_(True)
        torch.nn.functional.ctc_loss(torch.log_softmax(xr, -1), torch.from_numpy(labels),
                                     torch.from_numpy(il), torch.from_numpy(ll),
                                     reduction=reduction).backward()
        assert torch.isfinite(x.grad).all()
        _grad_close(x.grad, xr.grad, reduction)
    xj = paddle.to_tensor(logits, stop_gradient=False)
    paddle.nn.functional.ctc_loss(xj, paddle.to_tensor(labels), paddle.to_tensor(il),
                                  paddle.to_tensor(ll), reduction="sum").backward()
    gj, gt = _np(xj.grad), _np(x.grad)
    finite = np.isfinite(gj)
    assert not finite.all()  # the reference-side fault
    np.testing.assert_allclose(gt[finite], gj[finite], rtol=1e-4, atol=1e-5)


def test_ctc_loss_norm_by_times_raises():
    logits, labels, il, ll = _ctc_inputs()
    with pytest.raises(NotImplementedError):
        ptt.nn.functional.ctc_loss(*(torch.from_numpy(a) for a in (logits, labels, il, ll)),
                                   norm_by_times=True)


# ---------------------------------------------------------------------------
# DBNet, CRNN and OCRSystem
# ---------------------------------------------------------------------------

def test_host_postprocess_decode_and_resize_exact():
    """db_postprocess (scipy labelling, and the flood fill without scipy),
    ctc_greedy_decode and resize give exactly the JAX package's results on
    numpy inputs (and on a tensor, read back from its device)."""
    rng = np.random.RandomState(3)
    pm = rng.rand(2, 1, 40, 48).astype(np.float32) ** 3
    pm[0, 0, 5:12, 6:30] = 0.9
    pm[1, 0, 20:35, 2:9] = 0.7
    want = jocr.db_postprocess(pm, bin_thresh=0.3, box_thresh=0.5)
    got = tocr.db_postprocess(torch.from_numpy(pm), bin_thresh=0.3, box_thresh=0.5)
    assert [len(b) for b in want] == [len(b) for b in got] and sum(len(b) for b in got) >= 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    import sys

    saved = sys.modules.get("scipy")
    sys.modules["scipy"] = None  # `from scipy import ndimage` raises ImportError
    try:
        flood = tocr.db_postprocess(pm, bin_thresh=0.3, box_thresh=0.5)
    finally:
        if saved is None:
            del sys.modules["scipy"]
        else:
            sys.modules["scipy"] = saved
    for g, w in zip(flood, want):
        np.testing.assert_array_equal(g[:, :4], w[:, :4])
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=1e-6)
    logits = rng.randn(4, 20, 6).astype(np.float32)
    logits[:, ::3, 0] += 3.0  # blanks between repeats
    assert tocr.ctc_greedy_decode(torch.from_numpy(logits)) == jocr.ctc_greedy_decode(logits)
    assert tocr.ctc_greedy_decode(logits, blank=2) == jocr.ctc_greedy_decode(logits, blank=2)
    img = (rng.rand(23, 57, 3) * 255).astype(np.uint8)
    for size, interp in (((32, 100), "bilinear"), ((32, 100), "nearest"), (16, "bilinear"),
                         ((9, 11), "bilinear")):
        for a in (img, img.astype(np.float32) / 255.0, img[:, :, 0]):
            w, g = jvtf.resize(a, size, interp), tvtf.resize(a, size, interp)
            assert g.dtype == w.dtype and np.array_equal(g, w), (size, interp, a.dtype)
    assert np.array_equal(tvtf.resize(torch.from_numpy(img), (32, 100)), jvtf.resize(img, (32, 100)))
