"""Port parity for PP-YOLOE on one device against the JAX package on the
same seeded numpy inputs, f32: vision.ops (box_area, box_iou and nms, whose
indices must be exactly the JAX package's), binary_cross_entropy_with_logits,
and PPYOLOE(4, 8, 32): forward, decode, infer and one ppyoloe_loss step's
gradients. Forward values within rtol 1e-5 / atol 1e-5, gradients within
1e-4 relative L2. The JAX runs of the model are shared by a module
fixture, which builds the JAX model with its U(low, high) draws made by
numpy from a seed: the JAX package compiles a jax.random call for each
parameter's shape (17 s for this model on the CPU), and the values are
carried into the port either way."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import detection as jdet
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.vision import ops as jops

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import detection as tdet
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu
from paddle_tpu_torch.vision import ops as tops

RTOL = ATOL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    if isinstance(v, np.ndarray):
        return v
    return np.asarray(v._value)


def _close(got, want, what=""):
    g, w = _np(got).astype(np.float32), _np(want).astype(np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)


def _tie_runs(scores):
    """[start, stop) spans of consecutive rows whose scores lie within the
    score tolerance of their neighbour (RTOL, ATOL), each a run in which
    the order is a near-tie; rows outside any such run are spans of one."""
    spans, start = [], 0
    for i in range(1, len(scores) + 1):
        if i == len(scores) or abs(scores[i] - scores[i - 1]) > ATOL + RTOL * abs(scores[i - 1]):
            spans.append((start, i))
            start = i
    return spans


def _rows_close_up_to_ties(got, want, what=""):
    """infer rows (x1, y1, x2, y2, score, class), `want` in the JAX
    package's order: row count exact; within a run of rows whose JAX scores
    lie within the score tolerance of each other (_tie_runs) the rows may
    come in any order, each present once with its box and score within
    tolerance and its class exact; outside such runs the order is exact."""
    g, w = _np(got).astype(np.float32), _np(want).astype(np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    for a, b in _tie_runs(w[:, 4]):
        free = list(range(a, b))
        for r in range(a, b):
            match = next((c for c in free if g[c, 5] == w[r, 5] and np.allclose(
                g[c, :5], w[r, :5], rtol=RTOL, atol=ATOL)), None)
            assert match is not None, (what, f"JAX row {r} {w[r]} has no match in port rows "
                                             f"{a}..{b - 1}", g[a:b])
            free.remove(match)


@pytest.mark.parametrize("case", ["swap_1ulp_accepted", "swap_beyond_tol_rejected"])
def test_rows_close_up_to_ties(case):
    """The comparison itself: two rows whose scores are 1 f32 ulp apart may
    come swapped; two rows whose scores differ by more than the tolerance
    may not."""
    s = np.float32(0.50227809)
    s2 = np.nextafter(s, np.float32(0)) if case == "swap_1ulp_accepted" else s - np.float32(1e-4)
    want = np.array([[0, 0, 9, 9, 0.9, 0], [1, 1, 5, 5, s, 1], [2, 2, 6, 6, s2, 1],
                     [3, 3, 7, 7, 0.45, 2]], np.float32)
    got = want[[0, 2, 1, 3]]
    if case == "swap_1ulp_accepted":
        _rows_close_up_to_ties(got, want)
    else:
        with pytest.raises(AssertionError):
            _rows_close_up_to_ties(got, want)


def _grad_close(got, want, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    assert rel <= GRAD_REL, (what, rel)


# ---------------------------------------------------------------------------
# vision.ops
# ---------------------------------------------------------------------------

def _boxes(n, seed, spread=50.0):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * spread
    wh = 5.0 + rng.rand(n, 2) * 15.0
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _nms_both(boxes, thr, scores=None, cats=None, top_k=None):
    jkw, tkw = {}, {}
    if scores is not None:
        jkw["scores"], tkw["scores"] = paddle.to_tensor(scores), torch.from_numpy(scores)
    if cats is not None:
        jkw["category_idxs"], tkw["category_idxs"] = paddle.to_tensor(cats), torch.from_numpy(cats)
        jkw["categories"] = tkw["categories"] = sorted(set(cats.tolist()))
    want = jops.nms(paddle.to_tensor(boxes), thr, top_k=top_k, **jkw).numpy()
    got = tops.nms(torch.from_numpy(boxes), thr, top_k=top_k, **tkw)
    assert got.dtype == torch.int64
    return got.numpy(), want


NMS_CASES = ["scores", "ties", "categories", "top_k", "no_scores", "chain"]


@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_indices_match_jax_exactly(case):
    """The kept indices, in order: by score (argsort stable: equal scores
    keep box order), class-aware with category offsets, cut to top_k, in
    box order without scores, and a chain of boxes each suppressing the
    next (kept, dropped, kept, ...), which the port's fixed point resolves
    in more than two sweeps."""
    rng = np.random.RandomState(NMS_CASES.index(case))
    boxes = _boxes(80, NMS_CASES.index(case))
    scores = rng.rand(80).astype(np.float32)
    kw = dict(scores=scores)
    if case == "ties":
        kw["scores"] = np.round(scores * 4) / 4  # 5 distinct values
    elif case == "categories":
        kw["cats"] = rng.randint(0, 3, 80).astype(np.int64)
    elif case == "top_k":
        kw.update(cats=rng.randint(0, 3, 80).astype(np.int64), top_k=7)
    elif case == "no_scores":
        kw = {}
    elif case == "chain":
        x = np.arange(80, dtype=np.float32) * 2.0
        boxes = np.stack([x, np.zeros(80), x + 10.0, np.full(80, 10.0)], 1).astype(np.float32)
        kw = dict(scores=np.linspace(1.0, 0.1, 80).astype(np.float32))
    got, want = _nms_both(boxes, 0.5, **kw)
    assert got.size > 0 and np.array_equal(got, want), (got, want)
    if case == "chain":  # IoU of a shift by 2 is 0.667, by 4 is 0.429
        assert got.tolist() == list(range(0, 80, 2)) and tops.LAST_SWEEPS > 2
    if case in ("scores", "categories"):
        assert got.size < 80  # something was suppressed


def test_box_area_and_iou_match_jax():
    a, b = _boxes(7, 1), _boxes(5, 2)
    _close(tops.box_area(torch.from_numpy(a)), jops.box_area(paddle.to_tensor(a)), "area")
    _close(tops.box_iou(torch.from_numpy(a), torch.from_numpy(b)),
           jops.box_iou(paddle.to_tensor(a), paddle.to_tensor(b)), "iou")


# ---------------------------------------------------------------------------
# binary_cross_entropy_with_logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mean", "weight_pos_weight_sum", "pos_weight_none"])
def test_bce_with_logits_matches_jax(case):
    """The value and the logits' grad, with `weight` and `pos_weight`."""
    rng = np.random.RandomState(3)
    z = (rng.randn(4, 5, 3) * 3).astype(np.float32)
    y = (rng.rand(4, 5, 3) > 0.6).astype(np.float32)
    kw = {}
    if case == "weight_pos_weight_sum":
        kw = dict(weight=rng.rand(4, 5, 3).astype(np.float32),
                  pos_weight=(0.5 + rng.rand(3)).astype(np.float32), reduction="sum")
    elif case == "pos_weight_none":
        kw = dict(pos_weight=(0.5 + rng.rand(3)).astype(np.float32), reduction="none")
    cot = rng.randn(4, 5, 3).astype(np.float32) if case == "pos_weight_none" else np.float32(1.0)
    res = []
    for pkg in ("jax", "port"):
        T_ = paddle.to_tensor if pkg == "jax" else torch.from_numpy
        zt = paddle.to_tensor(z, stop_gradient=False) if pkg == "jax" else \
            torch.from_numpy(z.copy()).requires_grad_(True)
        F = paddle.nn.functional if pkg == "jax" else ptt.nn.functional
        out = F.binary_cross_entropy_with_logits(
            zt, T_(y), **{k: (T_(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
        (out * T_(np.asarray(cot))).sum().backward()
        res.append((out, zt.grad))
    _close(res[1][0], res[0][0], "value")
    _grad_close(res[1][1], res[0][1], "grad")


# ---------------------------------------------------------------------------
# PPYOLOE
# ---------------------------------------------------------------------------

HW = 64


def _targets(outs, shapes):
    rng = np.random.RandomState(1)
    targets = []
    for shape in shapes:
        b, _, h, w = shape
        targets.append(dict(cls=(rng.rand(*shape) > 0.9).astype(np.float32),
                            box=rng.rand(b, 4, h, w).astype(np.float32),
                            mask=(rng.rand(b, 1, h, w) > 0.7).astype(np.float32)))
    return targets


def numpy_uniform(seed):
    """A stand-in for the JAX package's Uniform.__call__: U(low, high) from
    a seeded numpy generator."""
    rng = np.random.RandomState(seed)
    return lambda self, shape, dtype: jnp.asarray(
        rng.uniform(self.low, self.high, shape).astype(np.float32)).astype(dtype)


def _yolo_run(pkg, model):
    """Train forward, ppyoloe_loss and its grads; then infer at the default
    thresholds (score 0.4, IoU 0.5), eval mode, with the boxes and scores
    its decode returned."""
    T_ = paddle.to_tensor if pkg == "jax" else torch.from_numpy
    # batch 2: a batch norm over the 2x2 stride-32 maps of one 64x64 image
    # sees 4 values, and f32 rounding then moves the outputs by ~4e-5
    # (against f64); over 8 values by ~6e-6
    x = T_(np.random.RandomState(0).randn(2, 3, HW, HW).astype(np.float32))
    model.train()
    outs = model(x)
    shapes = [tuple(c.shape) for c, _ in outs]
    targets = [{k: T_(v) for k, v in t.items()} for t in _targets(outs, shapes)]
    loss = (jdet if pkg == "jax" else tdet).ppyoloe_loss(outs, targets, 4)
    loss.backward()
    grads = {n: _np(p.grad) for n, p in model.named_parameters()}
    decoded = []
    decode = model.decode
    model.decode = lambda outputs: decoded.append(decode(outputs)) or decoded[-1]
    results = model.infer(x)
    del model.decode
    (boxes, scores), = decoded
    return dict(outs=[(_np(c), _np(r)) for c, r in outs], loss=_np(loss), grads=grads,
                boxes=_np(boxes), scores=_np(scores), infer=results)


@pytest.fixture(scope="module")
def yolo_runs():
    ptt.set_device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinit.Uniform, "__call__", numpy_uniform(0))
        jm = jdet.PPYOLOE(num_classes=4, base_channels=8, neck_channels=32)
    tm = tdet.PPYOLOE(num_classes=4, base_channels=8, neck_channels=32)
    tm.load_state_dict(state_from_paddle_tpu({k: np.array(v._value)
                                              for k, v in jm.state_dict().items()}))
    return dict(jax=_yolo_run("jax", jm), port=_yolo_run("port", tm))


def test_ppyoloe_forward_loss_and_grads(yolo_runs):
    """PPYOLOE(4, 8, 32) on 2 images of 64x64 in train mode: each level's class logits
    and distances, ppyoloe_loss, and every parameter's grad."""
    j, t = yolo_runs["jax"], yolo_runs["port"]
    assert [c.shape for c, _ in t["outs"]] == [(2, 4, 8, 8), (2, 4, 4, 4), (2, 4, 2, 2)]
    for lvl, ((ct, rt), (cj, rj)) in enumerate(zip(t["outs"], j["outs"])):
        _close(ct, cj, f"cls {lvl}")
        _close(rt, rj, f"reg {lvl}")
    _close(t["loss"], j["loss"], "loss")
    assert set(t["grads"]) == set(j["grads"]) and len(t["grads"]) == len(j["grads"]) > 100
    for n in j["grads"]:
        _grad_close(t["grads"][n], j["grads"][n], n)


def test_ppyoloe_decode_and_infer(yolo_runs):
    """Eval mode (the BN buffers the train step moved): decode's boxes and
    scores; infer's rows (box, score, class) in the JAX package's order,
    which holds only if the score filter and the class-aware nms kept the
    same indices; and nms on the JAX package's own decoded boxes gives its
    indices exactly.

    infer sorts its rows by score, so rows whose scores tie within f32
    rounding come in either order: image 1's rows 52-54 are three class-1
    boxes the JAX run scores 0.50227809 each, and the port scores the third
    0.50227803 (within the 1e-5 score tolerance), which sorts it first.
    Within such a run of near-tied scores the rows are compared as a set
    (_rows_close_up_to_ties); everywhere else the order is exact."""
    j, t = yolo_runs["jax"], yolo_runs["port"]
    assert t["boxes"].shape == (2, 84, 4) and t["scores"].shape == (2, 84, 4)
    _close(t["boxes"], j["boxes"], "boxes")
    _close(t["scores"], j["scores"], "scores")
    assert len(t["infer"]) == len(j["infer"]) == 2
    for i, (rt, rj) in enumerate(zip(t["infer"], j["infer"])):
        assert rt.dtype == rj.dtype == np.float32 and rt.shape == rj.shape
        assert 0 < rt.shape[0] <= 100
        _rows_close_up_to_ties(rt, rj, f"infer rows of image {i}")
        conf, cls_id = j["scores"][i].max(-1), j["scores"][i].argmax(-1)
        keep = conf >= 0.4
        bb, cc, kk = j["boxes"][i][keep], conf[keep], cls_id[keep].astype(np.int64)
        got, want = _nms_both(bb, 0.5, scores=cc, cats=kk, top_k=100)
        assert np.array_equal(got, want) and got.size == rt.shape[0]
