"""Port parity for PP-OCR's two models against the JAX package on the same
seeded numpy inputs, f32: DBNet with db_loss (train and eval), CRNN with
one CTC step, and OCRSystem end to end. Forward values within rtol 1e-5 /
atol 1e-5, gradients within 1e-4 relative L2. The JAX runs of the two
models are shared by a module fixture (the JAX package compiles op by op
on the CPU), which builds them with their U(low, high) draws made by numpy
from a seed (test_torch_detection.numpy_uniform), sparing a jax.random
compile for each parameter's shape. Split from test_torch_ocr.py: a file
of few tests, which pytest-xdist's `--dist loadfile` hands out after the
files with many tests, so this fixture no longer delays the heaviest JAX
file."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu.models import ocr as jocr
from paddle_tpu.nn import initializer as jinit

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import ocr as tocr

from test_torch_detection import numpy_uniform
from test_torch_ocr import _carry, _close, _grad_close, _np, _np_state


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


HW = 64
E2E_BOXES = [10, 10]  # OCRSystem's boxes on the two e2e pages
N_CROPS = 10  # the CRNN test's batch: the e2e crops' shape (compiled once in the JAX package)
LABEL_LENGTHS = [5, 4, 3, 5, 2, 1, 5, 3, 4, 2]


def _models(pkg):
    nn = paddle.nn if pkg == "jax" else ptt.nn
    mod = jocr if pkg == "jax" else tocr
    (paddle if pkg == "jax" else ptt).seed(0)
    det = mod.DBNet(8, 32)
    rec = mod.CRNN(num_classes=11, hidden_size=32)
    for m in det.sublayers() if pkg == "jax" else det.modules():
        if isinstance(m, nn.BatchNorm2D):
            # eval then reads this batch's statistics (the buffers move away
            # from their zeros and ones, so eval mode is a real test of them)
            m._momentum = 0.0
    return det, rec


def _page():
    # two images: a batch norm over the 2x2 stride-32 maps of one 64x64 image
    # sees 4 values, and f32 rounding then moves the binary map (k = 50) by
    # ~3e-5 against f64; over 8 values by ~5e-6
    rng = np.random.RandomState(0)
    return rng.rand(2, 3, HW, HW).astype(np.float32)


def _db_targets():
    rng = np.random.RandomState(1)
    gt_prob = (rng.rand(2, 1, HW, HW) > 0.8).astype(np.float32)
    gt_thresh = (0.3 + 0.4 * rng.rand(2, 1, HW, HW)).astype(np.float32)
    mask = (rng.rand(2, 1, HW, HW) > 0.1).astype(np.float32)
    return gt_prob, gt_thresh, mask


def _ocr_run(pkg, det, rec, crops, labels):
    """DBNet: train maps, db_loss and its grads, then (BN buffers now the
    batch's statistics) the eval prob map; CRNN: logits on `crops` and the
    CTC loss of `labels`; OCRSystem end to end on the page, after the prob
    branch's last transposed conv is sharpened (weight x10, bias 0.4) so
    its map has 10 components above box_thresh on each page (each
    component's mean prob 3.3e-3 or more from box_thresh, each pixel
    6.5e-5 or more from bin_thresh)."""
    T_ = paddle.to_tensor if pkg == "jax" else torch.from_numpy
    page = T_(_page())
    gt_prob, gt_thresh, mask = (T_(a) for a in _db_targets())
    det.train()
    maps = det(page)
    mod = jocr if pkg == "jax" else tocr
    loss = mod.db_loss(maps, gt_prob, gt_thresh, prob_mask=mask, thresh_mask=mask)
    loss.backward()
    grads = {n: _np(p.grad) for n, p in det.named_parameters()}
    det.eval()
    prob = det(page)
    prob2 = det(T_(_page() * 0.5 + 0.2))
    logits = rec(T_(crops))
    n, t = logits.shape[0], logits.shape[1]
    lengths = np.full(n, t, np.int64)
    label_lengths = np.array(LABEL_LENGTHS, np.int64)
    F = paddle.nn.functional if pkg == "jax" else ptt.nn.functional
    lp = F.log_softmax(logits.transpose([1, 0, 2]) if pkg == "jax" else logits.transpose(0, 1),
                       axis=-1)
    ctc = F.ctc_loss(lp, T_(labels), T_(lengths), T_(label_lengths))
    last = det.head.prob[6]
    state = {k: v for k, v in (_np_state(det) if pkg == "jax" else
                               {k: v.numpy() for k, v in det.state_dict().items()}).items()}
    state["head.prob.6.weight"] = state["head.prob.6.weight"] * 10.0
    state["head.prob.6.bias"] = np.full_like(state["head.prob.6.bias"], 0.4)
    if pkg == "jax":
        det.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
        system = jocr.OCRSystem(det, rec)
    else:
        det.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        system = tocr.OCRSystem(det, rec)
    assert last is det.head.prob[6]
    return dict(maps=_np(maps), loss=_np(loss), grads=grads, prob=_np(prob), prob2=_np(prob2),
                logits=_np(logits), ctc=_np(ctc), e2e=system(page))


@pytest.fixture(scope="module")
def ocr_runs():
    """The tiny DBNet and CRNN built in the JAX package, carried into the
    port, and _ocr_run in each; plus the port's CRNN and CTC for one step."""
    ptt.set_device("cpu")
    rng = np.random.RandomState(5)
    crops = rng.rand(N_CROPS, 3, 32, 100).astype(np.float32)
    labels = rng.randint(1, 11, (N_CROPS, 5)).astype(np.int64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinit.Uniform, "__call__", numpy_uniform(0))
        jdet, jrec = _models("jax")
    tdet, trec = _models("port")
    _carry(jdet, tdet)
    _carry(jrec, trec)
    port_rec = tocr.CRNN(num_classes=11, hidden_size=32)
    port_rec.load_state_dict(trec.state_dict())
    return dict(jax=_ocr_run("jax", jdet, jrec, crops, labels),
                port=_ocr_run("port", tdet, trec, crops, labels),
                crops=crops, labels=labels, port_rec=port_rec)


def test_dbnet_train_maps_loss_and_grads(ocr_runs):
    """DBNet(8, 32) in train mode on two 64x64 pages: the (prob, thresh,
    binary) maps, db_loss with masks, and every parameter's grad."""
    j, t = ocr_runs["jax"], ocr_runs["port"]
    assert t["maps"].shape == (2, 3, HW, HW)
    _close(t["maps"], j["maps"], "maps")
    _close(t["loss"], j["loss"], "db_loss")
    assert set(t["grads"]) == set(j["grads"]) and len(t["grads"]) == 53
    # the transposed convs' biases feed a batch norm, which takes their mean
    # out: their true gradient is 0 and both packages give rounding noise
    # (~1e-8), held to that
    scale = max(np.linalg.norm(g) for g in j["grads"].values())
    for n in j["grads"]:
        if n in ("head.prob.3.bias", "head.thresh.3.bias"):
            for g in (t["grads"][n], j["grads"][n]):
                assert np.linalg.norm(g) <= 1e-6 * scale, n
        else:
            _grad_close(t["grads"][n], j["grads"][n], n)


def test_dbnet_eval_reads_running_buffers(ocr_runs):
    """Eval mode returns the prob map alone and normalizes with the BN
    buffers, which the train forward set to its batch's statistics
    (momentum 0): on the train page the eval map is the train map's prob
    channel, and on a second page (other statistics than the buffers') it
    matches the JAX package's eval map."""
    j, t = ocr_runs["jax"], ocr_runs["port"]
    assert t["prob"].shape == t["prob2"].shape == (2, 1, HW, HW)
    _close(t["prob"], j["prob"], "eval prob")
    _close(t["prob2"], j["prob2"], "eval prob, second page")
    np.testing.assert_allclose(t["prob"], t["maps"][:, :1], rtol=1e-4, atol=1e-5)
    assert t["prob2"].std() > 0.01  # the map varies (~5e-5 with the init's buffers)


def test_crnn_logits_and_ctc_step(ocr_runs):
    """CRNN(11, 32) logits on [10, 3, 32, 100] crops (24 frames) and the CTC
    loss against the JAX package; one CTC step's gradients of every
    parameter, the port's CTC against torch's ctc_loss through the same
    CRNN, all finite (the JAX package's are NaN here)."""
    j, t = ocr_runs["jax"], ocr_runs["port"]
    assert t["logits"].shape == (N_CROPS, 24, 11)
    _close(t["logits"], j["logits"], "logits")
    _close(t["ctc"], j["ctc"], "ctc")
    rec = ocr_runs["port_rec"]
    x = torch.from_numpy(ocr_runs["crops"])
    labels = torch.from_numpy(ocr_runs["labels"])
    lengths = torch.full((N_CROPS,), 24, dtype=torch.int64)
    label_lengths = torch.tensor(LABEL_LENGTHS)
    grads = []
    for ctc in (ptt.nn.functional.ctc_loss, torch.nn.functional.ctc_loss):
        rec.train()
        lp = torch.log_softmax(rec(x).transpose(0, 1), -1)
        ctc(lp, labels, lengths, label_lengths).backward()
        grads.append({n: p.grad.clone() for n, p in rec.named_parameters()})
        rec.zero_grad()
    assert len(grads[0]) == 36
    for n in grads[0]:
        assert torch.isfinite(grads[0][n]).all(), n
        _grad_close(grads[0][n], grads[1][n], n)


def test_ocr_system_end_to_end(ocr_runs):
    """OCRSystem(DBNet(8, 32), CRNN(11, 32)) on two 64x64 pages: the same
    boxes, in the same order, and the same label ids for each crop."""
    j, t = ocr_runs["jax"]["e2e"], ocr_runs["port"]["e2e"]
    assert [len(r) for r in t] == [len(r) for r in j] == E2E_BOXES
    for rt, rj in zip(t, j):
        for (bt, lt), (bj, lj) in zip(rt, rj):
            assert bt == bj and lt == lj
