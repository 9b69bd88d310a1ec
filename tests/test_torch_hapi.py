"""Port parity for hapi (Model, the callbacks, summary) and paddle.flops:
fit/evaluate/predict of a tiny classifier from one set of weights against
the JAX package (per-batch losses and metrics, f32, 1e-5 relative), the
epoch EarlyStopping stops at, ReduceLROnPlateau's rates and LRScheduler's
steps, a ModelCheckpoint the JAX package loads, summary's totals and
flops' MACs (integers, exact), save/load round trips (training state, and
the inference artifact through jit.load) and train_batch under AMP O1."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle

import paddle_tpu_torch as ptt
from paddle_tpu_torch.utils.convert import state_to_paddle_tpu

from test_torch_static_nn import jax_numpy_inits

F32_RTOL = 1e-5
O1_RTOL = 2e-2  # a bf16 logit of ~1 moves by 2^-8 a rounding: the loss by ~1e-2


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


class Points:
    """24 seeded 4-feature points in 3 classes (each class shifts the mean)."""

    def __init__(self, n=24, seed=0):
        r = np.random.RandomState(seed)
        self.y = (np.arange(n) % 3).astype(np.int64)
        self.x = (r.randn(n, 4) + self.y[:, None]).astype(np.float32)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return self.x[i], np.asarray([self.y[i]], np.int64)


class TPoints(Points, ptt.io.Dataset):
    pass


class JPoints(Points, paddle.io.Dataset):
    pass


class Recorder:
    """A duck-typed callback for both packages: every batch's logs."""

    def __init__(self):
        self.batches, self.evals, self.epochs = [], [], []

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_batch_end(self, step, logs=None):
        self.batches.append(dict(logs))

    def on_eval_end(self, logs=None):
        self.evals.append(dict(logs))

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append(epoch)


def _net(lib):
    return lib.nn.Sequential(lib.nn.Linear(4, 8), lib.nn.ReLU(), lib.nn.Linear(8, 3))


def _pair(lr=0.1, opt="Momentum", metrics=True, **prep):
    """The port's Model and the JAX package's, from the port's seed-0
    weights, each prepared alike."""
    ptt.seed(0)
    tnet, jnet = _net(ptt), _net(paddle)
    # copies: tensor_to_numpy hands out views of CPU tensors (C-trap14)
    jnet.set_state_dict({k: paddle.to_tensor(np.array(v)) for k, v in
                         state_to_paddle_tpu(tnet.state_dict()).items()})
    out = []
    for lib, net in ((ptt, tnet), (paddle, jnet)):
        sched = lr(lib) if callable(lr) else lr
        o = getattr(lib.optimizer, opt)(sched, parameters=net.parameters())
        m = lib.Model(net)
        m.prepare(o, lib.nn.CrossEntropyLoss(),
                  lib.metric.Accuracy(topk=(1, 2)) if metrics else None, **prep)
        out.append(m)
    return out


def _close(a, b, rtol=F32_RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol,
                               atol=rtol)


def _same_logs(got, want, rtol=F32_RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            _close(g[k], w[k], rtol)


def test_fit_evaluate_predict_match_jax():
    """fit for 2 epochs (shuffled under one np.random.seed, batch 6, eval
    each epoch), then evaluate and predict: every batch's loss and
    accuracy top-1/2, the eval logs and the predictions match."""
    tm, jm = _pair()
    logs = []
    for m, ds, lib in ((tm, TPoints(), ptt), (jm, JPoints(), paddle)):
        rec = Recorder()
        np.random.seed(3)
        m.fit(ds, eval_data=type(ds)(12, seed=1), batch_size=6, epochs=2, verbose=0,
              callbacks=[rec])
        ev = m.evaluate(type(ds)(12, seed=1), batch_size=5, verbose=0)
        pred = m.predict(type(ds)(12, seed=2), batch_size=5, stack_outputs=True, verbose=0)
        logs.append((rec, ev, pred))
    (trec, tev, tpred), (jrec, jev, jpred) = logs
    assert len(trec.batches) == 8 and trec.epochs == [0, 1]
    _same_logs(trec.batches, jrec.batches)
    _same_logs(trec.evals, jrec.evals)
    assert set(tev) == {"loss", "acc_top1", "acc_top2"}
    _same_logs([tev], [jev])
    assert tpred[0].shape == (12, 3) and tpred[0].dtype == np.float32
    _close(tpred[0], np.asarray(jpred[0]))
    assert trec.batches[-1]["loss"] < trec.batches[0]["loss"]


def test_dataloader_input_and_accumulation_match_jax():
    """fit over the package's own DataLoader (2 prefetching workers) with
    gradient accumulation over 2 batches and num_iters: the same losses."""
    tm, jm = _pair(opt="SGD", metrics=False)
    recs = []
    for m, ds, lib in ((tm, TPoints(), ptt), (jm, JPoints(), paddle)):
        rec = Recorder()
        loader = lib.io.DataLoader(ds, batch_size=4, num_workers=2)
        m.fit(loader, epochs=2, verbose=0, callbacks=[rec], accumulate_grad_batches=2,
              num_iters=5)
        recs.append(rec)
    assert len(recs[0].batches) == 10
    _same_logs(recs[0].batches, recs[1].batches)


def test_early_stopping_and_lr_callbacks_match_jax(tmp_path):
    """EarlyStopping (monitor the eval loss, patience 1, a baseline no epoch
    beats): the epoch it stops at; ReduceLROnPlateau (float lr) the rates
    it sets each epoch; LRScheduler by epoch and by step: the scheduler's
    steps."""
    out = []
    for lib, ds in ((ptt, TPoints()), (paddle, JPoints())):
        tm = lib.Model(_net(lib))
        tm.prepare(lib.optimizer.SGD(0.05, parameters=tm.parameters()),
                   lib.nn.CrossEntropyLoss())
        es = lib.callbacks.EarlyStopping(monitor="loss", patience=1, baseline=0.0,
                                         save_best_model=False, verbose=0)
        rec = Recorder()
        tm.fit(ds, eval_data=ds, batch_size=8, epochs=6, verbose=0, callbacks=[es, rec],
               shuffle=False)
        out.append((rec.epochs, es.stopped_epoch, tm.stop_training))

        lrs = []
        rm = lib.Model(_net(lib))
        rm.prepare(lib.optimizer.SGD(0.1, parameters=rm.parameters()), lib.nn.CrossEntropyLoss())
        red = lib.callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1,
                                              min_delta=10.0, verbose=0)

        class LR(Recorder):
            def on_epoch_end(self, epoch, logs=None):
                lrs.append(float(rm._optimizer.get_lr()))

        rm.fit(ds, eval_data=ds, batch_size=8, epochs=4, verbose=0, callbacks=[red, LR()],
               shuffle=False)
        out.append(lrs)

        steps = []
        for by_epoch in (True, False):
            sched = lib.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
            sm = lib.Model(_net(lib))
            sm.prepare(lib.optimizer.SGD(sched, parameters=sm.parameters()),
                       lib.nn.CrossEntropyLoss())
            cb = lib.callbacks.LRScheduler(by_step=not by_epoch, by_epoch=by_epoch)
            sm.fit(ds, batch_size=8, epochs=2, verbose=0, callbacks=[cb], shuffle=False)
            steps.append((sched.last_epoch, float(sched.last_lr)))
        out.append(steps)
    t, j = out[:3], out[3:]
    assert t == j
    assert t[0] == ([0, 1], 2, True)  # stops after the second epoch's eval
    f32 = lambda v: float(np.float32(v))  # the optimizers keep an f32 lr
    assert t[1] == [f32(0.1), f32(0.1), f32(0.05), f32(0.025)]  # cut after evals 2 and 3
    assert t[2] == [(2, 0.025), (6, 0.1 * 0.5 ** 6)]


def test_checkpoints_and_save_load_round_trips(tmp_path):
    """ModelCheckpoint's epoch and final .pdparams load into the JAX
    package's net (its logits equal the port's); Model.save/load restores
    the weights and the optimizer state; save(training=False) writes the
    inference artifact, whose jit.load logits equal the live model's;
    VisualDL writes the JAX package's jsonl tags; WandbCallback raises."""
    from paddle_tpu_torch.static import InputSpec

    tm, _ = _pair()
    tm._inputs = [InputSpec([-1, 4], "float32")]
    ckpt = tmp_path / "ckpt"
    vdl = ptt.callbacks.VisualDL(str(tmp_path / "vdl"))
    tm.fit(TPoints(), batch_size=6, epochs=2, verbose=0, save_dir=str(ckpt), callbacks=[vdl])
    assert sorted(os.listdir(ckpt)) == ["0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
                                        "final.pdopt", "final.pdparams"]
    x = TPoints(5, seed=4).x
    jnet = _net(paddle)
    jnet.set_state_dict(paddle.load(str(ckpt / "final.pdparams")))
    tm.network.eval()
    _close(tm.network(torch.from_numpy(x)).detach().numpy(), np.asarray(jnet(
        paddle.to_tensor(x)).numpy()))
    tags = [json.loads(line)["tag"] for line in open(tmp_path / "vdl" / "scalars.jsonl")]
    assert tags[:2] == ["train/loss", "train/acc_top1"] and len(tags) == 24

    fresh, _ = _pair(lr=0.3)
    fresh.load(str(ckpt / "final"))
    for a, b in zip(fresh.network.state_dict().values(), tm.network.state_dict().values()):
        assert torch.equal(a, b)
    opt_a, opt_b = fresh._optimizer.state_dict(), tm._optimizer.state_dict()
    assert set(opt_a) == set(opt_b)

    tm.save(str(tmp_path / "infer"), training=False)
    loaded = ptt.jit.load(str(tmp_path / "infer"))
    torch.testing.assert_close(loaded(torch.from_numpy(x)), tm.network(torch.from_numpy(x)),
                               rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="wandb"):
        ptt.callbacks.WandbCallback()


def _cnn(lib):
    nn = lib.nn
    return nn.Sequential(nn.Conv2D(3, 8, 3, stride=2, padding=1, bias_attr=False),
                         nn.BatchNorm2D(8), nn.ReLU(),
                         nn.Conv2D(8, 8, 3, padding=1, groups=8), nn.Hardswish(),
                         nn.Conv2D(8, 16, 1), nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                         nn.Linear(16, 10))


def test_summary_and_flops_are_exact_and_train_batch_o1_matches_jax(capsys):
    """summary's total and trainable parameter counts, its per-layer output
    shapes, and flops' MACs of a small CNN equal the JAX package's exactly;
    so are MobileNetV3-Large's at 224 (the figure behind chip_smoke.py's
    MFU). train_batch under AMP O1 (bf16)
    of the tiny classifier matches the JAX package's losses to bf16
    rounding, and reads each loss to the host as a float."""
    ptt.seed(0)
    t, j = _cnn(ptt), _cnn(paddle)
    ts = ptt.summary(t, (2, 3, 16, 16))
    tout = capsys.readouterr().out
    js = paddle.summary(j, (2, 3, 16, 16))
    jout = capsys.readouterr().out
    assert ts == js == {"total_params": 626, "trainable_params": 626}
    # the rows' layer names up to case (the JAX package's ReLU class is
    # named Relu), output shapes and parameter counts
    rows = lambda out: [line.lower().split() for line in out.splitlines()
                        if line[:1].isupper() and "-" in line.split()[0] and ":" not in line]
    assert rows(tout) == rows(jout) and len(rows(tout)) == 9
    assert ptt.flops(t, [2, 3, 16, 16]) == paddle.flops(j, [2, 3, 16, 16]) == 2 * (
        8 * 27 * 64 + 8 * 9 * 64 + 16 * 8 * 64 + 16 * 10)
    with pytest.MonkeyPatch.context() as mp:
        jax_numpy_inits(mp, seed=2)
        jv3 = paddle.vision.models.mobilenet_v3_large()
    want = paddle.flops(_ShapeTraced(jv3), [1, 3, 224, 224])
    v3 = ptt.vision.models.mobilenet_v3_large()
    assert ptt.flops(v3, [1, 3, 224, 224]) == want == 216_589_760

    tm, jm = _pair(amp_configs="O1")
    x, y = TPoints(6, seed=5).x, TPoints(6, seed=5).y[:, None]
    got = [tm.train_batch([x], [y]) for _ in range(3)]
    want = [jm.train_batch([paddle.to_tensor(x)], [paddle.to_tensor(y)]) for _ in range(3)]
    for (gl, gm), (wl, wm) in zip(got, want):
        assert isinstance(gl[0], float)
        _close(gl, wl, O1_RTOL)
        _close(np.asarray(gm, np.float64).ravel(), np.asarray(wm, np.float64).ravel(), O1_RTOL)
    assert got[-1][0][0] < got[0][0][0]


class _ShapeTraced(paddle.nn.Layer):
    """The JAX package's `net` with its forward traced for shapes only
    (jax.eval_shape): flops' hooks read output shapes, so the count is the
    one a run would give, without an eager op's compile."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        from paddle_tpu.core.tensor import Tensor

        return jax.eval_shape(lambda v: self.net(Tensor(v))._value, x._value)


def test_public_names_match_jax():
    """The top level has io, hapi, Model, summary, flops and callbacks;
    io (streaming included), io.streaming, vision.transforms,
    vision.datasets, hapi and callbacks have every public name of the JAX
    package's (its module imports aside); vision.models its MobileNets."""
    import types

    assert all(hasattr(ptt, n) for n in ("io", "hapi", "Model", "summary", "flops", "callbacks"))

    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_") and n != "annotations"
                and not isinstance(getattr(mod, n), types.ModuleType)
                and getattr(getattr(mod, n), "__module__", "").split(".")[0] != "typing"}

    for path in ("io", "io.streaming", "io.streaming.stats", "vision.transforms",
                 "vision.datasets", "hapi", "callbacks"):
        j, t = paddle, ptt
        for part in path.split("."):
            j, t = getattr(j, part), getattr(t, part)
        assert names(j) <= names(t), (path, sorted(names(j) - names(t)))
    assert hasattr(ptt.io, "streaming") and hasattr(ptt.hapi, "callbacks")
    mobile = [n for n in dir(paddle.vision.models) if "obile" in n]
    assert len(mobile) == 10 and all(hasattr(ptt.vision.models, n) for n in mobile)  # 2 modules
