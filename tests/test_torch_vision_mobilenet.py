"""Port parity for MobileNetV1, V2, V3-Small and V3-Large: from one set of
weights (the JAX package's, drawn from numpy, carried over by name), the
train-mode logits, the cross-entropy loss, every parameter's gradient and
the batch norms' updated buffers against the JAX package on 2 images of
3x64x64 (the last stage's map is 2x2: a batch norm over a 1x1 map of two
images would be ill-conditioned in f32), in f32, dropout off (the two
packages' random streams differ). The JAX side runs each model's step as
one jitted value_and_grad over its parameter values (~30 s of XLA
compiles for the four; its eager per-op compiles took 160 s), in one
module fixture; the file keeps 5 tests so the xdist scheduler hands it
out after the suite's large files."""
import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch as ptt
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu, state_to_paddle_tpu
from paddle_tpu_torch.vision import models as tmodels

from test_torch_static_nn import jax_numpy_inits

# f32 on the CPU, both packages. A MobileNet at a tiny scale amplifies f32
# rounding: against the port's own f64 run, each package's f32 logits are
# 1e-6 to 5e-5 off (relative L2), all grads together up to 1.5e-4, and the
# first batch norm's weight grad of MobileNetV1 0.3% (port) and 1.2% (JAX).
# So the checks are: logits, loss and the grads and buffers as a whole
# tightly; each tensor to F32_TENSOR; and a tensor whose true value is 0
# but for rounding (the f64 run's norm under ZERO of its family's: the bias
# grad of a batch norm whose output only feeds another batch norm through
# a conv, the running mean of a batch norm whose input has zero batch mean)
# within NOISE of the family's norm, absolutely (C-trap10). Measured worst,
# port against JAX: logits 4.0e-5, loss 4.8e-6, grads as a whole 2.0e-4, a
# tensor 1.2e-2 (V1's first batch norm weight), a zero-but-rounding one
# 2.5e-8 of its family; buffers 8.8e-7, 2.3e-5 and 3.1e-9.
F32_LOGITS, F32_LOSS, F32_FAMILY, F32_TENSOR = 1e-4, 1e-5, 1e-3, 5e-2
ZERO, NOISE = 1e-6, 1e-6

CASES = {  # name -> (model function, kwargs)
    "v1": ("mobilenet_v1", dict(scale=0.25)),
    "v2": ("mobilenet_v2", dict(scale=0.5)),
    "v3_small": ("mobilenet_v3_small", dict(scale=0.5)),
    "v3_large": ("mobilenet_v3_large", dict(scale=1.0)),
}


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(v.numpy(), np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch():
    r = np.random.RandomState(3)
    return r.randn(2, 3, 64, 64).astype(np.float32), r.randint(0, 10, (2,)).astype(np.int64)


def _no_dropout(named):
    for _, sub in named:
        if type(sub).__name__ == "Dropout":
            sub.training = False


def _jax_step(model, x, y):
    """The JAX model's train-mode step as one jitted value_and_grad over its
    parameter values (buffers in, updated buffers out): (logits, loss,
    grads, state after)."""
    sd = model.state_dict()
    pnames = [n for n, _ in model.named_parameters()]
    bnames = [k for k in sd if k not in set(pnames)]

    def loss_fn(pvals, bvals):
        saved = {k: sd[k]._value for k in sd}
        try:
            for k, v in {**pvals, **bvals}.items():
                sd[k]._value = v
            with paddle.no_grad():
                logits = model(paddle.to_tensor(x))
                loss = paddle.nn.functional.cross_entropy(logits, paddle.to_tensor(y))
            return loss._value, (logits._value, {k: sd[k]._value for k in bvals})
        finally:
            for k, v in saved.items():
                sd[k]._value = v

    (loss, (logits, buffers)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {k: sd[k]._value for k in pnames}, {k: sd[k]._value for k in bnames})
    state = {k: np.asarray(v, np.float32) for k, v in buffers.items()}
    return (np.asarray(logits), float(loss), {k: np.asarray(g) for k, g in grads.items()}, state)


@pytest.fixture(scope="module")
def jax_runs():
    x, y = _batch()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_numpy_inits(mp, seed=1)
        for case, (arch, kw) in CASES.items():
            model = getattr(jmodels, arch)(num_classes=10, **kw)
            model.train()
            _no_dropout(model.named_sublayers())
            init = {k: np.array(v.numpy()) for k, v in model.state_dict().items()}
            logits, loss, grads, state = _jax_step(model, x, y)
            out[case] = dict(init=init, logits=logits, loss=loss, grads=grads, state=state)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_mobilenet_matches_jax(jax_runs, case):
    """The port's state_dict keys, in order, and shapes are the JAX
    package's; from its weights the logits, loss, grads and the batch
    norms' buffers after the train-mode forward agree at f32 tolerances."""
    ref = jax_runs[case]
    arch, kw = CASES[case]
    x, y = _batch()
    model = getattr(tmodels, arch)(num_classes=10, **kw)
    names = [n for n, _ in model.named_parameters()] + [n for n, _ in model.named_buffers()]
    assert names == list(ref["init"])
    model.load_state_dict(state_from_paddle_tpu(ref["init"]))
    model.train()
    _no_dropout(model.named_modules())
    logits = model(torch.from_numpy(x))
    loss = ptt.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    assert _rel(_np(logits), ref["logits"]) < F32_LOGITS
    assert abs(loss.item() - ref["loss"]) <= F32_LOSS * abs(ref["loss"])
    grads = state_to_paddle_tpu({n: p.grad for n, p in model.named_parameters()})
    state = state_to_paddle_tpu(model.state_dict())
    truth_grads, truth_state = _f64_truth(arch, kw, ref["init"], x, y)
    _hold("grad", grads, ref["grads"], truth_grads)
    assert ref["state"] and all(k.endswith(("_mean", "_variance")) for k in ref["state"])
    for k, want in ref["state"].items():
        assert not np.array_equal(want, ref["init"][k]), k  # the forward moved it
    _hold("buffer", {k: state[k] for k in ref["state"]}, ref["state"], truth_state)


def _f64_truth(arch, kw, init, x, y):
    """The port's step in f64: which tensors are 0 but for rounding."""
    model = getattr(tmodels, arch)(num_classes=10, **kw)
    model.load_state_dict(state_from_paddle_tpu(init))
    model.to(torch.float64).train()
    _no_dropout(model.named_modules())
    ptt.nn.functional.cross_entropy(model(torch.from_numpy(x).double()),
                                    torch.from_numpy(y)).backward()
    return ({n: p.grad.numpy() for n, p in model.named_parameters()},
            {n: b.numpy() for n, b in model.named_buffers() if n.endswith(("_mean", "_variance"))})


def _hold(what, got, want, truth):
    """The family (all grads, all buffers) within F32_FAMILY as a whole;
    each tensor within F32_TENSOR, or, where its true value is 0 but for
    rounding, within NOISE of the family's norm."""
    got = {k: np.asarray(v, np.float64) for k, v in got.items()}
    want = {k: np.asarray(want[k], np.float64) for k in got}
    assert set(got) == set(truth)
    norm = lambda d: float(np.sqrt(sum(np.sum(v * v) for v in d.values())))
    scale = norm(want)
    err = {k: float(np.linalg.norm(got[k] - want[k])) for k in got}
    assert float(np.sqrt(sum(e * e for e in err.values()))) <= F32_FAMILY * scale, what
    for k in got:
        if np.linalg.norm(truth[k]) >= ZERO * norm(truth):
            assert err[k] <= F32_TENSOR * np.linalg.norm(want[k]), (what, k, err[k])
        else:
            assert err[k] <= NOISE * scale, (what, k, err[k] / scale)


def test_full_size_models_match_jax(jax_runs):
    """Every MobileNet name of the JAX package's vision.models is the
    port's; at full size (1000 classes) each model's parameter and
    buffer names, shapes and counts equal the JAX package's
    (MobileNetV3-Large: 5,483,032 parameters)."""
    names = [n for n in dir(jmodels) if "obile" in n]
    assert names and all(hasattr(tmodels, n) for n in names)
    counts = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_numpy_inits(mp, seed=2)
        for arch in ("mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
                        "mobilenet_v3_large"):
            j = getattr(jmodels, arch)()
            t = getattr(tmodels, arch)()
            jshapes = {k: tuple(v.shape) for k, v in j.state_dict().items()}
            tshapes = {k: tuple(v.shape) for k, v in state_to_paddle_tpu(t.state_dict()).items()}
            assert tshapes == jshapes, arch
            counts[arch] = sum(p.numel() for p in t.parameters())
            assert counts[arch] == sum(int(np.prod(p.shape)) for p in j.parameters())
    assert counts["mobilenet_v3_large"] == 5_483_032
