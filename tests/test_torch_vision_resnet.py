"""Port parity for the ResNet family: the parameter and buffer names, and
resnet18 and resnet50 trained in both packages from the same weights (f32
and AMP O1 bf16). The JAX package's three runs are one module fixture
(`jax_runs`, ~160 s of its eager per-op compiles on an 8-core CPU host); the file
stands apart from test_torch_vision.py so the xdist scheduler hands it to
a worker of its own."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import regularizer as jregularizer
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch as ptt
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu, state_to_paddle_tpu
from paddle_tpu_torch.vision import models as tmodels


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


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

LR0 = 0.01
RESNET_CASES = {  # name -> (ctor name, AMP O1, batch, Momentum steps)
    "resnet18_f32": ("resnet18", False, 4, 2),
    "resnet18_o1": ("resnet18", True, 4, 2),
    "resnet50_o1": ("resnet50", True, 2, 1),
}
# f32 (measured on this CPU: loss 9e-8 of the step-1 loss, grads 9.1e-6,
# 2-step changes 2.9e-4): summation order only
F32_LOSS, F32_GRAD, F32_CHANGE = 1e-5, 1e-4, 1e-3
# O1: a bf16 logit near 3 moves by 2^-8 * 3 = 0.012 a rounding, so the mean
# loss of 4 images by a few thousandths (measured 1.9e-3 of the step-1
# loss, resnet50 9.5e-4)
O1_LOSS = 5e-3
# O1 grads and changes are bf16 noise: each package's O1 step-1 grads are
# ~54% (resnet18) and ~137% (resnet50) from the f32 grads, relative L2.
# The port's O1 tensors are held within 1.5x the JAX package's own O1-vs-f32
# distance (two independent roundings of equal size differ by sqrt(2)x);
# measured 0.78x at most for resnet18, 1.12x for resnet50
O1_NOISE_RATIO = 1.5


def _np_state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


def _train(pkg, ctor, amp, batch, steps, init=None):
    """`steps` Momentum steps (lr PiecewiseDecay 0.01 then 0.005, stepped
    each step; momentum 0.9; L2Decay(1e-4)) of ctor(num_classes=10) on one
    batch of 3x64x64 images (layer4 is 2x2) and labels from seed 5, from
    seed-0 JAX weights (`init`, the port's). Returns the names in
    state_dict order, the state before and after, the losses, the step-1
    grads and each sublayer's output dtype in call order."""
    rng = np.random.RandomState(5)
    x = rng.randn(batch, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, (batch,)).astype(np.int64)
    lib = paddle if pkg == "jax" else ptt
    reg = jregularizer if pkg == "jax" else ptt.regularizer
    dtypes = []
    if pkg == "jax":
        paddle.seed(0)
        model = getattr(jmodels, ctor)(num_classes=10)
        init = _np_state(model)
        for name, sub in model.named_sublayers():
            sub.register_forward_post_hook(lambda l, i, o, n=name: dtypes.append((n, _dtype(o))))
        state = lambda: {k: np.array(v, np.float32) for k, v in _np_state(model).items()}
        xs, ys = paddle.to_tensor(x), paddle.to_tensor(y)
    else:
        model = getattr(tmodels, ctor)(num_classes=10)
        model.load_state_dict(state_from_paddle_tpu(init))
        for name, sub in model.named_modules():
            if name:
                sub.register_forward_hook(lambda l, i, o, n=name: dtypes.append((n, _dtype(o))))
        state = lambda: {k: np.array(v, np.float32)
                         for k, v in state_to_paddle_tpu(model.state_dict()).items()}
        xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    sched = lib.optimizer.lr.PiecewiseDecay([1], [LR0, LR0 / 2])
    opt = lib.optimizer.Momentum(sched, momentum=0.9, parameters=model.parameters(),
                                 weight_decay=reg.L2Decay(1e-4))
    names = (list(_np_state(model)) if pkg == "jax"
             else [n for n, _ in model.named_parameters()] + [n for n, _ in model.named_buffers()])
    before, losses, grads = state(), [], None
    for i in range(steps):
        with lib.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            loss = lib.nn.functional.cross_entropy(model(xs), ys)
        loss.backward()
        if i == 0:
            grads = {n: p.grad for n, p in model.named_parameters()}
            grads = ({n: _np(g) for n, g in grads.items()} if pkg == "jax" else
                     {n: np.asarray(g, np.float32) for n, g in state_to_paddle_tpu(grads).items()})
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(_np(loss)))
    return dict(init=init, names=names, before=before, after=state(), losses=losses, grads=grads,
                dtypes=dtypes[:len(dtypes) // steps])


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs, once for the module (its first eager steps
    take 12-38 s each on this CPU: per-op tracing)."""
    return {case: _train("jax", *spec) for case, spec in RESNET_CASES.items()}


@pytest.mark.parametrize("case,n_entries", [("resnet18_f32", 102), ("resnet50_o1", 267)])
def test_resnet_names_and_shapes_match_jax(jax_runs, case, n_entries):
    """The port's parameters then buffers, in order, are the JAX
    state_dict's keys (102 for resnet18, 267 for resnet50, `bn1._mean`,
    `layer2.0.downsample.0.weight` and `fc.weight` among them); the JAX
    state converts to exactly the port's shapes and back (`fc`, the one
    Linear, is [in, out] in both, as every conv weight and buffer is the
    same in both)."""
    ptt.seed(0)
    tm = getattr(tmodels, RESNET_CASES[case][0])(num_classes=10)
    init = jax_runs[case]["init"]
    names = [n for n, _ in tm.named_parameters()] + [n for n, _ in tm.named_buffers()]
    assert names == list(init) and len(names) == n_entries
    assert {"bn1._mean", "layer2.0.downsample.0.weight", "fc.weight"} <= set(names)
    conv = state_from_paddle_tpu(init)
    assert {k: tuple(v.shape) for k, v in conv.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert tuple(conv["fc.weight"].shape) == (init["fc.weight"].shape[0], 10)
    back = state_to_paddle_tpu(conv)
    assert all(np.array_equal(back[k], v) for k, v in init.items())


def _tensor_dists(a, b):
    """name -> (relative L2 of a's step-1 grad against b's, of a's change
    over the run against b's change)."""
    return {n: (_rel_l2(a["grads"][n], b["grads"][n]) if n in b["grads"] else 0.0,
                _rel_l2(a["after"][n] - a["before"][n], b["after"][n] - b["before"][n]))
            for n in b["after"]}


@pytest.mark.parametrize("case", sorted(RESNET_CASES))
def test_resnet_training_matches_jax(jax_runs, case):
    """resnet18 for 2 Momentum steps (f32 and AMP O1 bf16) and resnet50 for
    one O1 step, from the JAX package's weights on the same batch: every
    sublayer's output dtype in call order (O1: conv and fc bf16; batch
    norm, ReLU, the pools and the residual adds f32), the losses, and per
    tensor the step-1 grads and the change of every param and BN buffer
    over the run. f32 differs in summation order only; O1 within the
    bf16 noise bounds above."""
    ctor, amp, batch, steps = RESNET_CASES[case]
    want = jax_runs[case]
    got = _train("port", ctor, amp, batch, steps, init=want["init"])
    assert got["dtypes"] == want["dtypes"]
    loss_err = max(abs(a - b) for a, b in zip(got["losses"], want["losses"])) / want["losses"][0]
    dist = _tensor_dists(got, want)
    buffers = [n for n in want["after"] if n.endswith(("_mean", "_variance"))]
    assert all(not np.array_equal(got["after"][n], got["before"][n]) for n in buffers)
    if not amp:
        assert loss_err <= F32_LOSS, loss_err
        worst = max((g, n) for n, (g, _) in dist.items()), max((c, n) for n, (_, c) in dist.items())
        assert worst[0][0] <= F32_GRAD and worst[1][0] <= F32_CHANGE, worst
        return
    kinds = {d for n, d in got["dtypes"] if n.split(".")[-1] in ("conv1", "conv2", "fc")}
    assert kinds == {"bfloat16"} and {d for n, d in got["dtypes"] if "bn" in n} == {"float32"}
    assert loss_err <= O1_LOSS, loss_err
    # the f32 step from the same weights: the JAX package's for resnet18,
    # the port's (9e-6-close to it on resnet18) for resnet50
    ref = (jax_runs["resnet18_f32"] if ctor == "resnet18"
           else _train("port", ctor, False, batch, steps, init=want["init"]))
    noise = _tensor_dists(want, ref)
    ratio = max((max(dist[n][k] / max(noise[n][k], 1e-12) for k in (0, 1)), n) for n in dist)
    assert ratio[0] <= O1_NOISE_RATIO, ratio
