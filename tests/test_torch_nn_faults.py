"""The port's repaired faults, each against the JAX package: Linear's
[in, out] weight (F.linear equals the layer, state_dict shapes equal the
JAX package's, and a fused-optimizer bucket of a non-square Linear keeps
every flat index, so its stochastic-rounding bits equal the JAX
package's), non-scalar backward seeded with ones, cross_entropy's label
shape check, and get_device()'s string."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
import paddle_tpu_torch as ptt


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_flags({"FLAGS_fused_optimizer": False})
    paddle.set_flags({"FLAGS_fused_optimizer": False})


@pytest.mark.parametrize("shape", [(4, 4), (5, 3)])
def test_linear_weight_is_in_out(shape):
    """F.linear(x, lin.weight, lin.bias) == lin(x) for square and
    non-square layers, the weight [in, out] as in the JAX package, and the
    JAX layer's weight loads unchanged and computes its output."""
    paddle.seed(0)
    jl = paddle.nn.Linear(*shape)
    tl = ptt.nn.Linear(*shape)
    assert tuple(tl.weight.shape) == tuple(jl.weight.shape) == shape
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jl.state_dict().items()}
    tl.set_state_dict({k: np.asarray(v._value) for k, v in jl.state_dict().items()})
    x = np.random.RandomState(0).randn(2, shape[0]).astype(np.float32)
    got = tl(torch.from_numpy(x))
    assert torch.equal(ptt.nn.functional.linear(torch.from_numpy(x), tl.weight, tl.bias), got)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jl(paddle.to_tensor(x))._value),
                               rtol=1e-6, atol=1e-6)
    tl.weight.set_value(np.ones(shape, np.float32))
    assert torch.equal(tl.weight.detach(), torch.ones(shape))


def test_fused_bucket_of_a_non_square_linear_keeps_the_sr_bits():
    """A non-square Linear (and a bias) under FLAGS_fused_optimizer with a
    bf16 moment2: 3 Adam steps on the same gradients and the same
    stochastic-rounding seeds in both packages give bit-equal bf16
    moment2 buckets and equal parameters (the flat order of [in, out] is
    the JAX package's)."""
    seeds = [0x2545F491 * (i + 3) & 0xFFFFFFFF for i in range(10)]
    x = np.random.RandomState(1).randn(8, 6).astype(np.float32)
    paddle.seed(0)
    jl = paddle.nn.Linear(6, 3)
    tl = ptt.nn.Linear(6, 3)
    tl.set_state_dict({k: np.asarray(v._value) for k, v in jl.state_dict().items()})
    runs = {}
    for pkg, layer, to in ((paddle, jl, paddle.to_tensor), (ptt, tl, torch.from_numpy)):
        pkg.set_flags({"FLAGS_fused_optimizer": True})
        opt = pkg.optimizer.Adam(0.01, parameters=layer.parameters(), moment2_dtype="bfloat16")
        it = iter(seeds)
        opt._m2_key = (lambda: jnp.uint32(next(it))) if pkg is paddle else (lambda: next(it))
        for _ in range(3):
            loss = (layer(to(x)) ** 2).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
        (bucket,) = opt._flat_engine.buckets.values()
        m2 = bucket["moment2"]
        bits = (np.asarray(m2).view(np.uint16) if pkg is paddle else
                m2.view(torch.int16).numpy().view(np.uint16))
        params = {n: (np.asarray(p._value) if pkg is paddle else p.detach().numpy())
                  for n, p in layer.named_parameters()}
        runs[pkg] = (bits, params)
    (tb, tp), (jb, jp) = runs[ptt], runs[paddle]
    assert tb.shape == jb.shape and np.array_equal(tb, jb)
    for n, w in jp.items():
        np.testing.assert_allclose(tp[n], w, rtol=1e-6, atol=1e-7, err_msg=n)


def test_non_scalar_backward_seeds_ones():
    """x * 2 -> grad [2, 2, 2] through Tensor.backward(), autograd.backward
    and paddle.grad, as in the JAX package; grad_tensor= is paddle's seed."""
    want = {}
    for pkg, make in ((paddle, lambda: paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)),
                      (ptt, lambda: ptt.to_tensor([1.0, 2.0, 3.0], stop_gradient=False))):
        x = make()
        (x * 2).backward()
        g1 = np.asarray(x.grad.numpy())
        x2 = make()
        pkg.autograd.backward([x2 * 2])
        g2 = np.asarray(x2.grad.numpy())
        x3 = make()
        (g3,) = pkg.grad([x3 * 2], [x3])
        x4 = make()
        (x4 * 2).backward(grad_tensor=pkg.to_tensor([1.0, 0.0, 3.0]))
        want[pkg] = [g1, g2, np.asarray(g3.numpy()), np.asarray(x4.grad.numpy())]
    for g, w in zip(want[ptt], want[paddle]):
        np.testing.assert_array_equal(g, w)
    assert want[ptt][0].tolist() == [2.0, 2.0, 2.0] and want[ptt][3].tolist() == [2.0, 0.0, 6.0]


@pytest.mark.parametrize("logits,labels,axis", [((4, 3), (2,), -1), ((2, 3, 4), (2, 3), 1)])
def test_cross_entropy_rejects_a_label_of_the_wrong_shape(logits, labels, axis):
    rng = np.random.RandomState(0)
    x = rng.randn(*logits).astype(np.float32)
    y = rng.randint(0, 2, labels).astype(np.int64)
    with pytest.raises(ValueError):
        paddle.nn.functional.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(y), axis=axis)
    with pytest.raises(ValueError):
        ptt.nn.functional.cross_entropy(torch.from_numpy(x), torch.from_numpy(y), axis=axis)
    good = rng.randint(0, logits[axis], logits[:axis % len(logits)] + logits[axis % len(logits) + 1:])
    loss = ptt.nn.functional.cross_entropy(torch.from_numpy(x), torch.from_numpy(good), axis=axis)
    want = paddle.nn.functional.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(good),
                                              axis=axis)
    np.testing.assert_allclose(loss.item(), float(want.numpy()), rtol=1e-6)


def test_get_device_is_a_string():
    """get_device() names the device as paddle does ("cpu:0" here, "gpu:0"
    on the card), the JAX package's string; the port's callers take the
    torch.device from framework.device.current_device()."""
    from paddle_tpu_torch.framework import device

    assert ptt.get_device() == paddle.get_device() == "cpu:0"
    assert device.current_device() == torch.device("cpu")
    assert ptt.get_device().startswith("cpu")
    assert device._paddle_name(torch.device("cuda", 0)) == "gpu:0"
