"""Port parity for the training slice: the fused linear cross-entropy, the
AMP casts, and a tiny Llama trained for 3 AdamW steps in both packages
from the same weights and batch (f32 and AMP-O1 bf16, FLAGS_fused_optimizer
on and off), against the JAX package on the same numpy inputs."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch as ptt
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu


@pytest.fixture(autouse=True)
def _reset():
    ptt.set_device("cpu")
    yield
    paddle.set_flags({"FLAGS_fused_optimizer": False})
    ptt.set_flags({"FLAGS_fused_optimizer": False})


@pytest.mark.parametrize("transpose_weight,bias", [(False, False), (True, True)])
def test_flce_matches_jax(transpose_weight, bias):
    """Loss and grads of h, W, b with two ignored labels; f32 on both sides
    (sums in another order)."""
    rng = np.random.RandomState(int(transpose_weight))
    n, hd, v = 12, 16, 40
    h = rng.randn(n, hd).astype(np.float32)
    w = rng.randn(*((v, hd) if transpose_weight else (hd, v))).astype(np.float32)
    b = rng.randn(v).astype(np.float32) if bias else None
    labels = rng.randint(0, v, n).astype(np.int64)
    labels[[2, 7]] = -100
    args = [jnp.asarray(h), jnp.asarray(w)] + ([jnp.asarray(b)] if bias else [])
    loss_j, vjp = jax.vjp(lambda hh, ww, *bb: JIF._flce(hh, ww, bb[0] if bb else None,
                                                       jnp.asarray(labels), -100,
                                                       transpose_weight), *args)
    grads_j = vjp(jnp.ones((), jnp.float32))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [h, w] + ([b] if bias else [])]
    loss_t = TIF.fused_linear_cross_entropy(leaves[0], leaves[1], torch.from_numpy(labels),
                                            bias=leaves[2] if bias else None,
                                            transpose_weight=transpose_weight)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    for t, g in zip(leaves, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)


def _dtype_name(x) -> str:
    return str(x.dtype).split(".")[-1]


@pytest.mark.parametrize("level", ["O0", "O1", "O2"])
def test_amp_casts_match_jax(level):
    """Under auto_cast the listed ops cast their inputs as the JAX package's
    (linear, sdpa and the fused LM head low; rms_norm f32 in O1), and the
    gradients come back in each parameter's own dtype."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 16).astype(np.float32)
    w = rng.randn(16, 16).astype(np.float32)
    q = rng.randn(1, 8, 2, 8).astype(np.float32)
    labels = rng.randint(0, 16, (16,)).astype(np.int64)
    with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
        jx, jw = paddle.to_tensor(x), paddle.to_tensor(w)
        want = {
            "linear": paddle.nn.functional.linear(jx, jw),
            "rms_norm": paddle.nn.functional.rms_norm(jx.astype("bfloat16"), None),
            "sdpa": paddle.nn.functional.scaled_dot_product_attention(
                *(paddle.to_tensor(q),) * 3, is_causal=True),
            "flce": JIF.fused_linear_cross_entropy(jx.reshape([16, 16]), jw,
                                                   paddle.to_tensor(labels)),
        }
    lin = ptt.nn.Linear(16, 16, bias_attr=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    tx = torch.from_numpy(x)
    with ptt.amp.auto_cast(level=level, dtype="bfloat16"):
        got = {
            "linear": lin(tx),
            "rms_norm": ptt.nn.functional.rms_norm(tx.to(torch.bfloat16), None),
            "sdpa": ptt.nn.functional.scaled_dot_product_attention(
                *(torch.from_numpy(q),) * 3, is_causal=True),
            "flce": TIF.fused_linear_cross_entropy(tx.reshape(16, 16), lin.weight,
                                                   torch.from_numpy(labels)),
        }
        got["linear"].float().sum().backward()
    assert {k: _dtype_name(v) for k, v in got.items()} == \
        {k: _dtype_name(v._value) for k, v in want.items()}
    assert lin.weight.grad.dtype == torch.float32


def _train(pkg, fused, amp, m2, steps=3):
    """3 AdamW steps of llama_tiny (2 layers, hidden 64, 4/2 heads, ffn 176,
    vocab 1024) on one batch B2 S64; returns (losses, {name: param})."""
    paddle.seed(0)
    jm = jllama.llama_tiny(num_key_value_heads=2)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 1024, (2, 64)).astype(np.int64)
    seeds = [(0x2545F491 * (i + 3)) & 0xFFFFFFFF for i in range(200)]
    level = "O1" if amp else "O0"
    if pkg == "jax":
        paddle.set_flags({"FLAGS_fused_optimizer": fused})
        model, x = jm, paddle.to_tensor(ids)
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01,
                                     moment2_dtype=m2)
        it = iter(seeds)
        opt._m2_key = lambda: jnp.uint32(next(it))
        cast = paddle.amp.auto_cast
    else:
        ptt.set_flags({"FLAGS_fused_optimizer": fused})
        np_state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
        model = tllama.LlamaForCausalLM(**jm.config, device="cpu")
        model.load_state_dict(state_from_paddle_tpu(np_state))
        x = torch.from_numpy(ids)
        opt = ptt.optimizer.AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01,
                                  moment2_dtype=m2)
        it = iter(seeds)
        opt._m2_key = lambda: next(it)
        cast = ptt.amp.auto_cast
    losses = []
    for _ in range(steps):
        with cast(level=level, dtype="bfloat16"):
            loss, _ = model(x, labels=x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()) if pkg == "jax" else loss.item())
    if pkg == "jax":
        params = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    else:
        from paddle_tpu_torch.utils.convert import state_to_paddle_tpu

        params = state_to_paddle_tpu(model.state_dict())
    return losses, params


@pytest.mark.parametrize("fused,amp", [(False, False), (True, False), (False, True),
                                       (True, True)])
def test_tiny_llama_training_matches_jax(fused, amp):
    """Both packages from the same weights, 3 steps, f32 or AMP-O1 bf16,
    the flat-bucket engine on or off (bf16 moment2 under the same fixed
    stochastic-rounding seeds with AMP). Adam normalises the gradient, so
    a param whose gradient is near its rounding noise can move by up to lr
    per step either way: params are held to lr-relative bounds. In f32 the
    two runs round the same operations in another order; under O1, bf16
    GEMMs and the attention chain round at other points."""
    m2 = "bfloat16" if amp else "float32"
    lj, pj = _train("jax", fused, amp, m2)
    lt, pt = _train("port", fused, amp, m2)
    # measured here: f32 loss 1.5e-7 relative, params 0.0075 lr at most and
    # 1.9e-6 lr on average; O1 loss 6.6e-5, params 4.18 lr and 0.0127 lr
    lr = 1e-3
    if amp:
        np.testing.assert_allclose(lt, lj, rtol=5e-4)
        max_over_lr, mean_over_lr = 6.6, 0.05  # 3 steps x a flipped update (1.1 lr)
    else:
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
        max_over_lr, mean_over_lr = 0.05, 2e-5
    d = np.concatenate([np.abs(pt[k] - pj[k]).ravel() for k in pj])
    assert d.max() <= max_over_lr * lr and d.mean() <= mean_over_lr * lr, (d.max() / lr,
                                                                           d.mean() / lr)
    assert lt[-1] < lt[0]


def test_rope_tables_built_while_serving_train_later():
    """The RoPE tables are cached per shape and device. When the serving
    engine (under torch.inference_mode) builds them first, a training
    step in the same process must still be able to save them for its
    backward."""
    tllama._rope_tables_on.cache_clear()
    rng = np.random.RandomState(7)
    q, k = (torch.from_numpy(rng.randn(1, 24, 2, 16).astype(np.float32)) for _ in range(2))
    with torch.inference_mode():
        served, _ = tllama._rope(q, k)
    qg = q.clone().requires_grad_(True)
    out, _ = tllama._rope(qg, k)
    out.square().sum().backward()
    torch.testing.assert_close(out.detach(), served, rtol=0, atol=0)
    # a rotation of each pair keeps the norm: d/dq sum(rope(q)^2) = 2 q
    torch.testing.assert_close(qg.grad, 2 * q, rtol=1e-5, atol=1e-5)
