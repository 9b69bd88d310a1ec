"""Port parity: the flash attention backward (paddle_tpu_torch.ops.attention,
TPU kernels B2/B3) against the JAX package on the same numpy inputs: its
Pallas backward kernels in interpret mode (through the custom_vjp of
flash_attention_bshd_lse) and jax.vjp of the plain reference chain. The
CUDA kernels themselves are held against the same plain version on the
card (tests/test_torch_kernels_cuda.py and chip_smoke.py)."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas as pk
from paddle_tpu_torch.ops import attention as ta

# f32 on both sides; only the summation order of the products differs
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def interpret():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _inputs(seed, b, sq, sk, h, hkv, d):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return f(b, sq, h, d), f(b, sk, hkv, d), f(b, sk, hkv, d), f(b, sq, h, d), f(b, h, sq)


def _port_grads(q, k, v, g, g_lse, causal, dropout_p, seed):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = ta.flash_attention_bshd_lse(tq, tk, tv, causal=causal, dropout_p=dropout_p,
                                           dropout_seed=seed)
    outs, cots = [out], [torch.from_numpy(g)]
    if g_lse is not None:
        outs.append(lse)
        cots.append(torch.from_numpy(g_lse))
    return [t.numpy() for t in torch.autograd.grad(outs, (tq, tk, tv), cots)]


@pytest.mark.parametrize("sq,sk,h,hkv,causal,dropout_p,use_lse", [
    (128, 128, 4, 2, True, 0.0, False),   # GQA causal
    (128, 256, 4, 1, True, 0.0, False),   # cross length: bottom-right causal, MQA
    (128, 128, 4, 2, True, 0.1, False),   # dropout: the dk/dv hash's q-head identity
    (128, 128, 2, 2, False, 0.0, True),   # a cotangent on lse folds into delta
])
def test_flash_bwd_matches_interpret_kernels(interpret, sq, sk, h, hkv, causal, dropout_p, use_lse):
    q, k, v, g, g_lse = _inputs(sq + sk + h, 1, sq, sk, h, hkv, 32)
    seed = 4321
    fn = lambda a, b_, c: pk.flash_attention_bshd_lse(a, b_, c, causal=causal, dropout_p=dropout_p,
                                                      dropout_seed=seed)
    (out_j, lse_j), vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    cot_lse = g_lse if use_lse else np.zeros_like(g_lse)
    want = vjp((jnp.asarray(g), jnp.asarray(cot_lse)))
    got = _port_grads(q, k, v, g, g_lse if use_lse else None, causal, dropout_p, seed)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=f"d{name}")
    assert all(n == 0 for n in ta.LAUNCHES.values())  # CPU: plain versions only


@pytest.mark.parametrize("sq,sk,h,hkv,causal,dropout_p", [
    (40, 72, 4, 2, True, 0.0),    # ragged lengths the JAX kernel never takes
    (48, 48, 2, 2, False, 0.25),  # dropout, non-causal
    (33, 33, 6, 3, True, 0.1),    # odd length, group 2, dropout
    (100, 237, 4, 2, True, 0.0),  # causal cross length off the dq kernel's 128-row, 64-key tiles
    (77, 141, 4, 1, True, 0.1),   # the same with MQA and dropout
])
def test_flash_bwd_matches_jax_reference_vjp(sq, sk, h, hkv, causal, dropout_p):
    q, k, v, g, _ = _inputs(sq * 7 + h, 2, sq, sk, h, hkv, 16)
    seed = 99
    fn = lambda a, b_, c: pk._ref_attention_bshd(a, b_, c, causal, None, dropout_p=dropout_p,
                                                 seed=seed)
    grads = jax.jit(lambda a, b_, c, ct: jax.vjp(fn, a, b_, c)[1](ct))  # one compile, not per op
    want = grads(*(jnp.asarray(x) for x in (q, k, v, g)))
    got = _port_grads(q, k, v, g, None, causal, dropout_p, seed)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=f"d{name}")


def test_flash_bwd_bf16_rounding_points():
    """bf16 storage: the plain backward rounds ds and p*z to bf16 before
    the products, as the JAX kernels do; against the f32 backward of the
    same bf16 inputs it stays within bf16's 2^-8 relative step (a few
    ulps of the gradient's scale)."""
    q, k, v, g, _ = _inputs(5, 1, 64, 64, 4, 2, 32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    args = [bf(a) for a in (q, k, v)]
    out, lse = ta._flash_plain(*args, True, 32 ** -0.5, 0.0, 0)
    do = bf(g)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = ta._flash_bwd_plain(*args, do, lse, delta, True, 32 ** -0.5, 0.0, 0)
    f32 = ta._flash_bwd_plain(*[a.float() for a in args], do.float(), lse, delta, True,
                              32 ** -0.5, 0.0, 0)
    for a, w in zip(got, f32):
        assert a.dtype == torch.bfloat16
        err = (a.float() - w).abs().max().item()
        assert err <= 2e-2 * w.abs().max().item(), err
