"""Port parity: incubate fused_rms_norm (TPU kernel B6) against the JAX
package's Pallas kernel in interpret mode and its plain `_rms_norm_ref`,
with the gradients against jax.vjp of `_rms_norm_ref` (the JAX package's
backward recomputes through it). The CUDA kernel itself is held against
the same plain version on the card (tests/test_torch_kernels_cuda.py and
chip_smoke.py)."""
import functools

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops.launches import LAUNCHES

F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 on both sides; the row sum in another order


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX RMSNorm kernel passes no interpret flag of its own: run its
    pallas_call in interpret mode for this test only."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield
    JIF._rms_norm_pallas_fwd_impl.clear_cache()  # drop the interpret-mode trace


def _inputs(seed, r, d, bias):
    rng = np.random.RandomState(seed)
    x = rng.randn(r, d).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32) if bias else None
    return x, w, b


@pytest.mark.parametrize("bias", [False, True])
def test_fused_rms_norm_matches_interpret_kernel(interpret_pallas, bias):
    x, w, b = _inputs(int(bias), 16, 128, bias)
    bz = b if bias else np.zeros_like(w)
    want = JIF._rms_norm_pallas_fwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bz),
                                         eps=1e-6, has_bias=bias)
    got = TIF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b) if bias else None, epsilon=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert LAUNCHES["rms_norm"] == 0  # CPU: the plain version


@pytest.mark.parametrize("shape,bias,dtype", [
    ((7, 24), True, np.float32),       # ragged rows, D not a multiple of 128
    ((3, 5, 32), False, np.float32),   # leading dims flatten into rows
    ((6, 64), True, "bfloat16"),       # bf16: cast back to x's type after f32 math
    ((5, 2056), False, "bfloat16"),    # bf16 x and weight, wider than a pack per thread (1024)
    ((2, 3, 4096), False, "bfloat16"), # the Llama-3-8B width, leading dims flattened
    ((3, 16392), True, "bfloat16"),    # wide rows with a bias, D % 64 != 0
    ((9, 1032), True, np.float32),     # f32, a ragged pack count per thread
])
def test_fused_rms_norm_and_grads_match_reference(shape, bias, dtype):
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    d = shape[-1]
    w = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32) if bias else None
    g = rng.randn(*shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(a).astype(jdt) for a in [x, w] + ([b] if bias else [])]
    fn = lambda xx, ww, *bb: JIF._rms_norm_ref(xx, ww, bb[0] if bb else None, 1e-6)
    want, vjp = jax.vjp(fn, *jargs)
    want_g = vjp(jnp.asarray(g).astype(jdt))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in [x, w] + ([b] if bias else [])]
    got = TIF.fused_rms_norm(leaves[0], leaves[1], leaves[2] if bias else None, epsilon=1e-6)
    got.backward(torch.from_numpy(g).to(tdt))
    # bf16: one ulp of the bf16 output (2^-8 relative) on either side of a rounding
    tol = dict(rtol=8e-3, atol=8e-3) if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    gtol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else F32_TOL
    for t, wg in zip(leaves, want_g):
        assert t.grad.dtype == tdt
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(wg.astype(jnp.float32)),
                                   **gtol)


@pytest.mark.parametrize("d,dtype,error,match", [
    (64, torch.float32, ValueError, "must be on"),    # a CPU tensor is never sent to the kernel
    (64, torch.bfloat16, ValueError, "must be on"),
    (60, torch.float32, ValueError, "multiple of 8"),  # a row is a whole number of 16-byte packs
])
def test_rms_norm_kernel_wrapper_refuses_before_launch(d, dtype, error, match):
    """The kernel's wrapper takes CUDA tensors only (the CPU path is the
    plain version, chosen by the tensor's device in _FusedRMSNorm) and
    refuses what the kernel cannot read, before it builds or launches
    anything."""
    x, w = torch.zeros(4, d, dtype=dtype), torch.ones(d, dtype=dtype)
    with pytest.raises(error, match=match):
        TIF._rms_norm_cuda(x, w, None, 1e-6)
    assert LAUNCHES["rms_norm"] == 0
