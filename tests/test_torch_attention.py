"""Port parity: flash forward and paged attention (paddle_tpu_torch.ops.attention)
against the JAX package's references and its Pallas kernels in interpret
mode, on the same numpy inputs. The CUDA kernels themselves are held
against the same plain versions on the card (tests/test_torch_kernels_cuda.py
and chip_smoke.py)."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

from paddle_tpu.ops import pallas as pk
from paddle_tpu.quantization import observers as jobs
from paddle_tpu_torch.ops import attention as ta
from paddle_tpu_torch.nn import functional as TF

F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 on both sides; only summation order differs


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(rng, b, sq, sk, h, hkv, d):
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, sk, hkv, d).astype(np.float32),
            rng.randn(b, sk, hkv, d).astype(np.float32))


@pytest.fixture
def interpret():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


@pytest.mark.parametrize("sq,sk,h,hkv,causal", [
    (128, 128, 4, 4, False),
    (128, 128, 4, 2, True),    # GQA
    (64, 128, 4, 1, True),     # cross length: bottom-right causal, MQA
    (40, 72, 2, 2, False),     # ragged lengths the JAX kernel never takes
])
def test_flash_plain_matches_jax_reference(sq, sk, h, hkv, causal):
    rng = np.random.RandomState(sq + sk + h)
    q, k, v = _qkv(rng, 2, sq, sk, h, hkv, 32)
    want = np.asarray(pk._ref_attention_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal, None))
    got = ta.flash_attention_bshd(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert all(n == 0 for n in ta.LAUNCHES.values())  # CPU: plain versions only


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
def test_flash_plain_matches_interpret_kernel(interpret, dropout_p):
    """S=128, causal GQA: out and lse of the plain version equal the Pallas
    kernel's; with dropout the in-kernel hash mask must agree too."""
    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, 1, 128, 128, 4, 2, 64)
    seed = 1234
    out_j, lse_j = pk.flash_attention_bshd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               causal=True, dropout_p=dropout_p,
                                               dropout_seed=seed)
    out_t, lse_t = ta.flash_attention_bshd_lse(_t(q), _t(k), _t(v), causal=True,
                                               dropout_p=dropout_p, dropout_seed=seed)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **F32_TOL)


@pytest.mark.parametrize("seed", [0, 1234, -7, 2 ** 31 - 1])
def test_dropout_keep_mask_is_exact(seed):
    """The hash works in int64 masked to 32 bits: torch's >> on int32 is an
    arithmetic shift and would flip bits wherever the state is negative."""
    got = ta.dropout_keep_reference(seed, 3, 96, 130, 0.3).numpy()
    want = np.asarray(pk.dropout_keep_reference(seed, 3, 96, 130, 0.3))
    np.testing.assert_array_equal(got, want)
    # far positions and head ids wrap the 32-bit multiplies
    rng = np.random.RandomState(seed & 0xFFFF)
    qpos = rng.randint(0, 2 ** 31 - 1, (64,)).astype(np.int32)
    kpos = rng.randint(0, 2 ** 31 - 1, (64,)).astype(np.int32)
    bh = rng.randint(0, 2 ** 20, (64,)).astype(np.int32)
    thresh = pk._keep_threshold(0.5)
    want = np.asarray(pk._hash_keep(jnp.int32(seed), jnp.asarray(bh), jnp.asarray(qpos),
                                    jnp.asarray(kpos), thresh))
    got = ta._hash_keep(seed, _t(bh), _t(qpos), _t(kpos), thresh).numpy()
    np.testing.assert_array_equal(got, want)


def test_flash_dropout_matches_jax_reference():
    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, 2, 48, 48, 2, 2, 16)
    want = np.asarray(pk._ref_attention_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             False, None, dropout_p=0.25, seed=99))
    got = ta.ref_attention_bshd(_t(q), _t(k), _t(v), False, dropout_p=0.25, seed=99)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_bf16_plain_close_to_jax_reference():
    """bf16 storage: both sides round p to bf16 before P.V; rounding points
    differ slightly, so the bound is bf16's (2^-8 relative, a few ulps)."""
    rng = np.random.RandomState(11)
    q, k, v = _qkv(rng, 1, 64, 64, 4, 2, 32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(pk._ref_attention_bshd(bf(q), bf(k), bf(v), True, None), np.float32)
    tb = lambda a: _t(a).to(torch.bfloat16)
    got = ta.flash_attention_bshd(tb(q), tb(k), tb(v), causal=True).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_flash_validation_and_forward_only():
    rng = np.random.RandomState(0)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 16, 8, 2, 2, 8))
    with pytest.raises(ValueError, match="kv length >= q length"):
        ta.flash_attention_bshd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="GQA"):
        ta.flash_attention_bshd(q, k[:, :, :1], v, causal=False)
    for bad in (1.5, True, 2 ** 31, torch.tensor([1, 2])):
        with pytest.raises(ValueError):
            ta.flash_attention_bshd(q, k, v, dropout_p=0.1, dropout_seed=bad)
    # the op is differentiable: the backward (tests/test_torch_flash_bwd.py)
    qg = q.clone().requires_grad_(True)
    ta.flash_attention_bshd(qg, k, v).sum().backward()
    assert qg.grad is not None and qg.grad.shape == q.shape and torch.isfinite(qg.grad).all()


def test_sdpa_dispatch_and_masked_chain():
    """The plain chain runs only where the JAX package never runs its
    kernel (mask, causal sk < sq, head_dim > 256); a bool mask matches the
    JAX package's masked chain."""
    from paddle_tpu.nn.functional.attention import _sdpa_ref

    rng = np.random.RandomState(5)
    q, k, v = _qkv(rng, 2, 24, 24, 4, 2, 16)
    mask = rng.rand(2, 1, 24, 24) > 0.3
    mask[..., 0] = True
    want = np.asarray(_sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(mask), False, 0.0, None, False))
    got = TF.scaled_dot_product_attention(_t(q), _t(k), _t(v), attn_mask=_t(mask),
                                          training=False)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # causal with sk < sq: the plain chain's bottom-right alignment
    want = np.asarray(_sdpa_ref(jnp.asarray(q), jnp.asarray(k[:, :16]), jnp.asarray(v[:, :16]),
                                None, True, 0.0, None, False))
    got = TF.scaled_dot_product_attention(_t(q), _t(k[:, :16]), _t(v[:, :16]), is_causal=True,
                                          training=False)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def _paged_inputs(rng, qn):
    B, H, HKV, D, BS, N, M = 3, 8, 2, 32, 8, 12, 5
    q = rng.randn(B, qn, H, D).astype(np.float32)
    kp = rng.randn(N, BS, HKV, D).astype(np.float32)
    vp = rng.randn(N, BS, HKV, D).astype(np.float32)
    bt = np.asarray([[7, 3, 11, 0, 0], [5, 1, 0, 0, 0], [2, 9, 4, 6, 10]], np.int32)
    ends = np.asarray([26, 13, 39], np.int32)  # frontiers ending mid-page
    qpos = (ends[:, None] - qn + 1 + np.arange(qn)[None]).astype(np.int32)
    return q, kp, vp, bt, qpos


@pytest.mark.parametrize("qn", [1, 3])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_plain_matches_jax(interpret, qn, int8):
    """Decode (Q=1) and extend (Q=3) on a shuffled page layout with GQA,
    f32 and int8 pages: the plain version equals the JAX reference and the
    interpret-mode Pallas kernel (int8 pages quantized by the JAX
    observers, so both sides read the same grid)."""
    rng = np.random.RandomState(qn + 10 * int8)
    q, kp, vp, bt, qpos = _paged_inputs(rng, qn)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    jkw = {}
    tkw = {}
    if int8:
        ks, vs = jobs.absmax_scale(jk, axis=-1), jobs.absmax_scale(jv, axis=-1)
        jk, jv = jobs.quantize_absmax(jk, ks[..., None]), jobs.quantize_absmax(jv, vs[..., None])
        jkw = dict(k_scales=ks, v_scales=vs)
        tkw = dict(k_scales=_t(np.asarray(ks)), v_scales=_t(np.asarray(vs)))
    tk, tv = _t(np.asarray(jk)), _t(np.asarray(jv))
    ref = np.asarray(pk.paged_extend_reference(jnp.asarray(q), jk, jv, bt, qpos, **jkw))
    kern = np.asarray(pk._paged_extend_jit(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                           jnp.asarray(qpos), **jkw))
    if qn == 1:
        got = ta.flash_decode_paged(_t(q[:, 0]), tk, tv, _t(bt), _t(qpos[:, 0] + 1), **tkw)
        got = got[:, None]
    else:
        got = ta.flash_decode_paged_multi(_t(q), tk, tv, _t(bt), _t(qpos), **tkw)
    tol = dict(rtol=2e-5, atol=2e-5)  # f32 sums in another order; int8 scale*(1/127) vs /127
    np.testing.assert_allclose(got.numpy(), ref, **tol)
    np.testing.assert_allclose(got.numpy(), kern, **tol)


def test_paged_validation_messages():
    kp = torch.zeros(4, 8, 2, 16)
    bt, sl = np.zeros((2, 4), np.int32), np.ones((2,), np.int32)
    with pytest.raises(ValueError, match="head_dim mismatch"):
        ta.flash_decode_paged(torch.zeros(2, 8, 8), kp, kp, bt, sl)
    with pytest.raises(ValueError, match="kv heads must divide"):
        ta.flash_decode_paged(torch.zeros(2, 3, 16), kp, kp, bt, sl)
    with pytest.raises(ValueError, match="come together"):
        ta.flash_decode_paged(torch.zeros(2, 4, 16), kp, kp, bt, sl, k_scales=torch.zeros(4, 8, 2))
    with pytest.raises(ValueError, match="q_positions"):
        ta.flash_decode_paged_multi(torch.zeros(2, 3, 4, 16), kp, kp, bt, np.zeros((2, 2), np.int32))
