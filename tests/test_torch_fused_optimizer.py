"""Port parity: the fused AdamW (paddle_tpu_torch.ops.fused_optimizer, TPU
kernel B5), its flat-bucket engine and Adam/AdamW with the flag on and
off, against the JAX package on the same numpy inputs. The CUDA kernel
itself is held against the same plain version on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py)."""
import itertools

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.ops import fused_optimizer as jfo
from paddle_tpu.ops import pallas as pk

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import fused_optimizer as tfo


@pytest.fixture(autouse=True)
def _flags():
    yield
    paddle.set_flags({"FLAGS_fused_optimizer": False})
    ptt.set_flags({"FLAGS_fused_optimizer": False})


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1234, 0x9E3779B9, 0xFFFFFFFF])
def test_sr_bits_flat_bit_exact(seed):
    """uint32 hash and add-then-truncate in int64 on the port's side
    (torch has no logical shift on int32): the bits must equal JAX's."""
    rng = np.random.RandomState(seed & 0xFFFF)
    x = np.concatenate([rng.randn(500) * 10.0 ** rng.randint(-30, 30, 500),
                        [0.0, -0.0, 1.0, -1.0, 3.4e38, 1e-45]]).astype(np.float32)
    idx = np.concatenate([rng.randint(0, 2 ** 32, x.size - 3, dtype=np.uint64),
                          [0, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    want = jfo._sr_bits_flat(jnp.asarray(x), jnp.asarray(idx), jnp.uint32(seed))
    got = tfo._sr_bits_flat(torch.from_numpy(x), torch.from_numpy(idx.astype(np.int64)), seed)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_reference_apply_slices_hash_at_their_bucket_offset():
    """Slices of a bucket through the plain version at `base` = their flat
    offset give the whole bucket's result bit for bit (how a bucket too
    large for one plain call is checked); base 0 on a later slice does not."""
    rng = np.random.RandomState(7)
    n = 3 * tfo.PAD_ELEMS
    p, m, g = (torch.from_numpy(rng.randn(n).astype(np.float32)) for _ in range(3))
    v = torch.from_numpy((rng.randn(n) * 1e-3).astype(np.float32)).square().to(torch.bfloat16)
    scal = tfo._scalars(1e-3, 1.0, 0.271, 0.002997, "cpu")
    args = (scal, 0x9E3779B9, 0.9, 0.999, 1e-8, 0.01, True, True)
    whole = tfo._reference_apply(p, m, v, g, *args)
    step = tfo.PAD_ELEMS + 5
    parts = [tfo._reference_apply(p[i:i + step], m[i:i + step], v[i:i + step], g[i:i + step],
                                  *args, base=i) for i in range(0, n, step)]
    for w, got in zip(whole, zip(*parts)):
        assert torch.equal(torch.cat(got).view(torch.int16 if w.dtype == torch.bfloat16
                                               else torch.int32),
                           w.view(torch.int16 if w.dtype == torch.bfloat16 else torch.int32))
    unshifted = tfo._reference_apply(p[step:], m[step:], v[step:], g[step:], *args)[2]
    assert not torch.equal(unshifted.view(torch.int16), whole[2][step:].view(torch.int16))


def _bucket(rng, n, m2_bf16):
    p = rng.randn(n).astype(np.float32)
    m = (rng.randn(n) * 0.01).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    v = (np.abs(rng.randn(n)) * 0.01).astype(np.float32)
    for a in (p, m, g, v):
        a[-1000:] = 0.0  # padding lanes
    return p, m, v, g


@pytest.mark.parametrize("m2_bf16,decoupled,clip", [
    (False, True, 1.0), (True, True, 0.7), (True, False, 0.7), (False, False, 0.3)])
def test_fused_adamw_plain_matches_jax(m2_bf16, decoupled, clip):
    """The port's wrapper (plain version on the CPU, in place) against JAX's
    `_reference_apply` and its Pallas kernel in interpret mode. Both sides
    round each f32 operation in the same order: p, m and v agree to a few
    f32 ulps (XLA may contract a multiply-add), a bf16 moment2's bits
    exactly wherever the f32 v' agrees. The absolute floors are an f32 ulp
    of the larger term of each sum ((1 - b1) * g for m, lr * u for p):
    where the terms cancel, one rounding is large against the result."""
    n = tfo.PAD_ELEMS * 2
    p, m, v, g = _bucket(np.random.RandomState(int(m2_bf16) + 2 * int(decoupled)), n, m2_bf16)
    kw = dict(lr=1e-3, clip_scale=clip, c1=0.271, c2=0.002997, seed=0x9E3779B9, beta1=0.9,
              beta2=0.999, eps=1e-8, wd=0.01, decoupled=decoupled)
    vdt = jnp.bfloat16 if m2_bf16 else jnp.float32
    jv = jnp.asarray(v).astype(vdt)
    scal = jnp.asarray([kw["lr"], clip, kw["c1"], kw["c2"]], jnp.float32)
    ref = jfo._reference_apply(jnp.asarray(p), jnp.asarray(m), jv, jnp.asarray(g), scal,
                               jnp.asarray([kw["seed"]], jnp.uint32), 0.9, 0.999, 1e-8, 0.01,
                               decoupled, m2_bf16)
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        ker = jfo.fused_adamw_apply(jnp.asarray(p), jnp.asarray(m), jv, jnp.asarray(g), **kw)
    finally:
        pk._INTERPRET = old
    tp, tm, tg = (torch.from_numpy(a.copy()) for a in (p, m, g))
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(torch.bfloat16 if m2_bf16
                                                                   else torch.float32)
    out = tfo.fused_adamw_apply(tp, tm, tv, tg, **kw)
    assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
    assert tfo.LAUNCHES["fused_adamw"] == 0  # CPU: the plain version
    for want in (ref, ker):
        np.testing.assert_allclose(tp.numpy(), np.asarray(want[0]), rtol=5e-7, atol=1e-9)
        np.testing.assert_allclose(tm.numpy(), np.asarray(want[1]), rtol=5e-7, atol=1e-8)
        wv = np.asarray(want[2].astype(jnp.float32))
        if m2_bf16:
            same = _bits(tv.float().numpy()) == _bits(wv)
            assert same.mean() >= 0.999, same.mean()
            np.testing.assert_allclose(tv.float().numpy(), wv, rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(tv.numpy(), wv, rtol=5e-7, atol=1e-30)
    for t in (tp, tm, tv):
        assert (t[-1000:] == 0).all()
    with pytest.raises(ValueError, match="multiple of"):
        tfo.fused_adamw_apply(tp[:100], tm[:100], tv[:100], tg[:100], **kw)


def _param_arrays(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(4, 3).astype(np.float32), rng.randn(7).astype(np.float32),
            rng.randn(4, 3).astype(np.float32), rng.randn(2, 2, 3).astype(np.float32),
            rng.randn(5).astype(np.float32)]


def _jax_run(fused, arrays, steps, clip, m2, seeds, names, no_clip=()):
    paddle.set_flags({"FLAGS_fused_optimizer": fused})
    ps = [paddle.nn.Parameter(a.copy()) for a in arrays]
    for p, nm in zip(ps, names):
        p.name = nm
    for i in no_clip:
        ps[i].need_clip = False
    opt = paddle.optimizer.AdamW(0.01, parameters=ps, weight_decay=0.05, grad_clip=clip,
                                 moment2_dtype=m2,
                                 apply_decay_param_fun=lambda n: not n.startswith("bias"))
    it = iter(seeds)
    opt._m2_key = lambda: jnp.uint32(next(it))
    x = paddle.to_tensor(np.random.RandomState(1).randn(8, 4).astype(np.float32))
    for _ in range(steps):
        loss = ((x @ ps[0]).sum() + (ps[1] * 2).sum() + (x @ ps[2]).sum() + (ps[3] ** 2).sum()
                + (ps[4] ** 3).sum())
        loss.backward()
        opt.step()
        opt.clear_grad()
    return [np.asarray(p.numpy()) for p in ps], opt


def _port_run(fused, arrays, steps, clip, m2, seeds, names, no_clip=()):
    ptt.set_flags({"FLAGS_fused_optimizer": fused})
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]
    for i in no_clip:
        ps[i].need_clip = False
    opt = ptt.optimizer.AdamW(0.01, parameters=list(zip(names, ps)), weight_decay=0.05,
                              grad_clip=clip,
                              moment2_dtype=m2,
                              apply_decay_param_fun=lambda n: not n.startswith("bias"))
    it = iter(seeds)
    opt._m2_key = lambda: next(it)
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 4).astype(np.float32))
    for _ in range(steps):
        loss = ((x @ ps[0]).sum() + (ps[1] * 2).sum() + (x @ ps[2]).sum() + (ps[3] ** 2).sum()
                + (ps[4] ** 3).sum())
        loss.backward()
        opt.step()
        opt.clear_grad()
    return [p.detach().numpy() for p in ps], opt


NAMES = ["w0", "bias1", "w2", "w3", "w4"]


@pytest.mark.parametrize("fused,m2,clip", [
    (False, "float32", None), (True, "float32", None), (False, "float32", 0.5),
    (True, "float32", 0.5), (True, "bfloat16", 0.5), (False, "bfloat16", None)])
def test_adamw_matches_jax(fused, m2, clip):
    """3 AdamW steps, flag on (flat engine) and off (stacked per-shape
    groups and lone params), with ClipGradByGlobalNorm, a decay exclusion
    by name and one param outside the clip; a bf16 moment2 under the same
    fixed stochastic-rounding seeds. f32 on both sides: the params agree
    to f32 rounding of the same operations."""
    arrays = _param_arrays()
    seeds = [0x1234567 * (i + 1) & 0xFFFFFFFF for i in range(40)]
    jclip = paddle.nn.ClipGradByGlobalNorm(clip) if clip else None
    tclip = ptt.nn.ClipGradByGlobalNorm(clip) if clip else None
    want, jopt = _jax_run(fused, arrays, 3, jclip, m2, seeds, NAMES, no_clip=(3,))
    got, topt = _port_run(fused, arrays, 3, tclip, m2, seeds, NAMES, no_clip=(3,))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-7)
    assert topt.get_lr() == pytest.approx(jopt.get_lr(), rel=0, abs=0)


def test_engine_buckets_match_jax():
    """Bucket keys, parameter order, offsets, sizes and padding equal the
    JAX engine's: they fix each element's flat index and with it its
    stochastic-rounding noise."""
    arrays = _param_arrays()
    _, jopt = _jax_run(True, arrays, 1, paddle.nn.ClipGradByGlobalNorm(1.0), "bfloat16",
                       itertools.count(7), NAMES, no_clip=(3,))
    _, topt = _port_run(True, arrays, 1, ptt.nn.ClipGradByGlobalNorm(1.0), "bfloat16",
                        itertools.count(7), NAMES, no_clip=(3,))

    def layout(opt, dtype_name):
        out = {}
        for (dt, wd, s, need_clip), b in opt._flat_engine.buckets.items():
            order = sorted(b["index"].values())
            out[(dtype_name(dt), wd, s, need_clip)] = (order, b["n_pad"],
                                                        str(b["moment2"].dtype).split(".")[-1])
        return out

    jl = layout(jopt, lambda d: np.dtype(d).name)
    tl = layout(topt, lambda d: str(d).split(".")[-1])
    assert jl == tl
    assert len(tl) == 3  # (wd 0.05, clip), (wd 0 for "bias1", clip), (wd 0.05, no clip)


def test_flag_toggle_carries_state():
    """Turning the flag off after a fused step moves the flat moments into
    the per-tensor path (and back), as in the JAX package: a run that
    toggles equals the JAX run that toggles the same way."""
    arrays = _param_arrays(3)
    res = []
    for pkg, run in (("jax", _jax_run), ("port", _port_run)):
        ps, opt = run(True, arrays, 2, None, "float32", [], NAMES)
        flags = paddle.set_flags if pkg == "jax" else ptt.set_flags
        params = opt._param_groups[0]["params"] if pkg == "jax" else opt._params
        for fused in (False, True):
            flags({"FLAGS_fused_optimizer": fused})
            for p in params:
                g = np.full(p.shape, 0.3, np.float32)
                p.grad = paddle.to_tensor(g) if pkg == "jax" else torch.from_numpy(g)
            opt.step()
            opt.clear_grad()
        res.append([np.asarray(p.numpy() if pkg == "jax" else p.detach().numpy())
                    for p in params])
    for a, w in zip(res[1], res[0]):
        np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-7)
