"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; skips without one. This file imports no
jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops import attention as ta


def _assert_close(got, want, dt, floor=0.0):
    """Per output row w (D values): each element within
    rtol * |w| + atol_rms * rms(w), and the row within a relative L2
    error; the same rule and limits as chip_smoke.py's (float16: its
    TOL["fp16"], and TOL["fp16_grad"] for a gradient, given with a floor).
    `floor` raises each row's scale to at least that share of the whole
    tensor's RMS (a gradient row can be ~0 by cancellation while its
    rounding error follows its terms)."""
    if dt == torch.float16:
        rtol, atol_rms, row = (4e-3, 5e-3, 2e-3) if floor else (4e-3, 8e-3, 2e-3)
    else:
        rtol, atol_rms, row = (2e-2, 5e-2, 1e-2) if dt == torch.bfloat16 else (1e-5, 5e-5, 1e-5)
    d = want.shape[-1]
    got, want = got.float().reshape(-1, d), want.float().reshape(-1, d)
    err = (got - want).abs()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    rms = rms.clamp_min(floor * want.pow(2).mean().sqrt().item())
    assert (err <= rtol * want.abs() + atol_rms * rms).all(), err.max().item()
    rel = err.norm(dim=-1) / (rms.squeeze(-1) * math.sqrt(d)).clamp_min(1e-30)
    assert rel.max().item() <= row


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flash_bf16_causal", "flash_f32_ragged", "flash_dropout",
                                  "paged_decode", "paged_extend_int8", "paged_extend_rows_split",
                                  "paged_split_boundary", "paged_extend_int8_multi_split",
                                  "paged_bit_identical", "paged_one_split"])
def test_cuda_kernel_matches_plain(case):
    """On the card: each wrapper (which launches its kernel once) against
    the kernel's plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s, dt=torch.float32: torch.randn(*s, generator=g, device=dev).to(dt)
    before = dict(ta.LAUNCHES)
    if case.startswith("flash"):
        dt = torch.bfloat16 if case == "flash_bf16_causal" else torch.float32
        sq = 40 if case == "flash_f32_ragged" else 256
        q, k, v = rn(1, sq, 8, 128, dt=dt), rn(1, sq, 2, 128, dt=dt), rn(1, sq, 2, 128, dt=dt)
        causal = case != "flash_f32_ragged"
        p = 0.1 if case == "flash_dropout" else 0.0
        got, lse = ta.flash_attention_bshd_lse(q, k, v, causal=causal, dropout_p=p, dropout_seed=42)
        want, lse_w = ta._flash_plain(q, k, v, causal, 1.0 / math.sqrt(128), p, 42)
        _assert_close(got, want, dt)
        torch.testing.assert_close(lse, lse_w, rtol=1e-4, atol=1e-4)
        assert ta.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    else:
        # (queries, q dtype, int8 pages, table width, last query's position per row):
        # the wrapper's plan at B 4, H 8 / Hkv 2 splits a 15-page table into
        # 4 splits and a 40-page table into 10, of 4 pages (64 slots), so
        # frontiers 255/256/511 sit on split boundaries; a 4-page table is
        # one split ("paged_one_split": no workspace, no merge)
        qn, dt, int8, m, last = {
            "paged_decode": (1, torch.bfloat16, False, 15, [200, 17, 239, 90]),
            "paged_extend_int8": (4, torch.float32, True, 15, [200, 17, 239, 90]),
            "paged_extend_rows_split": (40, torch.bfloat16, False, 15, [200, 17, 239, 90]),
            "paged_split_boundary": (1, torch.bfloat16, False, 40, [255, 256, 511, 0]),
            "paged_extend_int8_multi_split": (4, torch.bfloat16, True, 40, [600, 17, 258, 513]),
            "paged_bit_identical": (1, torch.bfloat16, False, 40, [639, 300, 256, 1]),
            "paged_one_split": (4, torch.bfloat16, False, 4, [63, 17, 40, 2]),
        }[case]
        plan = ta.paged_split_plan(4, qn, 8, 2, 128, m, ta._sm_count(0),
                                   torch.int8 if int8 else dt)
        assert plan["splits"] == m // 4 + (m % 4 > 0) and plan["split_pages"] == 4
        q = rn(4, qn, 8, 128, dt=dt)
        kp, vp = rn(4 * m + 4, 16, 2, 128), rn(4 * m + 4, 16, 2, 128)
        kw = {}
        if int8:
            from paddle_tpu_torch.quantization.observers import absmax_scale, quantize_absmax

            ks, vs = absmax_scale(kp, dim=-1), absmax_scale(vp, dim=-1)
            kp, vp = quantize_absmax(kp, ks[..., None]), quantize_absmax(vp, vs[..., None])
            kw = dict(k_scales=ks, v_scales=vs)
        else:
            kp, vp = kp.to(dt), vp.to(dt)
        bt = torch.randperm(4 * m + 3, generator=g, device=dev)[:4 * m].reshape(4, m).int() + 1
        last = torch.tensor(last, device=dev)
        qpos = (last[:, None] - (qn - 1) + torch.arange(qn, device=dev)[None]).clamp_min(0).int()
        got = ta.flash_decode_paged_multi(q, kp, vp, bt, qpos, **kw)
        want = ta.paged_extend_reference(q, kp, vp, bt, qpos, **kw)
        _assert_close(got, want, dt)
        assert ta.LAUNCHES["paged_attn"] == before["paged_attn"] + 1
        if case == "paged_bit_identical":  # the merge sums the splits in a fixed order
            assert all(torch.equal(got, ta.flash_decode_paged_multi(q, kp, vp, bt, qpos, **kw))
                       for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bwd_bf16_causal_gqa", "bwd_f32_ragged", "bwd_f32_dropout_lse"])
def test_cuda_flash_backward_matches_plain(case):
    """On the card: gradients through the flash wrapper (its backward
    launches the dq and dk/dv kernels once each) against the plain backward
    on the same saved tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16 if case.startswith("bwd_bf16") else torch.float32
    sq, sk = (300, 777) if case == "bwd_f32_ragged" else (256, 256)
    p = 0.1 if "dropout" in case else 0.0
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
    q, k, v, do = rn(1, sq, 8, 128), rn(1, sk, 2, 128), rn(1, sk, 2, 128), rn(1, sq, 8, 128)
    g_lse = torch.randn(1, 8, sq, generator=g, device=dev) if "lse" in case else None
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(ta.LAUNCHES)
    out, lse = ta.flash_attention_bshd_lse(*leaves, causal=True, dropout_p=p, dropout_seed=7)
    got = torch.autograd.grad([out, lse] if g_lse is not None else [out], leaves,
                              [do, g_lse] if g_lse is not None else [do])
    assert ta.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert ta.LAUNCHES["flash_bwd_dkdv"] == before["flash_bwd_dkdv"] + 1
    delta = (do.float() * out.detach().float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse
    want = ta._flash_bwd_plain(q, k, v, do, lse.detach(), delta.contiguous(), True,
                               1.0 / math.sqrt(128), p, 7)
    for a, w in zip(got, want):
        _assert_close(a, w, dt, floor=0.1)


# (b, sq, sk, h, hkv, d, causal, dropout_p) of the tensor-core variant's cases
_TC_CASES = {
    "d128_gqa_causal": (1, 256, 256, 8, 2, 128, True, 0.0),
    "d128_ragged_causal": (2, 300, 777, 8, 2, 128, True, 0.0),  # bottom-right offset 477
    "d128_sq_odd_causal": (1, 301, 777, 8, 2, 128, True, 0.0),  # Sq % 4 != 0: lse rows unaligned
    "d128_dropout": (1, 256, 256, 8, 2, 128, True, 0.1),
    "d64_mha_noncausal": (2, 200, 200, 4, 4, 64, False, 0.0),
    "d64_mha_causal_dropout": (1, 333, 333, 4, 4, 64, True, 0.1),
    # ERNIE's two bench shapes at a reduced batch: seq 128 with 12 heads of
    # 64, seq 4096 with 6 heads of 128 and attention dropout 0.1; non-causal
    "d64_ernie_seq128": (4, 128, 128, 12, 12, 64, False, 0.0),
    "d128_ernie_seq4096_dropout": (1, 4096, 4096, 6, 6, 128, False, 0.1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"])
@pytest.mark.parametrize("case", sorted(_TC_CASES))
def test_cuda_tensor_core_flash_matches_plain(kernel, case):
    """On the card: the bf16 tensor-core (wgmma) variants of the flash
    forward, dq and dk/dv, through their wrappers (one launch each), against
    the plain versions on the same inputs, with GQA, ragged tails,
    bottom-right causal and dropout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    b, sq, sk, h, hkv, d, causal, p = _TC_CASES[case]
    assert ta.kernel_variant(kernel, torch.bfloat16, d) == "wgmma"
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    q, k, v, do = rn(b, sq, h, d), rn(b, sk, hkv, d), rn(b, sk, hkv, d), rn(b, sq, h, d)
    scale = 1.0 / math.sqrt(d)
    before = dict(ta.LAUNCHES)
    out, lse = ta.flash_attention_bshd_lse(q, k, v, causal=causal, dropout_p=p, dropout_seed=9)
    if kernel == "flash_fwd":
        want, lse_w = ta._flash_plain(q, k, v, causal, scale, p, 9)
        _assert_close(out, want, torch.bfloat16)
        torch.testing.assert_close(lse, lse_w, rtol=1e-4, atol=1e-4)
    else:
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, causal, scale, p, 9)
        if kernel == "flash_bwd_dq":
            got, want = (ta._flash_bwd_dq_cuda(*args),), ta._flash_bwd_plain(*args)[:1]
        else:
            got, want = ta._flash_bwd_dkdv_cuda(*args), ta._flash_bwd_plain(*args)[1:]
        for a, w in zip(got, want):
            _assert_close(a, w, torch.bfloat16, floor=0.1)
    assert ta.LAUNCHES[kernel] == before[kernel] + 1


# (b, sq, sk, h, hkv, d, causal, dropout_p) of the float16 cases: the
# tensor-core variant at the Llama and ERNIE head dims, and head_dim 96,
# which only the CUDA-core variant takes
_FP16_CASES = {
    "d128_gqa_causal": (1, 256, 256, 8, 2, 128, True, 0.0),
    "d128_ragged_causal": (2, 300, 777, 8, 2, 128, True, 0.0),
    "d128_dropout": (1, 256, 256, 8, 2, 128, True, 0.1),
    "d64_ernie_seq128_dropout": (4, 128, 128, 12, 12, 64, False, 0.1),
    "d96_cuda_core_causal": (1, 256, 256, 8, 2, 96, True, 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"])
@pytest.mark.parametrize("case", sorted(_FP16_CASES))
def test_cuda_fp16_flash_matches_plain(kernel, case):
    """On the card: the float16 flash forward, dq and dk/dv (the wgmma
    variant at head dim 64/128, the CUDA-core one at 96) through their
    wrappers, one launch each, against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    b, sq, sk, h, hkv, d, causal, p = _FP16_CASES[case]
    assert ta.kernel_variant(kernel, torch.float16, d) == ("wgmma" if d in (64, 128)
                                                           else "cuda_core")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.float16)
    q, k, v, do = rn(b, sq, h, d), rn(b, sk, hkv, d), rn(b, sk, hkv, d), rn(b, sq, h, d)
    scale = 1.0 / math.sqrt(d)
    before = dict(ta.LAUNCHES)
    out, lse = ta.flash_attention_bshd_lse(q, k, v, causal=causal, dropout_p=p, dropout_seed=9)
    assert out.dtype == torch.float16
    if kernel == "flash_fwd":
        want, lse_w = ta._flash_plain(q, k, v, causal, scale, p, 9)
        _assert_close(out, want, torch.float16)
        torch.testing.assert_close(lse, lse_w, rtol=1e-4, atol=1e-4)
    else:
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, causal, scale, p, 9)
        if kernel == "flash_bwd_dq":
            got, want = (ta._flash_bwd_dq_cuda(*args),), ta._flash_bwd_plain(*args)[:1]
        else:
            got, want = ta._flash_bwd_dkdv_cuda(*args), ta._flash_bwd_plain(*args)[1:]
        for a, w in zip(got, want):
            assert a.dtype == torch.float16
            _assert_close(a, w, torch.float16, floor=0.1)
    assert ta.LAUNCHES[kernel] == before[kernel] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m2", [torch.float32, torch.bfloat16])
def test_cuda_fused_adamw_bf16_params_matches_plain(m2):
    """On the card: the fused AdamW kernel on a bf16 P (amp.decorate O2, no
    master copy) rounds as the plain version does: P bit-identical, m
    within one f32 ulp, a bf16 moment2's bits as in the f32-P case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    from paddle_tpu_torch.ops import fused_optimizer as fo

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    n = fo.PAD_ELEMS * 64
    rn = lambda: torch.randn(n, generator=g, device=dev)
    p, m, grad = (rn() * 0.02).to(torch.bfloat16), rn() * 1e-4, rn() * 1e-3
    v = (rn() * 1e-4).square().to(m2)
    kw = dict(lr=1e-3, clip_scale=0.5, c1=0.271, c2=0.002997, seed=0x9E3779B9, beta1=0.9,
              beta2=0.999, eps=1e-8, wd=0.01, decoupled=True)
    scal = fo._scalars(kw["lr"], kw["clip_scale"], kw["c1"], kw["c2"], dev)
    wp, wm, wv = fo._reference_apply(p, m, v, grad, scal, kw["seed"], 0.9, 0.999, 1e-8, 0.01, True,
                                     m2 == torch.bfloat16)
    before = fo.LAUNCHES["fused_adamw"]
    fo.fused_adamw_apply(p, m, v, grad, **kw)
    assert fo.LAUNCHES["fused_adamw"] == before + 1
    assert p.dtype == torch.bfloat16 and torch.equal(p.view(torch.int16), wp.view(torch.int16))
    torch.testing.assert_close(m, wm, rtol=2.0 ** -22, atol=0)
    if m2 == torch.bfloat16:
        kb, wb = v.view(torch.int16).int(), wv.view(torch.int16).int()
        assert (kb == wb).float().mean().item() >= 0.9999
        assert (kb - wb).abs().max().item() <= 1
    else:
        torch.testing.assert_close(v, wv, rtol=2.0 ** -22, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m2", [torch.float32, torch.bfloat16])
def test_cuda_fused_adamw_matches_plain(m2):
    """On the card: the fused AdamW kernel rounds every operation as the
    plain version does; a bf16 moment2's bits agree (at least 99.99%, the
    rest within one bf16 ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    from paddle_tpu_torch.ops import fused_optimizer as fo

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    n = fo.PAD_ELEMS * 64
    rn = lambda: torch.randn(n, generator=g, device=dev)
    p, m, grad = rn() * 0.02, rn() * 1e-4, rn() * 1e-3
    v = (rn() * 1e-4).square().to(m2)
    kw = dict(lr=1e-4, clip_scale=0.5, c1=0.271, c2=0.002997, seed=0xDEADBEEF, beta1=0.9,
              beta2=0.999, eps=1e-8, wd=0.01, decoupled=True)
    scal = fo._scalars(kw["lr"], kw["clip_scale"], kw["c1"], kw["c2"], dev)
    wp, wm, wv = fo._reference_apply(p, m, v, grad, scal, kw["seed"], 0.9, 0.999, 1e-8, 0.01, True,
                                     m2 == torch.bfloat16)
    before = fo.LAUNCHES["fused_adamw"]
    fo.fused_adamw_apply(p, m, v, grad, **kw)
    assert fo.LAUNCHES["fused_adamw"] == before + 1
    torch.testing.assert_close(p, wp, rtol=2.0 ** -22, atol=0)
    torch.testing.assert_close(m, wm, rtol=2.0 ** -22, atol=0)
    if m2 == torch.bfloat16:
        kb, wb = v.view(torch.int16).int(), wv.view(torch.int16).int()
        assert (kb == wb).float().mean().item() >= 0.9999
        assert (kb - wb).abs().max().item() <= 1
    else:
        torch.testing.assert_close(v, wv, rtol=2.0 ** -22, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt,bias,wdt,r,d", [
    (torch.bfloat16, True, torch.bfloat16, 333, 1032),
    (torch.float32, False, torch.float32, 333, 1032),
    (torch.bfloat16, False, torch.bfloat16, 1000, 4096),   # Llama-3 width, bf16 weight
    (torch.bfloat16, False, torch.float32, 1000, 4096),    # the entry point's mixed types
    (torch.float32, True, torch.bfloat16, 100, 8192),      # f32 x with a bf16 weight and bias
    (torch.bfloat16, True, torch.bfloat16, 40, 16392),     # wide rows, D % 64 != 0
])
def test_cuda_rms_norm_matches_plain(dt, bias, wdt, r, d):
    """On the card: the RMSNorm wrapper (one kernel launch) against the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    from paddle_tpu_torch.incubate.nn import functional as IF

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(r, d, generator=g, device=dev).to(dt)
    w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(wdt)
    b = (0.1 * torch.randn(d, generator=g, device=dev)).to(wdt) if bias else None
    before = IF.LAUNCHES["rms_norm"]
    got = IF.fused_rms_norm(x, w, b)
    assert IF.LAUNCHES["rms_norm"] == before + 1
    _assert_close(got, IF._rms_norm_ref(x, w, b, 1e-6), dt)
