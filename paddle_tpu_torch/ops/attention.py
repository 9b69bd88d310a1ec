"""Flash attention (forward and backward) and paged attention: the
counterpart of the flash and paged parts of paddle_tpu/ops/pallas.py.

Each kernel has three pieces here:
- the plain PyTorch version of the function (the CPU path, and the
  oracle the kernel is held against on the card);
- the wrapper, which launches the hand-written CUDA kernel
  (ops/kernels/*.cu) for a CUDA tensor or raises, and takes the plain
  version only for a CPU tensor;
- a launch count in `LAUNCHES` (ops/launches.py), bumped where the kernel
  launches and nowhere else, so a run can show that its main path went
  through it.

Layouts follow the JAX package: q/k/v [B, S, H, D]; pages [N, bs, Hkv, D].
"""
from __future__ import annotations

import functools
import math
import numbers
from typing import Optional, Tuple

import torch

from ..framework import random as _random
from .launches import LAUNCHES, reset_launch_counts  # noqa: F401  (re-exported)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# ---------------------------------------------------------------------------
# which kernel runs: the one place the choice is made
# ---------------------------------------------------------------------------

# kernels with a bf16 tensor-core (wgmma) variant, and the head dims it takes
TC_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
TC_HEAD_DIMS = (64, 128)
_VARIANT_CODE = {"cuda_core": 0, "wgmma": 1}


def kernel_variant(kernel: str, dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel variant that `kernel` ("flash_fwd", "flash_bwd_dq"
    or "flash_bwd_dkdv") runs for q/k/v of `dtype` and `head_dim`: "wgmma"
    (the bf16 tensor-core kernel) for bf16 at a head dim of TC_HEAD_DIMS,
    "cuda_core" otherwise. f32 stays on the CUDA cores: the tensor cores
    would take it as TF32. Decided on dtype and head dim alone; the C entry
    point launches what it is given and refuses a variant it cannot run."""
    if kernel in TC_KERNELS and dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


def _check_tc_operands(name: str, tensors) -> None:
    """TMA reads a tensor through a map whose base must be 16-byte aligned."""
    for tname, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel (wgmma variant): {tname} must start 16-byte aligned")


# ---------------------------------------------------------------------------
# dropout: stateless position hash (pallas.py:164-215)
# ---------------------------------------------------------------------------
#
# The JAX kernel hashes in int32 with wraparound multiplies and LOGICAL
# right shifts. Torch's >> on int32 is arithmetic, so the plain version
# works on int64 tensors holding the uint32 bit pattern, and multiplies
# modulo 2^32 in two 16-bit halves so no product leaves int64.

_M32 = 0xFFFFFFFF
_C_Q = 0x9E3779B1
_C_K = 0x85EBCA77
_C_BH = 0x27D4EB2F
_C_M1 = 0x85EBCA6B
_C_M2 = 0xC2B2AE35
_DROP_BITS = 23


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and a uint32 constant."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _keep_threshold(dropout_p: float) -> int:
    return int(round((1.0 - float(dropout_p)) * (1 << _DROP_BITS)))


def _hash_keep(seed: int, bh, qpos, kpos, thresh: int) -> torch.Tensor:
    """Keep-mask for absolute score positions (qpos, kpos) under
    (seed, q-head bh); broadcasting int tensors. Bit-identical to the JAX
    kernel's and the CUDA kernel's hash."""
    bh, qpos, kpos = (torch.as_tensor(x, dtype=torch.int64) & _M32 for x in (bh, qpos, kpos))
    u = _mul32(qpos, _C_Q) ^ _mul32(kpos, _C_K) ^ (((int(seed) & _M32) + _mul32(bh, _C_BH)) & _M32)
    u = u ^ (u >> 16)
    u = _mul32(u, _C_M1)
    u = u ^ (u >> 13)
    u = _mul32(u, _C_M2)
    u = u ^ (u >> 16)
    return (u & ((1 << _DROP_BITS) - 1)) < thresh


def dropout_keep_reference(seed: int, n_bh: int, sq: int, sk: int, dropout_p: float,
                           device=None) -> torch.Tensor:
    """[n_bh, sq, sk] bool keep-mask: the exact mask the kernels apply."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    return _hash_keep(int(seed), ar(n_bh)[:, None, None], ar(sq)[None, :, None],
                      ar(sk)[None, None, :], _keep_threshold(dropout_p))


def _as_seed(dropout_seed, dropout_p: float, device) -> int:
    """The int32 dropout seed of a call; None with active dropout draws a
    fresh one from the framework generator."""
    if dropout_seed is None:
        return _random.fresh_int32_seed(device) if dropout_p > 0.0 else 0
    if isinstance(dropout_seed, torch.Tensor):
        if dropout_seed.numel() != 1:
            raise ValueError(f"dropout_seed must be a scalar, got shape {tuple(dropout_seed.shape)}")
        if dropout_seed.is_floating_point() or dropout_seed.dtype == torch.bool:
            raise ValueError(f"dropout_seed must be an integer scalar, got dtype {dropout_seed.dtype}")
        dropout_seed = int(dropout_seed.item())
    if isinstance(dropout_seed, bool) or not isinstance(dropout_seed, numbers.Integral):
        raise ValueError(f"dropout_seed must be an int32-range integer scalar, got {dropout_seed!r}")
    v = int(dropout_seed)
    if not (-(2 ** 31) <= v < 2 ** 31):
        raise ValueError(f"dropout_seed {v} is outside int32 range [-2**31, 2**31)")
    return v


def _check_heads(q, k, v) -> None:
    h, hk, hv = q.shape[2], k.shape[2], v.shape[2]
    if hk != hv or h % hk != 0:
        raise ValueError(
            f"flash attention GQA needs k/v heads equal and dividing q heads; got q={h}, k={hk}, v={hv}"
        )


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D]: kv head i serves q heads
    [i * n_rep, (i + 1) * n_rep)."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


# ---------------------------------------------------------------------------
# B1: flash forward
# ---------------------------------------------------------------------------

def _flash_plain(q, k, v, causal, scale, dropout_p, seed, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash kernel: f32 scores of the storage-typed
    inputs, bottom-right causal mask, dropout from the position hash with
    a dropout-free normaliser, p rounded to the storage type before P.V.
    An optional `mask` broadcastable to [B, H, Sq, Sk] (the sdpa chain's;
    the kernel takes none) selects where bool and adds where float.
    Returns (out [B, Sq, H, D], lse [B, H, Sq] f32)."""
    b, sq, h, d = q.shape
    sk, group = k.shape[1], h // k.shape[2]
    qh = q.transpose(1, 2).float()
    kh = repeat_kv(k, group).transpose(1, 2).float()
    vh = repeat_kv(v, group).transpose(1, 2).float()
    logits = (qh @ kh.transpose(-1, -2)) * scale
    if causal:
        visible = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~visible, -1e30)
    if mask is not None:
        logits = (logits.masked_fill(~mask, -1e30) if mask.dtype == torch.bool
                  else logits + mask.float())
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = dropout_keep_reference(seed, b * h, sq, sk, dropout_p, device=q.device)
        inv_keep = torch.tensor(1.0 / (1.0 - dropout_p), dtype=torch.float32)
        p = torch.where(keep.reshape(b, h, sq, sk), p * inv_keep.to(q.device), 0.0)
    out = p.to(q.dtype).float() @ vh
    return out.to(q.dtype).transpose(1, 2), lse


def _flash_cuda(q, k, v, causal, scale, dropout_p, seed) -> Tuple[torch.Tensor, torch.Tensor]:
    from .kernels import build

    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash kernel: {name} must be on {q.device}, got {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel: {name} must be contiguous")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d > 256:
        raise ValueError(f"flash kernel: head_dim {d} > 256")
    variant = kernel_variant("flash_fwd", q.dtype, d)
    if variant == "wgmma":
        _check_tc_operands("flash", (("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    use_drop = dropout_p > 0.0
    fn = build.function("flash_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, sq, sk, h, hkv, d, int(causal), float(scale), int(use_drop),
            int(seed) & _M32, _keep_threshold(dropout_p) if use_drop else 0,
            float(1.0 / (1.0 - dropout_p)) if use_drop else 1.0, _VARIANT_CODE[variant],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


# ---------------------------------------------------------------------------
# B2/B3: flash backward (pallas.py:482-705)
# ---------------------------------------------------------------------------

def _flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, dropout_p, seed):
    """Plain version of the two backward kernels: the recompute-based FA2
    backward with the kernels' rounding points. lse and delta are f32
    [B, H, Sq] (delta = rowsum(dO*O) - g_lse). p = exp(s - lse);
    dp = dO.V^T, times z = keep/(1-p) under dropout; ds = p*(dp - delta)*scale.
    dq = ds.K with ds rounded to k's type; dv = (p*z)^T.dO with p*z rounded
    to dO's type and dk = ds^T.Q with ds rounded to q's type, summed over
    each kv head's group of q heads in f32. Returns (dq, dk, dv)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qh, doh = q.transpose(1, 2).float(), do.transpose(1, 2).float()
    kh = repeat_kv(k, group).transpose(1, 2).float()
    vh = repeat_kv(v, group).transpose(1, 2).float()
    s = (qh @ kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        visible = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        p = p.masked_fill(~visible, 0.0)
    dp = doh @ vh.transpose(-1, -2)
    pz = p
    if dropout_p > 0.0:
        keep = dropout_keep_reference(seed, b * h, sq, sk, dropout_p, device=q.device)
        inv_keep = torch.tensor(1.0 / (1.0 - dropout_p), dtype=torch.float32)
        z = torch.where(keep.reshape(b, h, sq, sk), inv_keep.to(q.device), 0.0)
        dp = dp * z
        pz = p * z
    ds = p * (dp - delta[..., None]) * scale
    dq = ds.to(k.dtype).float() @ kh
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ qh
    dv = pz.to(do.dtype).float().transpose(-1, -2) @ doh
    fold = lambda t: t.reshape(b, hkv, group, sk, d).sum(dim=2)  # the group's q heads, f32
    return (dq.to(q.dtype).transpose(1, 2), fold(dk).to(k.dtype).transpose(1, 2),
            fold(dv).to(v.dtype).transpose(1, 2))


def _check_bwd_operands(q, k, v, do, lse, delta) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", do)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash backward kernel: {name} must be on {q.device}, got {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise TypeError(f"flash backward kernel takes float32 or bfloat16 tensors of one "
                            f"dtype, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash backward kernel: {name} must be contiguous")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash backward kernel: {name} must be contiguous float32 on {q.device}")
    if q.shape[-1] > 256:
        raise ValueError(f"flash backward kernel: head_dim {q.shape[-1]} > 256")


def _bwd_launch(fn_name, outs, q, k, v, do, lse, delta, causal, scale, dropout_p, seed) -> None:
    from .kernels import build

    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    use_drop = dropout_p > 0.0
    variant = kernel_variant(fn_name, q.dtype, d)
    if variant == "wgmma":
        _check_tc_operands(fn_name, (("q", q), ("k", k), ("v", v), ("dout", do)))
    rc = build.function(fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(t.data_ptr() for t in outs), _DTYPE_CODE[q.dtype], b, sq, sk, h, hkv, d, int(causal),
        float(scale), int(use_drop), int(seed) & _M32,
        _keep_threshold(dropout_p) if use_drop else 0,
        float(1.0 / (1.0 - dropout_p)) if use_drop else 1.0, _VARIANT_CODE[variant],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, fn_name)
    LAUNCHES[fn_name] += 1


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale, dropout_p, seed) -> torch.Tensor:
    """B2: the dq kernel (ops/kernels/flash_bwd.cu), one launch."""
    _check_bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _bwd_launch("flash_bwd_dq", (dq,), q, k, v, do, lse, delta, causal, scale, dropout_p, seed)
    return dq


def _flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, causal, scale, dropout_p, seed):
    """B3: the dk/dv kernel (ops/kernels/flash_bwd.cu), one launch."""
    _check_bwd_operands(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkdv", (dk, dv), q, k, v, do, lse, delta, causal, scale, dropout_p,
                seed)
    return dk, dv


def _flash_bwd_cuda(q, k, v, do, lse, delta, causal, scale, dropout_p, seed):
    """The two hand-written backward kernels: dq, then dk/dv."""
    args = (q, k, v, do, lse, delta, causal, scale, dropout_p, seed)
    return (_flash_bwd_dq_cuda(*args),) + _flash_bwd_dkdv_cuda(*args)


class _FlashForward(torch.autograd.Function):
    """The flash kernel as a differentiable op (the JAX package's
    custom_vjp `_flash_core`, pallas.py:712-737): forward saves q, k, v,
    out, lse and the seed; backward runs the two backward kernels on CUDA
    tensors (the plain version on CPU tensors). Both out and lse are
    differentiable: lse's cotangent folds into delta (pallas.py:619-627)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, seed):
        impl = _flash_cuda if q.is_cuda else _flash_plain
        out, lse = impl(q, k, v, causal, scale, dropout_p, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, dropout_p, seed)
        ctx.set_materialize_grads(False)  # an unused output's gradient arrives as None
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        # delta = rowsum(dO * O) in f32, minus the lse cotangent: [B, H, Sq]
        delta = (g_out.float() * out.float()).sum(dim=-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse.float()
        impl = _flash_bwd_cuda if q.is_cuda else _flash_bwd_plain
        dq, dk, dv = impl(q, k, v, g_out.contiguous(), lse.contiguous(), delta.contiguous(),
                          *ctx.args)
        return dq, dk, dv, None, None, None, None


def _flash(q, k, v, causal, sm_scale, dropout_p, dropout_seed):
    _check_heads(q, k, v)
    if q.ndim != 4:
        raise ValueError(f"flash attention takes [B, S, H, D] q, got {tuple(q.shape)}")
    if causal and k.shape[1] < q.shape[1]:
        raise ValueError(
            "causal flash attention needs kv length >= q length (bottom-right alignment "
            f"would mask whole query rows); got sq={q.shape[1]}, sk={k.shape[1]}"
        )
    if not (0.0 <= dropout_p < 1.0):
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    seed = _as_seed(dropout_seed, float(dropout_p), q.device)
    return _FlashForward.apply(q, k, v, bool(causal), float(scale), float(dropout_p), seed)


def flash_attention_bshd(q, k, v, causal=False, sm_scale=None, dropout_p=0.0, dropout_seed=None):
    """Flash attention in paddle's [B, S, H, D] layout. k/v may carry fewer
    heads than q (GQA). dropout_p > 0 applies upscale-in-train dropout from
    the position hash keyed by `dropout_seed` (int32; None draws one)."""
    return _flash(q, k, v, causal, sm_scale, dropout_p, dropout_seed)[0]


def flash_attention_bshd_lse(q, k, v, causal=False, sm_scale=None, dropout_p=0.0,
                             dropout_seed=None):
    """Like flash_attention_bshd, also returning the per-row logsumexp
    [B, H, Sq] (f32)."""
    return _flash(q, k, v, causal, sm_scale, dropout_p, dropout_seed)


def ref_attention_bshd(q, k, v, causal=False, sm_scale=None, dropout_p=0.0, seed=None,
                       mask=None):
    """The plain attention chain (pallas.py:337): what runs wherever the
    flash kernel does not, including under an attention `mask`."""
    _check_heads(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = _as_seed(seed, float(dropout_p), q.device) if dropout_p > 0.0 else 0
    return _flash_plain(q, k, v, causal, scale, float(dropout_p), s, mask)[0]


# ---------------------------------------------------------------------------
# B4: paged attention (pallas.py:855-1124)
# ---------------------------------------------------------------------------

def _validate_paged(q, k_pages, k_scales, v_scales, fname) -> None:
    if q.shape[-1] != k_pages.shape[3]:
        raise ValueError(f"{fname}: head_dim mismatch q={tuple(q.shape)} pages={tuple(k_pages.shape)}")
    h, hkv = q.shape[-2], k_pages.shape[2]
    if hkv > h or h % hkv != 0:
        raise ValueError(f"{fname}: kv heads must divide q heads; got q={h}, kv={hkv}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{fname}: k_scales and v_scales must come together")
    if k_scales is not None and tuple(k_scales.shape) != tuple(k_pages.shape[:3]):
        raise ValueError(
            f"{fname}: scale planes {tuple(k_scales.shape)} do not match pages "
            f"{tuple(k_pages.shape[:3])} (per-slot-per-kv-head absmax)"
        )


def _int32_on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32).to(device)


def _dequant_pages(pages, scales) -> torch.Tensor:
    """int8 pages * (scale * (1/127)) in f32, as the kernel dequantizes."""
    return pages.float() * (scales.float() * (1.0 / 127.0))[..., None]


def paged_extend_reference(q, k_pages, v_pages, block_tables, q_positions, sm_scale=None,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """Plain version of the paged kernel. q [B, Q, H, D]; query j of row b
    attends to every cache position <= q_positions[b, j]. -> [B, Q, H, D]."""
    b, qn, h, d = q.shape
    n, bs, hkv, _ = k_pages.shape
    group = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    bt = _int32_on(block_tables, q.device).long()
    qp = _int32_on(q_positions, q.device)
    if k_scales is not None:
        k = _dequant_pages(k_pages[bt], k_scales[bt])
        v = _dequant_pages(v_pages[bt], v_scales[bt])
    else:
        k, v = k_pages[bt], v_pages[bt]
    k = repeat_kv(k.reshape(b, -1, hkv, d), group)  # [B, S, H, D]
    v = repeat_kv(v.reshape(b, -1, hkv, d), group)
    logits = torch.einsum("bqhd,bshd->bqhs", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    logits = logits.masked_fill(pos[None, None, None, :] > qp[:, :, None, None], -1e30)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bqhs,bshd->bqhd", p.float(), v.float()).to(q.dtype)


def paged_decode_reference(q, k_pages, v_pages, block_tables, seq_lens, sm_scale=None,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """Single-query case: q [B, H, D], positions seq_lens - 1."""
    qp = _int32_on(seq_lens, q.device) - 1
    return paged_extend_reference(q[:, None], k_pages, v_pages, block_tables, qp[:, None],
                                  sm_scale, k_scales, v_scales)[:, 0]


# How the paged kernel cuts a call, from shapes alone. The context of each
# (b, kv head) is split so that the grid holds about PAGED_CTAS_PER_SM CTAs
# for each SM of the card, with at least PAGED_MIN_SPLIT_PAGES pages a
# split. On the mma path a CTA streams 4 warps' rings (~70 KB of shared
# memory: 3 fit an SM); on the CUDA-core path one ring with a barrier a
# tile, so it wants more, shorter splits. At the serving shape (B 8, Hkv 8,
# a 128-page table, 132 SMs) that is 7 splits of 19 pages (448 CTAs) on
# the mma path. The Q * H / Hkv query rows of a (b, kv head) go to as few
# CTAs as hold them: 16 rows (one mma tile) a CTA for bf16 pages at head
# dim 64 or 128, whose scores and P.V run on the tensor cores; else
# PAGED_ROWS_PER_CTA at head dim 128, proportionally fewer at wider heads,
# so their f32 state fits in shared memory beside the ring.
PAGED_CTAS_PER_SM = {"mma": 3, "cuda_core": 8}
PAGED_MIN_SPLIT_PAGES = 4
PAGED_ROWS_PER_CTA = 64
PAGED_MMA_ROWS = 16


def paged_uses_mma(kv_dtype: torch.dtype, d: int) -> bool:
    """Whether the paged kernel runs its tensor-core (mma) path: bf16 pages
    at head dim 64 or 128. Every other case runs on the CUDA cores."""
    return kv_dtype == torch.bfloat16 and d in (64, 128)


@functools.lru_cache(maxsize=256)
def paged_split_plan(b: int, qn: int, h: int, hkv: int, d: int, m: int, sms: int,
                     kv_dtype: torch.dtype = torch.bfloat16,
                     split_pages: Optional[int] = None) -> dict:
    """The paged kernel's plan for q [b, qn, h, d], kv heads `hkv`, a block
    table [b, m], a card of `sms` SMs and pages of `kv_dtype`, from shapes
    alone (no frontier is read back from the device): pages a split
    (`split_pages` overrides the rule, for comparisons of split sizes) and
    the number of splits, q rows a CTA and row tiles, the grid's CTAs, and
    the f32 floats of the merge's workspace (0 with one split: the kernel
    then writes the output itself). Cached per shape, so a decode step pays
    for a plan once; the dict is shared, so callers only read it."""
    rows = qn * (h // hkv)
    mma = paged_uses_mma(kv_dtype, d)
    cap = PAGED_MMA_ROWS if mma else max(1, min(PAGED_ROWS_PER_CTA, PAGED_ROWS_PER_CTA * 128 // d))
    tiles = -(-rows // cap)
    if split_pages is None:
        per_sm = PAGED_CTAS_PER_SM["mma" if mma else "cuda_core"]
        fill = -(-per_sm * sms // (b * hkv * tiles))
        split_pages = -(-m // max(1, min(fill, -(-m // PAGED_MIN_SPLIT_PAGES))))
    sp = max(1, min(int(split_pages), m))
    splits = -(-m // sp)
    return dict(split_pages=sp, splits=splits, rows_per_cta=-(-rows // tiles), row_tiles=tiles,
                ctas=b * hkv * splits * tiles,
                workspace_floats=b * qn * h * splits * (d + 2) if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _paged_cuda(q, k_pages, v_pages, block_tables, q_positions, scale, k_scales, v_scales):
    from .kernels import build

    dev = q.device
    quantized = k_scales is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged kernel takes float32 or bfloat16 queries, got {q.dtype}")
    want = torch.int8 if quantized else q.dtype
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != want:
            raise TypeError(f"paged kernel: {name} is {t.dtype}, expected {want}")
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages)]
    if quantized:
        tensors += [("k_scales", k_scales), ("v_scales", v_scales)]
        if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
            raise TypeError("paged kernel: scale planes must be float32")
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"paged kernel: {name} must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged kernel: {name} must be contiguous")
    b, qn, h, d = q.shape
    n, bs, hkv, _ = k_pages.shape
    row_bytes = d * k_pages.element_size()
    if row_bytes % 16 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"paged kernel: page rows ({row_bytes} bytes) and page bases must be "
                         "16-byte aligned")
    bt = _int32_on(block_tables, dev).contiguous()
    qp = _int32_on(q_positions, dev).contiguous()
    if bt.ndim != 2 or bt.shape[0] != b:
        raise ValueError(f"paged kernel: block_tables {tuple(bt.shape)} must be [B={b}, M]")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    plan = paged_split_plan(b, qn, h, hkv, d, bt.shape[1], _sm_count(index), k_pages.dtype)
    out = torch.empty_like(q)
    ws = (torch.empty(plan["workspace_floats"], dtype=torch.float32, device=dev)
          if plan["workspace_floats"] else None)
    fn = build.function("paged_attn")
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            bt.data_ptr(), qp.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], b, qn, h, hkv, d, bs, bt.shape[1],
            plan["split_pages"], plan["rows_per_cta"], float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "paged_attn")
    LAUNCHES["paged_attn"] += 1
    return out


def flash_decode_paged_multi(q, k_pages, v_pages, block_tables, q_positions, sm_scale=None,
                             k_scales=None, v_scales=None) -> torch.Tensor:
    """Multi-query paged attention (extend / speculative verify).

    q            [B, Q, H, D]
    k/v_pages    [N, bs, Hkv, D] (one layer of the pool)
    block_tables [B, M] int32, padded with the reserved page 0
    q_positions  [B, Q] int32: query j sees cache positions <= its own
    k/v_scales   [N, bs, Hkv] f32 for an int8 pool
    """
    if q.ndim != 4:
        raise ValueError(f"flash_decode_paged_multi: q must be [B, Q, H, D], got {tuple(q.shape)}")
    _validate_paged(q, k_pages, k_scales, v_scales, "flash_decode_paged_multi")
    if tuple(torch.as_tensor(q_positions).shape) != tuple(q.shape[:2]):
        raise ValueError(
            f"flash_decode_paged_multi: q_positions {tuple(torch.as_tensor(q_positions).shape)} "
            f"must match q's [B, Q] {tuple(q.shape[:2])}"
        )
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _paged_cuda(q, k_pages, v_pages, block_tables, q_positions, scale, k_scales, v_scales)
    return paged_extend_reference(q, k_pages, v_pages, block_tables, q_positions, scale,
                                  k_scales, v_scales)


def flash_decode_paged(q, k_pages, v_pages, block_tables, seq_lens, sm_scale=None,
                       k_scales=None, v_scales=None) -> torch.Tensor:
    """Single-query attention over the paged cache: q [B, H, D], seq_lens
    [B] (>= 1) -> [B, H, D]."""
    _validate_paged(q, k_pages, k_scales, v_scales, "flash_decode_paged")
    qp = _int32_on(seq_lens, q.device) - 1
    return flash_decode_paged_multi(q[:, None], k_pages, v_pages, block_tables, qp[:, None],
                                    sm_scale, k_scales, v_scales)[:, 0]
