"""One-pass AdamW/Adam over a flat bucket: the counterpart of
paddle_tpu/ops/fused_optimizer.py (TPU kernel B5).

The optimizer's whole elementwise update for a bucket of parameters
(params, moment1, moment2 and grads flattened into contiguous buffers)
runs as one kernel launch (ops/kernels/fused_adamw.cu) that reads
p/m/v/g once and writes p/m/v once, applying the global-norm clip scale,
coupled (Adam) or decoupled (AdamW) weight decay, bias correction through
the scalars c1 = 1 - beta1^t and c2 = 1 - beta2^t, and an optional bf16
second moment with stochastic rounding keyed by the flat index.

Three pieces, as for every kernel of the port:
- the plain PyTorch version `_reference_apply` (the CPU path, and the
  oracle the kernel is held against on the card), built on the one
  shared `_update_math` and `_sr_bits_flat`;
- the wrapper `fused_adamw_apply`, which launches the kernel for CUDA
  tensors or raises, and takes the plain version only for CPU tensors;
- the launch count `LAUNCHES["fused_adamw"]`.

Unlike the JAX function, which returns new arrays, the wrapper updates
p, m and v in place in the caller's buffers (on the CPU too) and returns
them: the bucket's moments never get a second copy on the card.

Layout contract: flat buffers are 1-D with a length that is a multiple of
`PAD_ELEMS` (the JAX package's TPU tile granularity, kept so that bucket
offsets, and with them the stochastic-rounding hash of every element, are
the JAX package's); padding lanes hold zeros and stay zero.
"""
from __future__ import annotations

import numbers

import torch

from .attention import _DTYPE_CODE, _M32, _mul32
from .launches import LAUNCHES

LANES = 1024
PAD_ROWS = 16
PAD_ELEMS = PAD_ROWS * LANES

_M1 = 0x9E3779B1
_M2 = 0x85EBCA6B


def pad_to_tile(n: int) -> int:
    """Smallest legal flat-buffer length >= n."""
    return max(PAD_ELEMS, -(-n // PAD_ELEMS) * PAD_ELEMS)


def _sr_bits_flat(x32: torch.Tensor, idx: torch.Tensor, seed: int) -> torch.Tensor:
    """f32 -> bf16-representable f32 with stochastic rounding: add the hash
    noise of (flat index, seed) below the bf16 cut, then drop the low 16
    bits. The JAX function works in uint32; torch has few uint32 ops, so
    this works on int64 holding the uint32 bit pattern (multiplies modulo
    2^32 in 16-bit halves, logical shifts of non-negative values)."""
    bits = x32.contiguous().view(torch.int32).to(torch.int64) & _M32
    u = _mul32(idx.to(torch.int64) & _M32, _M1) ^ (int(seed) & _M32)
    u = u ^ (u >> 16)
    u = _mul32(u, _M2)
    u = u ^ (u >> 13)
    kept = ((bits + (u & 0xFFFF)) & 0xFFFF0000).view(-1)
    kept = torch.where(kept >= 2 ** 31, kept - 2 ** 32, kept).to(torch.int32)
    return kept.view(torch.float32).view(x32.shape)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an f32 tensor. torch's CPU
    `sqrt` is not correctly rounded on every host (it can be one ulp off
    numpy's, XLA's eager root and the kernel's `__fsqrt_rn`), so a CPU
    tensor takes its root in f64 and rounds once: an f64 root rounded to
    f32 is the correctly rounded f32 root. CUDA's `sqrt` already is."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _update_math(p, m, v, g, lr, clip, c1, c2, *, beta1, beta2, eps, wd, decoupled):
    """The one shared AdamW/Adam elementwise update, f32 in and out, in the
    JAX package's order (paddle_tpu/ops/fused_optimizer.py:98-110)."""
    g = g * clip
    if wd and not decoupled:  # Adam: L2 folds into the gradient
        g = g + wd * p
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    upd = (m_new / c1) / (sqrt_rn(v_new / c2) + eps)
    if wd and decoupled:  # AdamW: decoupled decay joins the update
        upd = upd + wd * p
    return p - lr * upd, m_new, v_new


def _reference_apply(p, m, v, g, scal, seed, beta1, beta2, eps, wd, decoupled, m2_bf16, base=0):
    """Plain version of the kernel over a flat buffer. `scal` is f32 [4] =
    (lr, clip, c1, c2); `base` is the bucket's flat index of p[0] (a slice
    of a bucket hashes its elements as the whole bucket does). Returns new
    (p, m, v) in the input dtypes."""
    lr, clip, c1, c2 = scal[0], scal[1], scal[2], scal[3]
    p_new, m_new, v_new = _update_math(
        p.float(), m, v.float(), g.float(), lr, clip, c1, c2,
        beta1=beta1, beta2=beta2, eps=eps, wd=wd, decoupled=decoupled)
    if m2_bf16:
        idx = torch.arange(base, base + p.shape[0], dtype=torch.int64, device=p.device)
        v_new = _sr_bits_flat(v_new, idx, seed).to(torch.bfloat16)
    return p_new.to(p.dtype), m_new, v_new.to(v.dtype)


def _scalars(lr, clip_scale, c1, c2, device) -> torch.Tensor:
    """f32 [4] on `device`; a tensor operand (a clip scale computed on the
    card) is placed without a host round trip."""
    vals = [lr, clip_scale, c1, c2]
    scal = torch.tensor([float(x) if isinstance(x, numbers.Real) else 0.0 for x in vals],
                        dtype=torch.float32).to(device)
    for i, x in enumerate(vals):
        if isinstance(x, torch.Tensor):
            scal[i] = x.reshape(()).to(device=device, dtype=torch.float32)
    return scal


def _adamw_cuda(p, m, v, g, scal, seed, beta1, beta2, eps, wd, decoupled) -> None:
    from .kernels import build

    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        if not t.is_cuda or t.device != p.device:
            raise ValueError(f"fused AdamW kernel: {name} must be on {p.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused AdamW kernel: {name} must be contiguous")
    for name, t in (("p", p), ("v", v), ("g", g)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"fused AdamW kernel takes float32 or bfloat16 {name}, got {t.dtype}")
    if m.dtype != torch.float32:
        raise TypeError(f"fused AdamW kernel takes a float32 moment1, got {m.dtype}")
    fn = build.function("fused_adamw")
    rc = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), scal.data_ptr(), p.numel(),
            _DTYPE_CODE[p.dtype], _DTYPE_CODE[v.dtype], _DTYPE_CODE[g.dtype], int(seed) & _M32,
            float(beta1), float(1.0 - beta1), float(beta2), float(1.0 - beta2), float(eps),
            float(wd), int(decoupled), torch.cuda.current_stream(p.device).cuda_stream)
    build.check(rc, "fused_adamw")
    LAUNCHES["fused_adamw"] += 1


def fused_adamw_apply(p, m, v, g, *, lr, clip_scale, c1, c2, seed, beta1, beta2, eps, wd,
                      decoupled=True):
    """One-pass AdamW/Adam update over one flat bucket, in place.

    p: [N] flat params (float32 or bfloat16), N a multiple of PAD_ELEMS.
    m: [N] float32 moment1.
    v: [N] moment2, float32, or bfloat16 (stochastically rounded).
    g: [N] grads (float32 or bfloat16; widened to f32 in the stream).
    lr / clip_scale / c1 / c2: scalars (floats, or 0-dim tensors on p's
      device); c1/c2 are the bias corrections 1 - beta^t.
    seed: the uint32 stochastic-rounding seed (unused for an f32 v).
    beta1 / beta2 / eps / wd / decoupled: the bucket's config; wd is the
      resolved decay and decoupled selects AdamW (True) or Adam.

    Returns (p, m, v), the same tensors, updated.
    """
    if p.ndim != 1 or p.shape[0] % PAD_ELEMS:
        raise ValueError(f"flat bucket must be 1-D with length a multiple of {PAD_ELEMS}, "
                         f"got shape {tuple(p.shape)}")
    for name, t in (("m", m), ("v", v), ("g", g)):
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"fused AdamW: {name} {tuple(t.shape)} does not match p {tuple(p.shape)}")
    scal = _scalars(lr, clip_scale, c1, c2, p.device)
    args = (float(beta1), float(beta2), float(eps), float(wd), bool(decoupled))
    if p.is_cuda:
        _adamw_cuda(p, m, v, g, scal, seed, *args)
        return p, m, v
    p2, m2, v2 = _reference_apply(p, m, v, g, scal, seed, *args, v.dtype == torch.bfloat16)
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)
    return p, m, v
