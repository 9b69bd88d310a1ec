"""Fused ops (counterpart of paddle_tpu/incubate/nn/functional/__init__.py):
`fused_linear_cross_entropy`, the LM-head loss, and `fused_rms_norm` with
its hand-written kernel (TPU kernel B6).
"""
from __future__ import annotations

from typing import Optional

import torch

from ....amp import amp_cast_inputs
from ....ops.attention import _DTYPE_CODE, direct_launch
from ....ops.launches import LAUNCHES

# ---------------------------------------------------------------------------
# fused linear + softmax cross-entropy (paddle_tpu/.../functional/__init__.py:367-460)
# ---------------------------------------------------------------------------


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """The JAX package's custom_vjp `_flce`. Forward: logits z = h.W (+b)
    in h's dtype (bf16 under AMP), f32 logsumexp, the label logit as an
    f32 row dot against the label's weight row. Backward: dz =
    (softmax(z) - onehot(label)) * g/n_valid from the saved z as one chain,
    rounded to z's dtype; dh = dz.W; dW = dz^T.h accumulated in f32 and
    cast to W's dtype. The products are plain torch.matmul: the JAX
    package computes them outside any Pallas kernel."""

    @staticmethod
    def forward(ctx, h, W, b, labels, ignore_index, transpose_weight):
        cdt = h.dtype
        Wc = W.to(cdt)
        z = h @ Wc.t() if transpose_weight else h @ Wc  # [N, V]
        if b is not None:
            z = z + b.to(cdt)
        m = z.max(dim=-1).values.float()
        lse = m + torch.log(torch.exp(z.float() - m[:, None]).sum(dim=-1))
        valid = labels != ignore_index
        lab = torch.where(valid, labels, torch.zeros_like(labels))
        W_lab = (W[lab] if transpose_weight else W[:, lab].t()).float()
        ll = (h.float() * W_lab).sum(dim=-1)
        if b is not None:
            ll = ll + b.float()[lab]
        n_valid = valid.sum().clamp_min(1)
        loss = torch.where(valid, lse - ll, 0.0).sum() / n_valid
        ctx.save_for_backward(h, W, b, z, lse, lab, valid, n_valid)
        ctx.transpose_weight = transpose_weight
        return loss

    @staticmethod
    def backward(ctx, g):
        h, W, b, z, lse, lab, valid, n_valid = ctx.saved_tensors
        cdt = z.dtype
        scale = (g / n_valid.float()) * valid.float()  # [N]
        dz = torch.exp(z.float() - lse[:, None]) * scale[:, None]
        rows = torch.arange(z.shape[0], device=z.device)
        dz[rows, lab] -= scale  # the one-hot term: p*scale - 1*scale, in f32
        dz = dz.to(cdt)
        Wc = W.to(cdt)
        if ctx.transpose_weight:
            dh = (dz @ Wc).to(h.dtype)
            dW = _matmul_f32_acc(dz.t(), h, W.dtype)
        else:
            dh = (dz @ Wc.t()).to(h.dtype)
            dW = _matmul_f32_acc(h.t(), dz, W.dtype)
        db = dz.float().sum(dim=0).to(b.dtype) if b is not None else None
        return dh, dW, db, None, None, None


def _matmul_f32_acc(a, b, out_dtype):
    """a @ b with f32 accumulation, cast to out_dtype (the JAX package's
    dot(preferred_element_type=f32).astype). Same-dtype bf16 inputs into a
    bf16 result go through torch's bf16 matmul, which accumulates in f32
    and rounds once; anything else multiplies in f32."""
    if a.dtype == b.dtype == out_dtype == torch.bfloat16:
        return a @ b
    return (a.float() @ b.float()).to(out_dtype)


def fused_linear_cross_entropy(x, weight, labels, bias=None, ignore_index=-100,
                               transpose_weight=False):
    """Mean softmax cross-entropy of x @ weight (+ bias) against int labels,
    without f32 [N, V] logits kept for the backward.

    x: [N, H] (or [..., H]; leading dims are flattened)
    weight: [H, V] (a Linear's), or [V, H] with transpose_weight=True (a
      tied embedding's)
    labels: int [N] (or [...]); entries equal to ignore_index are masked
    Under AMP the float inputs cast as the white-listed op (bf16 under O1).
    Returns the f32 scalar loss.
    """
    x, weight, bias = amp_cast_inputs("fused_linear_cross_entropy", [x, weight, bias])
    hdim = x.shape[-1]
    return _FusedLinearCrossEntropy.apply(x.reshape(-1, hdim), weight, bias, labels.reshape(-1),
                                          int(ignore_index), bool(transpose_weight))


# ---------------------------------------------------------------------------
# B6: fused_rms_norm (paddle_tpu/.../functional/__init__.py:36-124)
# ---------------------------------------------------------------------------

def _rms_norm_ref(x, w, b, eps):
    """Plain version of the RMSNorm kernel: f32 throughout, cast to x's
    type at the end."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps)
    out = out * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def _rms_norm_cuda(x, w, b, eps):
    """The hand-written kernel (ops/kernels/rms_norm.cu) over rows of a
    contiguous [R, D] x."""
    from ....ops.kernels import build

    r, d = x.shape
    if d % 8:
        raise ValueError(f"rms_norm kernel: D must be a multiple of 8, got D={d}")
    for name, t in (("x", x), ("weight", w), ("bias", b)):
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"rms_norm kernel: {name} must be on {x.device}, got {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"rms_norm kernel takes float32 or bfloat16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rms_norm kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"rms_norm kernel: {name} must start 16-byte aligned")
    if w.shape != (d,) or (b is not None and (b.shape != (d,) or b.dtype != w.dtype)):
        raise ValueError("rms_norm kernel: weight and bias must be [D] of one dtype")
    out = torch.empty_like(x)
    rc = build.function("rms_norm")(x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None
                                    else None, out.data_ptr(), _DTYPE_CODE[x.dtype],
                                    _DTYPE_CODE[w.dtype], r, d, float(eps),
                                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "rms_norm")
    LAUNCHES["rms_norm"] += 1
    return out


# B6's forward as a registered op, `torch.ops.paddle_tpu_torch.rms_norm_fwd`,
# so an exported fused_rms_norm keeps its kernel (as ops/attention.py's
# flash_fwd): the kernel on CUDA or a raise, the plain version on the CPU,
# a fake that gives the shape only.
@torch.library.custom_op("paddle_tpu_torch::rms_norm_fwd", mutates_args=(), device_types="cuda")
def _rms_norm_fwd_op(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     eps: float) -> torch.Tensor:
    return _rms_norm_cuda(x, w, b, eps)


@_rms_norm_fwd_op.register_kernel("cpu")
def _rms_norm_fwd_op_cpu(x, w, b, eps):
    return _rms_norm_ref(x, w, b, eps)


@_rms_norm_fwd_op.register_fake
def _rms_norm_fwd_op_fake(x, w, b, eps):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _rms_norm_fwd(x, w, b, eps):
    """B6's forward: the kernel directly for an eager call on the card,
    else the registered op (ops.attention.direct_launch)."""
    if direct_launch(x, w, b):
        return _rms_norm_cuda(x, w, b, eps)
    return _rms_norm_fwd_op(x, w, b, eps)


class _FusedRMSNorm(torch.autograd.Function):
    """Kernel forward, backward recomputed through the plain version (the
    JAX package's custom_vjp, :45-63)."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        return _rms_norm_fwd(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True) if t is not None else None for t in (x, w, b)]
        with torch.enable_grad():
            out = _rms_norm_ref(*inputs, ctx.eps)
            need = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad(out, need, g))
        return tuple(next(grads) if t is not None else None for t in inputs) + (None,)


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6, begin_norm_axis=-1):
    """RMSNorm over the last axis, through the hand-written kernel for a
    CUDA tensor (D a multiple of 8) and the plain version for a CPU one.
    `nn.RMSNorm` does not come here: it runs the plain `nn.functional.
    rms_norm`, as in the JAX package."""
    x, norm_weight, norm_bias = amp_cast_inputs("fused_rms_norm", [x, norm_weight, norm_bias])
    if begin_norm_axis not in (-1, x.ndim - 1):
        raise NotImplementedError("fused_rms_norm normalizes the last axis")
    d = x.shape[-1]
    args = (x.reshape(-1, d).contiguous(), norm_weight, norm_bias, float(epsilon))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args[:3]):
        out = _FusedRMSNorm.apply(*args)
    else:
        out = _rms_norm_fwd(*args)
    return out.reshape(x.shape)


__all__ = ["fused_linear_cross_entropy", "fused_rms_norm"]

# each public op is one recorded op of a static capture (core/record.py)
from ....core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
