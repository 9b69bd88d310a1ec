"""batch_norm, rms_norm and layer_norm (counterpart of
paddle_tpu/nn/functional/norm.py:21-130)."""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs
from ...framework import dtype as _dtype


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) in f32, cast back to x's type, then
    scaled by `weight` in x's type: the JAX package's cast order. Under
    AMP the inputs cast as the black-listed op "rms_norm" (float32 under
    O1)."""
    x, weight = amp_cast_inputs("rms_norm", [x, weight])
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5, name=None):
    """(x - mean) * rsqrt(var + eps) over the trailing `normalized_shape`,
    the statistics in f32, cast back to x's type, then `* weight` and
    `+ bias` in x's type: the JAX package's cast order. Under AMP the
    inputs cast as the black-listed op "layer_norm" (float32 under O1).
    For f32 x and f32 (or no) weight and bias every step is f32, and
    torch's fused layer_norm computes the same value in one kernel."""
    x, weight, bias = amp_cast_inputs("layer_norm", [x, weight, bias])
    shape = (normalized_shape,) if isinstance(normalized_shape, int) else tuple(normalized_shape)
    if all(t is None or t.dtype == torch.float32 for t in (x, weight, bias)):
        return TF.layer_norm(x, shape, weight, bias, epsilon)
    out = TF.layer_norm(x.float(), shape, eps=epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def _bn_stats(x, axes):
    """Biased batch mean and variance in x's type, as jnp.mean/jnp.var give
    them: reduced in f32 for a 16-bit x, then rounded back. Not on an AMP
    list, so under O1 a bf16 conv output gives bf16 statistics."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    var, mean = torch.var_mean(xf, dim=axes, correction=0)
    return mean.to(x.dtype), var.to(x.dtype)


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every axis but the channel's (axis 1 for NC...
    formats, the last otherwise). In training (unless use_global_stats)
    it normalizes with the batch statistics, which the gradient flows
    through, and updates the buffers in place, paddle's way:
    running = momentum * running + (1 - momentum) * batch, with the
    biased batch variance (torch's F.batch_norm weighs the new value by
    its momentum and uses the unbiased one). Otherwise it normalizes with
    the buffers and leaves them unchanged. The normalization is the
    black-listed op "batch_norm": under AMP every input is cast to f32
    first, so the output is f32."""
    ch = 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1
    if training and not use_global_stats:
        mean, var = _bn_stats(x, [i for i in range(x.dim()) if i != ch])
        with torch.no_grad():
            # (1 - momentum) multiplies in the statistics' type, as a weak
            # Python float does in the JAX package
            keep = _dtype.round_to(1 - momentum, mean.dtype)
            running_mean.copy_(running_mean * momentum + mean * keep)
            running_var.copy_(running_var * momentum + var * keep)
    else:
        mean, var = running_mean, running_var
    x, mean, var, weight, bias = amp_cast_inputs("batch_norm", [x, mean, var, weight, bias])
    shape = [1] * x.dim()
    shape[ch] = -1
    out = (x - mean.reshape(shape).to(x.dtype)) * torch.rsqrt(var.reshape(shape).to(x.dtype) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape).to(x.dtype)
    if bias is not None:
        out = out + bias.reshape(shape).to(x.dtype)
    return out
