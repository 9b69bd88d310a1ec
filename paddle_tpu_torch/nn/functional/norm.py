"""rms_norm and layer_norm (counterpart of
paddle_tpu/nn/functional/norm.py:81-130)."""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs


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
