"""rms_norm (counterpart of paddle_tpu/nn/functional/norm.py:111)."""
from __future__ import annotations

import torch

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
