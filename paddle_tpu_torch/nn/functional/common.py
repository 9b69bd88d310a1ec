"""linear, dropout, embedding and interpolate (counterpart of
paddle_tpu/nn/functional/common.py:21-90, 143-228)."""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs
from ...framework import random as _random


def linear(x, weight, bias=None, name=None):
    """x @ weight + bias with paddle's [in, out] weight (the Linear layer
    keeps torch's [out, in] and calls torch's linear itself). Under AMP
    the inputs cast as the white-listed op "linear" (bf16 under O1)."""
    x, weight, bias = amp_cast_inputs("linear", [x, weight, bias])
    return TF.linear(x, weight.t(), bias)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    """upscale_in_train element dropout, the mask drawn from the framework
    generator of x's device: kept values scaled by 1/(1-p), the rest zero.
    The identity in eval and at p == 0."""
    if axis is not None or mode != "upscale_in_train":
        raise NotImplementedError("dropout along an axis, or in another mode, is not ported")
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=_random.generator(x.device), device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of weight [V, H] at the ids x. Where an id equals padding_idx
    the output is zero, whatever that row of weight holds (torch's own
    padding_idx only stops the gradient): the JAX package masks the
    output, and a tied embedding's padding row does move in training."""
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


_ADAPTIVE_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d, 3: TF.adaptive_avg_pool3d}
_LINEAR_BY_RANK = {1: "linear", 2: "bilinear", 3: "trilinear"}


def _resize_axis(x, axis, size, mode):
    """One spatial axis of x resized as jax.image.resize resizes it: an
    antialiased triangle ("bilinear") or Keys a = -0.5 cubic ("bicubic")
    kernel, half-pixel centres, the weights normalized over the input.
    Torch's antialiased 2-d resize is that kernel (its bicubic switches
    to a = -0.5 with antialias), run here on a 1 x L image."""
    if x.shape[axis] == size:
        return x
    moved = x.movedim(axis, -1)
    lead = moved.shape[:-1]
    out = TF.interpolate(moved.reshape(-1, 1, 1, moved.shape[-1]), size=(1, size), mode=mode,
                         align_corners=False, antialias=True)
    return out.reshape(*lead, size).movedim(-1, axis)


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False, align_mode=0,
                data_format="NCHW", name=None):
    """The JAX package's interpolate (jax.image.resize), mode by mode:
    - "nearest": half-pixel centres, torch's "nearest-exact" (torch's
      "nearest" picks floor(i * in / out)); align_corners is ignored, as
      there;
    - "linear"/"bilinear"/"trilinear"/"bicubic" (align_corners False):
      jax.image.resize's separable kernels, antialiased when downscaling
      (_resize_axis); with align_corners=True, linear interpolation on the
      corner-aligned grid (map_coordinates order 1, bicubic included), which
      is torch's align_corners=True linear mode of the rank;
    - "area": the mean over input bins [floor(i * I / O), ceil((i + 1) *
      I / O)), in f32: torch's adaptive average pool.
    The output size is `size`, else int(in * scale_factor) per axis.
    align_mode=1 (paddle's src = dst * scale mapping) raises: the JAX
    package ignores it and computes align_mode 0."""
    channels_first = data_format in ("NCHW", "NCDHW", "NCL")
    if not channels_first:
        x = x.movedim(-1, 1)
    n = x.dim() - 2
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        size = [int(s) for s in (size if isinstance(size, (list, tuple)) else [size])]
    else:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * n
        size = [int(d * s) for d, s in zip(x.shape[2:], scale_factor)]
    if mode not in ("nearest", "linear", "bilinear", "trilinear", "bicubic", "area"):
        raise ValueError(f"unknown interpolate mode {mode!r}")
    if mode == "nearest":
        out = TF.interpolate(x, size=size, mode="nearest-exact")
    elif mode == "area":
        out = _ADAPTIVE_AVG[n](x.float(), size).to(x.dtype)
    elif align_corners:
        out = TF.interpolate(x, size=size, mode=_LINEAR_BY_RANK[n], align_corners=True)
    else:
        if align_mode == 1:
            raise NotImplementedError("interpolate align_mode=1 is not ported (the JAX package "
                                      "ignores it and computes align_mode 0)")
        out = x
        for axis, s in enumerate(size, start=2):
            out = _resize_axis(out, axis, s, "bicubic" if mode == "bicubic" else "bilinear")
    return out if channels_first else out.movedim(1, -1)


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False, align_mode=0,
             data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode, data_format)
