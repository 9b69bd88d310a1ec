"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py:41-220):
max_pool1d/2d/3d, avg_pool1d/2d/3d and adaptive_avg_pool1d/2d/3d.

The JAX package pools with `lax.reduce_window` over explicitly padded
windows; here the pads are computed as it computes them and the input is
padded before a torch pool with no padding of its own:
- `ceil_mode` extends the high pad until the windows tile the padded
  extent (pooling.py:49-60). Torch's ceil_mode drops a last window that
  would start in the right padding, so the output sizes can differ.
- max pools pad with -inf;
- avg pools sum over zero-padded windows, then divide by
  `divisor_override`, by the count of in-bounds cells (`exclusive`, the
  default) or by the window's size.
Adaptive bins are [floor(j*in/out), ceil((j+1)*in/out)), torch's own rule.
None of these is on an AMP list: each runs in its input's dtype.
`return_mask`, adaptive max, lp, unpool and fractional pooling are not
ported yet and raise.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as TF

from .conv import _CHANNELS_FIRST, _padding, pad_spatial, string_pads

_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_ADAPTIVE_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d, 3: TF.adaptive_avg_pool3d}


def _tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    if len(v) == 1:
        return tuple(v) * n
    return tuple(v)


def _windows(x, kernel_size, stride, padding, n, ceil_mode):
    """(channels-first x, kernel, stride, (lo, hi) pads) as the JAX package
    pads the windows."""
    kernel = _tuple(kernel_size, n)
    stride = _tuple(stride if stride is not None else kernel, n)
    pads = _padding(padding, n)
    sizes = x.shape[2:]
    if isinstance(pads, str):
        pads = string_pads(pads, sizes, kernel, stride, (1,) * n)
    elif ceil_mode:
        ext = []
        for size, k, s, (lo, hi) in zip(sizes, kernel, stride, pads):
            rem = (size + lo + hi - k) % s
            ext.append((lo, hi + (0 if rem == 0 else s - rem)))
        pads = ext
    return kernel, stride, pads


def _channels_first(x, data_format):
    return x if data_format in _CHANNELS_FIRST else x.movedim(-1, 1)


def _restore(out, data_format):
    return out if data_format in _CHANNELS_FIRST else out.movedim(1, -1)


def _max_pool(x, kernel_size, stride, padding, n, data_format, return_mask, ceil_mode):
    if return_mask:
        raise NotImplementedError("max pooling with return_mask is not ported yet")
    x = _channels_first(x, data_format)
    kernel, stride, pads = _windows(x, kernel_size, stride, padding, n, ceil_mode)
    out = _MAX_POOL[n](pad_spatial(x, pads, value=-math.inf), kernel, stride)
    return _restore(out, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, 1, data_format, return_mask, ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, return_mask=False,
               data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 2, data_format, return_mask, ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, return_mask=False,
               data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 3, data_format, return_mask, ceil_mode)


def _sum_pool(x, kernel, stride):
    """Window sums of a channels-first x (no padding)."""
    if x.dim() == 3:  # 1-d: torch's avg_pool1d has no divisor_override
        return TF.avg_pool2d(x[:, :, None], (1,) + kernel, (1,) + stride,
                             divisor_override=1)[:, :, 0]
    if x.dim() == 4:
        return TF.avg_pool2d(x, kernel, stride, divisor_override=1)
    # torch's CPU avg_pool3d has no 16-bit kernel; its CUDA one sums in f32 too
    return TF.avg_pool3d(x.float(), kernel, stride, divisor_override=1).to(x.dtype)


def _avg_pool(x, kernel_size, stride, padding, n, data_format, exclusive, divisor_override,
              ceil_mode):
    x = _channels_first(x, data_format)
    kernel, stride, pads = _windows(x, kernel_size, stride, padding, n, ceil_mode)
    s = _sum_pool(pad_spatial(x, pads), kernel, stride)
    if divisor_override:
        out = s / divisor_override
    elif exclusive:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        out = s / _sum_pool(pad_spatial(ones, pads), kernel, stride)
    else:
        out = s / float(math.prod(kernel))
    return _restore(out, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False, name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1, "NCL", exclusive, None, ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 2, data_format, exclusive, divisor_override,
                     ceil_mode)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 3, data_format, exclusive, divisor_override,
                     ceil_mode)


def _adaptive_avg_pool(x, output_size, n, data_format):
    if data_format not in _CHANNELS_FIRST:
        raise NotImplementedError("adaptive pooling pools the axes after N and C: channels-first only")
    sizes = _tuple(output_size, n)
    sizes = tuple(x.shape[2 + i] if sizes[i] is None else int(sizes[i]) for i in range(n))
    return _ADAPTIVE_AVG[n](x, sizes)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_avg_pool(x, output_size, 1, "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_avg_pool(x, output_size, 2, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_avg_pool(x, output_size, 3, data_format)


def _not_ported(*args, **kwargs):
    raise NotImplementedError("adaptive max, lp, unpool and fractional pooling are not ported yet")


adaptive_max_pool1d = adaptive_max_pool2d = adaptive_max_pool3d = _not_ported
lp_pool2d = _not_ported
max_unpool1d = max_unpool2d = max_unpool3d = _not_ported
fractional_max_pool2d = fractional_max_pool3d = _not_ported
