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

A max pool's `return_mask` gives, per output, the flat index of its
maximum over the input's own (unpadded) spatial extent, which
max_unpool1d/2d/3d scatter back. The adaptive max pools give theirs too
(the JAX package drops `return_mask` there). lp_pool2d sums |x|^p over
the zero-padded windows. Fractional max pooling takes the JAX package's
window arithmetic (paddle's FractionalStartIndex/EndIndex) with one
`random_u` for all axes, drawn from the framework generator when none is
given.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as TF

from ...framework import random as _random
from .conv import _CHANNELS_FIRST, _padding, pad_spatial, string_pads

_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_ADAPTIVE_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d, 3: TF.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d, 3: TF.adaptive_max_pool3d}


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


def _unpadded_index(idx, padded_sizes, sizes, pads):
    """Flat indices into the padded spatial extent -> into the unpadded one."""
    coords, rem = [], idx
    for size_p in reversed(padded_sizes):
        coords.append(rem % size_p)
        rem = rem // size_p
    flat = torch.zeros_like(idx)
    for c, size, (lo, _) in zip(reversed(coords), sizes, pads):
        flat = flat * size + (c - lo)
    return flat


def _max_pool(x, kernel_size, stride, padding, n, data_format, return_mask, ceil_mode):
    x = _channels_first(x, data_format)
    kernel, stride, pads = _windows(x, kernel_size, stride, padding, n, ceil_mode)
    xp = pad_spatial(x, pads, value=-math.inf)
    if not return_mask:
        return _restore(_MAX_POOL[n](xp, kernel, stride), data_format)
    out, idx = _MAX_POOL[n](xp, kernel, stride, return_indices=True)
    if xp is not x:
        idx = _unpadded_index(idx, xp.shape[2:], x.shape[2:], pads)
    return _restore(out, data_format), _restore(idx, data_format)


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


def _adaptive_max_pool(x, output_size, n, return_mask):
    sizes = _tuple(output_size, n)
    sizes = tuple(x.shape[2 + i] if sizes[i] is None else int(sizes[i]) for i in range(n))
    return _ADAPTIVE_MAX[n](x, sizes, return_indices=return_mask)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, 1, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, 2, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, 3, return_mask)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0, ceil_mode=False,
              data_format="NCHW", name=None):
    """(sum of |x|^p over each window) ** (1 / p); ceil_mode is ignored, as
    in the JAX package."""
    p = float(norm_type)
    x = _channels_first(x, data_format)
    kernel, stride, pads = _windows(x, kernel_size, stride, padding, 2, False)
    out = _sum_pool(pad_spatial(x.abs() ** p, pads), kernel, stride) ** (1.0 / p)
    return _restore(out, data_format)


def _max_unpool(x, indices, kernel_size, stride, padding, n, output_size):
    """Zeros of the unpooled size, each value put at its flat spatial index."""
    kernel = _tuple(kernel_size, n)
    stride = _tuple(stride if stride is not None else kernel_size, n)
    pad = _tuple(padding, n)
    if output_size is not None:
        out_sizes = tuple(int(s) for s in list(output_size)[-n:])
    else:
        out_sizes = tuple((x.shape[2 + i] - 1) * stride[i] - 2 * pad[i] + kernel[i]
                          for i in range(n))
    N, C = x.shape[:2]
    flat = torch.zeros(N, C, math.prod(out_sizes), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, indices.reshape(N, C, -1).long(), x.reshape(N, C, -1))
    return flat.reshape(N, C, *out_sizes)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 1, output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 2, output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0, data_format="NCDHW",
                 output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 3, output_size)


def _fractional_axis_windows(in_s, out_s, u, pool):
    """One axis' window starts, widest width and ends (paddle's
    FractionalStartIndex/EndIndex; a fixed `pool` width when given)."""
    alpha = in_s / out_s
    if pool and pool > 0:
        ur = u
    else:
        base = in_s // out_s
        ur = u * min((base + 2) / alpha - 1, (in_s + 1 - base) / alpha - (out_s - 1))
    starts = np.array([int((i + ur) * alpha) - int(ur * alpha) for i in range(out_s)])
    if pool and pool > 0:
        ends = starts + pool
    else:
        ends = np.array([int((i + 1 + ur) * alpha) - int(ur * alpha) for i in range(out_s)])
    ends = np.minimum(ends, in_s)
    return starts, int((ends - starts).max()), ends


def _fractional_max_pool(x, output_size, kernel_size, random_u, return_mask, n):
    spatial_in = x.shape[2:]
    out_sz = output_size if isinstance(output_size, (list, tuple)) else [output_size] * n
    out_sz = tuple(int(spatial_in[i]) if out_sz[i] is None else int(out_sz[i]) for i in range(n))
    pools = _tuple(kernel_size, n) if kernel_size is not None else (0,) * n
    if random_u is None:
        u = torch.rand((), generator=_random.generator("cpu")).item()
    else:
        u = float(random_u)
    if not 0 < u < 1:
        raise ValueError(f"fractional pool random_u must be in (0, 1), got {u}")
    axes = [_fractional_axis_windows(int(spatial_in[i]), out_sz[i], u, pools[i])
            for i in range(n)]
    # the window grid: each spatial axis i becomes (out_i, width_i), slots
    # past a window's end set to -inf
    g = x
    for i, (starts, width, ends) in enumerate(axes):
        ax = 2 + 2 * i
        pos = starts[:, None] + np.arange(width)[None, :]
        idx = torch.from_numpy(np.minimum(pos, int(spatial_in[i]) - 1).reshape(-1)).to(x.device)
        g = g.index_select(ax, idx)
        g = g.reshape(*g.shape[:ax], out_sz[i], width, *g.shape[ax + 1:])
        shape = [1] * g.dim()
        shape[ax], shape[ax + 1] = out_sz[i], width
        valid = torch.from_numpy(pos < ends[:, None]).to(x.device).reshape(shape)
        g = torch.where(valid, g, torch.full((), -math.inf, dtype=g.dtype, device=g.device))
    win = [3 + 2 * i for i in range(n)]
    out = g.amax(dim=win)
    if not return_mask:
        return out
    perm = [a for a in range(g.dim()) if a not in win] + win
    widths = [a[1] for a in axes]
    am = g.permute(perm).reshape(*out.shape, math.prod(widths)).argmax(dim=-1)
    offs, rem = [], am
    for w_ in reversed(widths):
        offs.append(rem % w_)
        rem = rem // w_
    offs.reverse()
    strides_in = np.cumprod((list(spatial_in[1:]) + [1])[::-1])[::-1]
    total = torch.zeros_like(am)
    for i in range(n):
        shape = [1] * am.dim()
        shape[2 + i] = out_sz[i]
        start = torch.from_numpy(axes[i][0]).to(x.device).reshape(shape)
        total = total + (start + offs[i]) * int(strides_in[i])
    return out, total


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None, return_mask=False,
                          name=None):
    return _fractional_max_pool(x, output_size, kernel_size, random_u, return_mask, 2)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None, return_mask=False,
                          name=None):
    return _fractional_max_pool(x, output_size, kernel_size, random_u, return_mask, 3)

# each public op is one recorded op of a static capture (core/record.py)
from ...core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
