"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py
and search_ops_addendum.py): linear, the dropouts, embedding, one_hot,
label_smooth, pad, interpolate, the pixel and channel shuffles,
unfold/fold, the distances and normalize, bilinear, grid_sample and
affine_grid, sequence_mask, temporal_shift, gumbel_softmax and
gather_tree.

Random masks are drawn from the framework generator of the input's
device: the distributions are the JAX package's, the values are not
(C-trap3).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs
from ...framework import dtype as _dtype
from ...framework import random as _random
from ...ops._common import _t, amp1, int_list


def linear(x, weight, bias=None, name=None):
    """x @ weight + bias with paddle's [in, out] weight, the Linear layer's
    own. Under AMP the inputs cast as the white-listed op "linear" (bf16
    under O1)."""
    x, weight, bias = amp_cast_inputs("linear", [x, weight, bias])
    return TF.linear(x, weight.t(), bias)


def _keep(shape, p, device):
    """A bool mask, True with probability 1 - p, from the framework generator
    (under an export trace drawn for real: the artifact keeps the mask)."""
    with _random.drawn_for_real():
        return torch.rand(shape, generator=_random.generator(device), device=device) < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    """Dropout with a mask over x's shape, or, with `axis`, over those axes
    only (broadcast along the others). "upscale_in_train" scales the kept
    values by 1/(1-p) in training and is the identity in eval;
    "downscale_in_infer" keeps them as they are in training and scales x by
    1-p in eval. The identity in training at p == 0."""
    if not training:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if p == 0.0:
        return x
    shape = x.shape
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = _keep(shape, p, x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: the mask is over N and C."""
    return dropout(x, p=p, axis=[0, 1] if data_format == "NCHW" else [0, 3], training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p=p, axis=[0, 1] if data_format == "NCDHW" else [0, 4], training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: dropped values take SELU's negative saturation, then
    an affine map keeps the mean and variance."""
    x = _t(x)
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1.0 - p + p * alpha_p ** 2 * (1.0 - p)) ** -0.5
    b = -a * alpha_p * p
    keep = _keep(x.shape, p, x.device)
    return a * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype, device=x.device)) + b


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


def one_hot(x, num_classes, name=None):
    """f32 [..., num_classes]; an id outside [0, num_classes) gives a row of
    zeros, as jax.nn.one_hot."""
    x = _t(x)
    return (x.unsqueeze(-1) == torch.arange(num_classes, device=x.device)).float()


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) * label + epsilon * prior_dist (uniform 1/K when none)."""
    label = amp1("label_smooth", _t(label))
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * _t(prior_dist)
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


def _pad_index(n, lo, hi, mode, device):
    """Source indices of the padded extent [-lo, n + hi) of one axis:
    reflect without repeating the edge, replicate the edge, or wrap."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    period = 2 * (n - 1) if n > 1 else 1
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):  # noqa: A002
    """paddle's pad: 2 * ndim widths are (before, after) pairs per axis in
    axis order; fewer apply to the spatial axes of `data_format`, the first
    pair to the last spatial axis. Modes "constant" (with `value`),
    "reflect", "replicate" and "circular"."""
    x = amp1("pad", _t(x))
    pad = int_list(pad)
    nd = x.dim()
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        width = [(0, 0)] * nd
        spatial = list(range(2, nd)) if data_format.startswith("NC") else list(range(1, nd - 1))
        for i, d in enumerate(reversed(spatial)):
            if 2 * i + 1 < len(pad):
                width[d] = (pad[2 * i], pad[2 * i + 1])
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    if mode == "constant":
        return TF.pad(x, [p for lo, hi in reversed(width) for p in (lo, hi)], value=value)
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode, x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0, data_format=data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """[N, C*r*r, H, W] -> [N, C, H*r, W*r]; NHWC splits the channels as
    [r, r, C] (the JAX package's order)."""
    x, r = _t(x), upscale_factor
    if data_format == "NCHW":
        return TF.pixel_shuffle(x, r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """[N, C, H*r, W*r] -> [N, C*r*r, H, W]. NCHW only, as in the JAX package."""
    if data_format != "NCHW":
        raise NotImplementedError("pixel_unshuffle: NCHW only")
    return TF.pixel_unshuffle(_t(x), downscale_factor)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    x = _t(x)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4).reshape(n, h, w, c)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads4(paddings):
    """(top, left, bottom, right) from an int, [h, w] or [top, left, bottom, right]."""
    if isinstance(paddings, int):
        return (paddings,) * 4
    if len(paddings) == 2:
        return paddings[0], paddings[1], paddings[0], paddings[1]
    return tuple(paddings)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: NCHW -> [N, C*kh*kw, L], channels major, then the kernel's
    rows and columns."""
    x = _t(x)
    t, l, b, r = _pads4(paddings)
    x = TF.pad(x, (l, r, t, b))
    return TF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations), stride=_pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """col2im, unfold's adjoint: overlapping patches summed."""
    x = _t(x)
    oh, ow = _pair(output_sizes)
    t, l, b, r = _pads4(paddings)
    out = TF.fold(x, (oh + t + b, ow + l + r), _pair(kernel_sizes), dilation=_pair(dilations),
                  stride=_pair(strides))
    return out[:, :, t:t + oh, l:l + ow]


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    a, b = _t(x1), _t(x2)
    dot = (a * b).sum(dim=axis)
    na = (a * a).sum(dim=axis).sqrt()
    nb = (b * b).sum(dim=axis).sqrt()
    return dot / torch.clamp_min(na * nb, eps)


def normalize(x, p=2.0, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p, epsilon) along `axis`."""
    v = amp1("normalize", _t(x))
    n = (v.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return v / torch.clamp_min(n, epsilon)


def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] W[o] x2[b] (+ bias[o]), W [out, in1, in2]."""
    out = torch.einsum("bi,oij,bj->bo", _t(x1), _t(weight), _t(x2))
    return out if bias is None else out + _t(bias)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) in f32, g Gumbel noise from U[1e-10, 1)
    of the framework generator; `hard` gives the one-hot of its argmax in
    the forward and the soft gradient (straight through). In x's dtype."""
    x = _t(x)
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    u = u.uniform_(1e-10, 1.0, generator=_random.generator(x.device))
    y = torch.softmax((x.float() - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(axis, y.argmax(dim=axis, keepdim=True), 1.0)
        y = y + (onehot - y).detach()
    return y.to(x.dtype)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen] with mask[..., j] = j < x[...]; maxlen defaults to
    max(x) (read on the host)."""
    x = _t(x)
    m = int(x.max().item()) if maxlen is None else int(maxlen)
    mask = torch.arange(m, device=x.device) < x.unsqueeze(-1)
    return mask.to(_dtype.convert_dtype(dtype))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW", name=None):
    """TSM: of each segment's C channels, the first C * ratio take the next
    frame's values, the next C * ratio the previous frame's (zeros past the
    ends), the rest stay."""
    v = _t(x)
    if data_format == "NHWC":
        v = v.permute(0, 3, 1, 2)
    nt, c, h, w = v.shape
    v5 = v.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    fwd = TF.pad(v5[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    bwd = TF.pad(v5[:, :-1, c1:c2], (0, 0, 0, 0, 0, 0, 1, 0))
    out = torch.cat([fwd, bwd, v5[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def _reflect(coord, size, align_corners):
    if align_corners:
        # about the edge centres, 0 and size - 1
        span = 2 * (size - 1) if size > 1 else 1
        r = torch.remainder(coord, span).abs()
        return torch.where(r > size - 1, span - r, r)
    # about the edge borders, -0.5 and size - 0.5
    span = 2 * size
    r = torch.remainder(coord + 0.5, span).abs()
    r = torch.where(r > size, span - r, r) - 0.5
    return r.clamp(0, size - 1)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True, name=None):
    """NCHW x sampled at grid [N, Hg, Wg, 2] of (x, y) in [-1, 1]:
    "bilinear" or "nearest" (round half to even), padding "zeros",
    "border" or "reflection" (the JAX package's formulas)."""
    v, g = _t(x), _t(grid)
    n, c, h, w = v.shape
    gx, gy = g[..., 0], g[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    batch = torch.arange(n, device=v.device).reshape(n, 1, 1)

    def tap(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        if padding_mode == "reflection":
            yy, xx = _reflect(yy, h, align_corners), _reflect(xx, w, align_corners)
        yi = yy.long().clamp(0, h - 1)
        xi = xx.long().clamp(0, w - 1)
        s = v[batch, :, yi, xi].permute(0, 3, 1, 2)  # [n, c, hg, wg]
        if padding_mode == "zeros":
            s = s * valid.unsqueeze(1).to(v.dtype)
        return s

    if mode == "nearest":
        return tap(torch.round(fy), torch.round(fx))
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0).unsqueeze(1), (fy - y0).unsqueeze(1)
    return (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x0 + 1) * (1 - wy) * wx
            + tap(y0 + 1, x0) * wy * (1 - wx) + tap(y0 + 1, x0 + 1) * wy * wx)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """[N, H, W, 2] sampling grid of the affine maps theta [N, 2, 3]. The
    base grid is float64, as the JAX package's (x64) linspace makes it, so
    the grid is float64 too."""
    t = _t(theta)
    _, _, h, w = [int(d) for d in int_list(out_shape)]
    f64 = dict(dtype=torch.float64, device=t.device)
    if align_corners:
        ys, xs = torch.linspace(-1, 1, h, **f64), torch.linspace(-1, 1, w, **f64)
    else:
        ys = (torch.arange(h, **f64) * 2 + 1) / h - 1
        xs = (torch.arange(w, **f64) * 2 + 1) / w - 1
    t = t.to(torch.promote_types(t.dtype, torch.float64))
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    return torch.einsum("nij,pj->npi", t, base).reshape(t.shape[0], h, w, 2)


def pdist(x, p=2.0, name=None):
    """The condensed [N(N-1)/2] p-norm distances between x's rows (i < j)."""
    v = _t(x)
    i, j = np.triu_indices(v.shape[0], k=1)
    diff = v[torch.from_numpy(i).to(v.device)] - v[torch.from_numpy(j).to(v.device)]
    if p == 2.0:
        return (diff * diff).sum(dim=-1).sqrt()
    if p == float("inf"):
        return diff.abs().amax(dim=-1)
    if p == 0.0:
        return (diff != 0).to(v.dtype).sum(dim=-1)
    return (diff.abs() ** p).sum(dim=-1) ** (1.0 / p)


def gather_tree(ids, parents):
    """Beam search's backtrace: ids and parents [T, B, beam] (the step's
    token and the beam it extends) -> the full path of each final beam,
    walked from the last step back (a host loop over T)."""
    ids, parents = _t(ids), _t(parents)
    out = torch.empty_like(ids)
    beam = torch.arange(ids.shape[2], device=ids.device).expand(ids.shape[1], -1)
    for t in range(ids.shape[0] - 1, -1, -1):
        out[t] = ids[t].gather(1, beam)
        beam = parents[t].gather(1, beam)
    return out

# each public op is one recorded op of a static capture (core/record.py)
from ...core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
