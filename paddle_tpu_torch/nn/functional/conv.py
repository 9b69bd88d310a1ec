"""conv1d/2d/3d (counterpart of paddle_tpu/nn/functional/conv.py:42-92).

The JAX package calls `lax.conv_general_dilated`; here the conv is torch's
(cuDNN on the card) after the padding is brought to one (lo, hi) pair per
spatial dim as the JAX package reads it: an int, one int per dim, 2n
ints [lo0, hi0, lo1, hi1, ...], the full-rank pairs
[[0, 0], [0, 0], [lo, hi], ...] (the last n are read), or "SAME"/"VALID"
with XLA's rule (SAME pads total // 2 low and the rest high, also at
stride > 1, where torch's padding="same" refuses). Asymmetric pads go
through F.pad first. The JAX package takes a 2-d full-rank list (four
pairs, 2n entries) for the 2n form and fails; here the 2n form needs
ints, so the full-rank form works at every rank. Under AMP the inputs
cast as the white-listed op (bf16 under O1); the weight is cast to the
input's type inside the op and a bias is added after the conv, in the
types the JAX package adds it. The transposed convs are not ported yet
and raise.
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs

_CHANNELS_FIRST = (None, "NCL", "NCHW", "NCDHW")
_TORCH_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}


def _tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _padding(padding, n):
    """paddle padding spec -> "SAME"/"VALID" or a (lo, hi) pair per spatial dim."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding[-n:]]
    raise ValueError(f"bad padding {padding}")


def string_pads(mode, sizes, window, stride, dilation):
    """XLA's (lo, hi) pads for "SAME" or "VALID" (lax.padtype_to_pads)."""
    if mode == "VALID":
        return [(0, 0)] * len(sizes)
    if mode != "SAME":
        raise ValueError(f"padding must be SAME or VALID, got {mode!r}")
    pads = []
    for size, k, s, d in zip(sizes, window, stride, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_spatial(x, pads, value=0.0):
    """F.pad of the trailing len(pads) dims of a channels-first x."""
    if not any(lo or hi for lo, hi in pads):
        return x
    return TF.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)], value=value)


def _conv(x, weight, bias, stride, padding, dilation, groups, n, data_format):
    stride, dilation = _tuple(stride, n), _tuple(dilation, n)
    x, weight, bias = amp_cast_inputs(f"conv{n}d", [x, weight, bias])
    channels_first = data_format in _CHANNELS_FIRST
    if not channels_first:
        x = x.movedim(-1, 1)
    pads = _padding(padding, n)
    if isinstance(pads, str):
        pads = string_pads(pads, x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        torch_pad = [lo for lo, _ in pads]
    else:
        x, torch_pad = pad_spatial(x, pads), 0
    out = _TORCH_CONV[n](x, weight.to(x.dtype), None, stride, torch_pad, dilation, groups)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out if channels_first else out.movedim(1, -1)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCL",
           name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCHW",
           name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCDHW",
           name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3, data_format)


_TORCH_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d, 3: TF.conv_transpose3d}


def _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups, n,
                    data_format, output_size):
    stride, dilation = _tuple(stride, n), _tuple(dilation, n)
    pads = _padding(padding, n)
    if isinstance(pads, str):
        raise NotImplementedError("SAME/VALID string padding for conv_transpose")
    x, weight, bias = amp_cast_inputs(f"conv{n}d_transpose", [x, weight, bias])
    channels_first = data_format in _CHANNELS_FIRST
    if not channels_first:
        x = x.movedim(-1, 1)
    k_eff = [d * (k - 1) + 1 for d, k in zip(dilation, weight.shape[2:])]
    base = [(i - 1) * s - lo - hi + k for i, s, (lo, hi), k in zip(x.shape[2:], stride, pads, k_eff)]
    if output_size is not None:
        sizes = _tuple(output_size, n) if isinstance(output_size, int) else tuple(output_size)
        opad = tuple(int(o) - b for o, b in zip(sizes, base))
    else:
        opad = _tuple(output_padding, n)
    if any(not 0 <= op < s for op, s in zip(opad, stride)):
        raise ValueError(f"output_padding {opad} (output_size {output_size}) outside [0, stride "
                         f"{stride}): the forward conv of that output is not x's size")
    w = weight.to(x.dtype)
    if all(lo == hi for lo, hi in pads):
        out = _TORCH_CONV_T[n](x, w, None, stride, [lo for lo, _ in pads], opad, groups, dilation)
    else:
        out = _TORCH_CONV_T[n](x, w, None, stride, 0, 0, groups, dilation)
        out = TF.pad(out, [p for (lo, hi), op in zip(reversed(pads), reversed(opad))
                           for p in (-lo, op - hi)])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out if channels_first else out.movedim(1, -1)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups, 1,
                           data_format, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups, 2,
                           data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups, 3,
                           data_format, output_size)

# each public op is one recorded op of a static capture (core/record.py)
from ...core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
