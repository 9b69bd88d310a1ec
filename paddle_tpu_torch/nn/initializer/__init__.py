"""Weight initializers and ParamAttr (counterpart of
paddle_tpu/nn/initializer/__init__.py).

An initializer is a callable (shape, dtype, device) -> tensor that draws
from the framework generator of `device` (framework/random.py), in f32
and then cast to `dtype`, as the JAX package draws f32 and casts. Torch's
generators give other numbers than jax's threefry keys from the same
seed: the distributions match, the values do not. Fans are the JAX
package's: a 2-D shape's are its two sizes, a conv weight [out, in, *k]
has fan_in in * prod(k) and fan_out out * prod(k).

`set_global_initializer(weight, bias)` sets the initializers a parameter
takes when its attr names none, ahead of the layer's default (paddle's
order; the JAX package's raises).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor  # noqa: F401

from ...framework import random as _random


class Initializer:
    def __call__(self, shape, dtype, device) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device):
        return torch.full(tuple(shape), self.value, dtype=dtype, device=device)


class Uniform(Initializer):
    """U(low, high): the default of a conv weight (U(-k, k), k = 1/sqrt(fan_in))."""

    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device):
        x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        return x.uniform_(self.low, self.high, generator=_random.generator(device)).to(dtype)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device):
        x = torch.randn(tuple(shape), generator=_random.generator(device), device=device)
        return (x * self.std + self.mean).to(dtype)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = math.prod(shape[2:])
    return shape[1] * rf, shape[0] * rf


def _uniform(shape, limit, dtype, device):
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return x.uniform_(-limit, limit, generator=_random.generator(device)).to(dtype)


def _normal(shape, std, dtype, device, mean=0.0):
    x = torch.randn(tuple(shape), generator=_random.generator(device), device=device)
    return (x * std + mean).to(dtype)


class TruncatedNormal(Initializer):
    """N(0, 1) truncated to [a, b] (by the inverse CDF of a uniform draw),
    then * std + mean: a and b are in units of std, as the JAX package
    draws jax.random.truncated_normal(a, b)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype, device):
        lo, hi = (0.5 * (1 + math.erf(t / math.sqrt(2))) for t in (self.a, self.b))
        u = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        u = u.uniform_(lo, hi, generator=_random.generator(device))
        z = (math.sqrt(2) * torch.erfinv(2 * u - 1)).clamp(self.a, self.b)
        return (z * self.std + self.mean).to(dtype)


class XavierUniform(Initializer):
    """U(-l, l), l = gain * sqrt(6 / (fan_in + fan_out)). The fans of a 2-D
    shape are its two sizes; `fan_in`/`fan_out` override them."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device):
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return _uniform(shape, limit, dtype, device)


class XavierNormal(Initializer):
    """N(0, gain^2 * 2 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device):
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return _normal(shape, std, dtype, device)


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return math.sqrt(2.0)


class KaimingUniform(Initializer):
    """U(-l, l), l = gain * sqrt(3 / fan_in), gain sqrt(2 / (1 + slope^2))
    for leaky_relu, else sqrt(2) (the JAX package's rule)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="leaky_relu", name=None):
        self.fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype, device):
        fi = self.fan_in or _fans(shape)[0]
        limit = _kaiming_gain(self.nonlinearity, self.negative_slope) * math.sqrt(3.0 / fi)
        return _uniform(shape, limit, dtype, device)


class KaimingNormal(Initializer):
    """N(0, (gain / sqrt(fan_in))^2), KaimingUniform's gain."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="leaky_relu", name=None):
        self.fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype, device):
        fi = self.fan_in or _fans(shape)[0]
        std = _kaiming_gain(self.nonlinearity, self.negative_slope) / math.sqrt(fi)
        return _normal(shape, std, dtype, device)


class Assign(Initializer):
    """The given value (a tensor, array or list), reshaped to the shape."""

    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype, device):
        v = self.value
        t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return t.to(device=device, dtype=dtype).reshape(tuple(shape)).clone()


class Orthogonal(Initializer):
    """gain * Q of the QR of an N(0, 1) [max(r, c), min(r, c)] draw (signs
    fixed by R's diagonal), transposed for a wide shape; r = shape[0], c
    the product of the rest."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype, device):
        rows, cols = shape[0], math.prod(shape[1:])
        flat = torch.randn(max(rows, cols), min(rows, cols), generator=_random.generator(device),
                           device=device)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)).to(dtype)


class Dirac(Initializer):
    """A conv weight [out, in, *k] that passes channel i of each of
    `groups` groups through: 1 at the kernel's centre, 0 elsewhere."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype, device):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                out[(g * (oc // self.groups) + i, i) + centers] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=dtype)


class Bilinear(Initializer):
    """The bilinear-interpolation kernel of a transposed conv that
    upsamples: each [K, K] slice of a [C_out, C_in, K, K] weight is the
    separable triangle filter."""

    def __call__(self, shape, dtype, device):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D conv weight")
        k = shape[-1]
        if shape[-2] != k:
            raise ValueError("Bilinear initializer expects square kernels")
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:k, :k]
        filt = ((1 - np.abs(og[0] / f - c)) * (1 - np.abs(og[1] / f - c))).astype(np.float32)
        w = np.broadcast_to(filt, tuple(shape)).copy()
        return torch.from_numpy(w).to(device=device, dtype=dtype)


calculate_gain_map = {"sigmoid": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0), "linear": 1.0,
                      "conv2d": 1.0, "selu": 3.0 / 4}


def calculate_gain(nonlinearity, param=None):
    """The recommended gain of an activation (1 for one not listed)."""
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    return calculate_gain_map.get(nonlinearity, 1.0)


_global_init = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """Make `weight_init` and `bias_init` the initializers of every
    parameter created after this whose attr names none (ahead of the
    layer's own default); None, None restores the defaults."""
    _global_init["weight"], _global_init["bias"] = weight_init, bias_init


class ParamAttr:
    """paddle.ParamAttr: a parameter's name, initializer, learning-rate
    scale, regularizer, trainable and need_clip
    (paddle_tpu/nn/initializer/__init__.py:174). `create_parameter` puts
    the last four on the parameter, where the optimizer reads them:
    `optimize_attr["learning_rate"]` scales its lr, `regularizer` replaces
    the optimizer's weight decay for it, and `need_clip=False` keeps it
    out of the gradient clip."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0, regularizer=None,
                 trainable=True, need_clip=True, do_model_average=False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def _resolve_attr(attr, is_bias, default_initializer):
    """-> (initializer, trainable, lr scale, regularizer, need_clip);
    initializer None for attr=False (no parameter). The attr's initializer
    wins, then the global one (set_global_initializer), then the default,
    then zeros for a bias and XavierUniform for a weight."""
    if attr is False:
        return None, False, 1.0, None, True
    init, trainable, lr, reg, need_clip = None, True, 1.0, None, True
    if isinstance(attr, ParamAttr):
        init, trainable = attr.initializer, attr.trainable
        lr, reg, need_clip = attr.learning_rate, attr.regularizer, attr.need_clip
    elif isinstance(attr, Initializer):
        init = attr
    elif attr is not None and not isinstance(attr, str):
        raise TypeError(f"attr must be a ParamAttr, an Initializer, a name, False or None; got {attr!r}")
    if init is None:
        init = _global_init["bias" if is_bias else "weight"]
    if init is None:
        init = default_initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierUniform()
    return init, trainable, lr, reg, need_clip


__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal", "XavierUniform",
           "XavierNormal", "KaimingUniform", "KaimingNormal", "Assign", "Orthogonal", "Dirac",
           "Bilinear", "calculate_gain", "calculate_gain_map", "set_global_initializer",
           "ParamAttr"]
