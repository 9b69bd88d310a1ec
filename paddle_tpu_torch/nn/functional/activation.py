"""Activations (counterpart of paddle_tpu/nn/functional/activation.py).

Each is the JAX package's formula in torch ops, under the same op name
for AMP: "softmax" and "log_softmax" are black-listed (f32 under O1),
the others run in their input's dtype under O1 and in the low dtype under
O2. The `*_` forms make x hold the result and return x (ops/inplace.py's
rule).
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...framework import dtype as _dtype
from ...framework import random as _random
from ...ops._common import _t, amp1
from ...ops.inplace import _become


def _inplace(fn):
    def op_(x, *args, **kwargs):
        # x's old value may be saved for the op's backward: compute from a copy
        src = x.clone() if torch.is_grad_enabled() and x.requires_grad else x
        return _become(x, fn(src, *args, **kwargs))

    op_.__name__ = op_.__qualname__ = fn.__name__ + "_"
    op_.__doc__ = f"Inplace `{fn.__name__}`: x holds the result; returns x."
    return op_


def _zero(v):
    return torch.zeros((), dtype=v.dtype, device=v.device)


def _clip(v, lo, hi):
    """jnp.clip's form, max then min: at a bound the gradient splits in
    half, as jax's maximum/minimum split it (torch.clamp passes it whole)."""
    lo_t = torch.full((), lo, dtype=v.dtype, device=v.device)
    hi_t = torch.full((), hi, dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, lo_t), hi_t)


def relu(x, name=None):
    return TF.relu(amp1("relu", _t(x)))


def relu6(x, name=None):
    return TF.relu6(amp1("relu6", _t(x)))


def sigmoid(x, name=None):
    return torch.sigmoid(amp1("sigmoid", _t(x)))


def tanh(x, name=None):
    return torch.tanh(amp1("tanh", _t(x)))


def gelu(x, approximate=False, name=None):
    """Exact erf GELU by default (jax.nn.gelu(approximate=False)); the
    tanh form with approximate=True."""
    return TF.gelu(amp1("gelu", _t(x)), approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return TF.silu(amp1("silu", _t(x)))


swish = silu


def mish(x, name=None):
    v = amp1("mish", _t(x))
    return v * torch.tanh(TF.softplus(v))


def leaky_relu(x, negative_slope=0.01, name=None):
    v = amp1("leaky_relu", _t(x))
    return torch.where(v >= 0, v, negative_slope * v)


def elu(x, alpha=1.0, name=None):
    v = amp1("elu", _t(x))
    return torch.where(v > 0, v, alpha * torch.expm1(v))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    v = amp1("selu", _t(x))
    return scale * torch.where(v > 0, v, alpha * torch.expm1(v))


def celu(x, alpha=1.0, name=None):
    return TF.celu(amp1("celu", _t(x)), alpha)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return _clip(amp1("hardtanh", _t(x)), min, max)


def hardshrink(x, threshold=0.5, name=None):
    v = amp1("hardshrink", _t(x))
    return torch.where(v.abs() > threshold, v, _zero(v))


def softshrink(x, threshold=0.5, name=None):
    v = amp1("softshrink", _t(x))
    return torch.where(v > threshold, v - threshold,
                       torch.where(v < -threshold, v + threshold, _zero(v)))


def tanhshrink(x, name=None):
    v = amp1("tanhshrink", _t(x))
    return v - torch.tanh(v)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """clip(x * slope + offset, 0, 1), paddle's default slope 0.1666667
    (not 1/6)."""
    return _clip(amp1("hardsigmoid", _t(x)) * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    v = amp1("hardswish", _t(x))
    return v * _clip(v + 3.0, 0.0, 6.0) / 6.0


def softplus(x, beta=1.0, threshold=20.0, name=None):
    v = amp1("softplus", _t(x))
    return torch.where(v * beta > threshold, v, torch.logaddexp(v * beta, _zero(v)) / beta)


def softsign(x, name=None):
    v = amp1("softsign", _t(x))
    return v / (1 + v.abs())


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    v = amp1("thresholded_relu", _t(x))
    return torch.where(v > threshold, v, torch.full((), value, dtype=v.dtype, device=v.device))


def log_sigmoid(x, name=None):
    return TF.logsigmoid(amp1("log_sigmoid", _t(x)))


def maxout(x, groups, axis=1, name=None):
    """The max over `groups` consecutive channel groups along `axis`: C
    channels become C / groups."""
    v = amp1("maxout", _t(x))
    ax = axis % v.dim()
    c = v.shape[ax]
    return v.reshape(*v.shape[:ax], groups, c // groups, *v.shape[ax + 1:]).amax(dim=ax)


def softmax(x, axis=-1, dtype=None, name=None):
    """x cast to `dtype` first when one is given; the black-listed op
    "softmax" (f32 under AMP O1)."""
    x = _t(x)
    if dtype is not None:
        x = x.to(_dtype.convert_dtype(dtype))
    return torch.softmax(amp1("softmax", x), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """x cast to `dtype` first when one is given; the black-listed op
    "log_softmax" (f32 under AMP O1)."""
    x = _t(x)
    if dtype is not None:
        x = x.to(_dtype.convert_dtype(dtype))
    return torch.log_softmax(amp1("log_softmax", x), dim=axis)


def glu(x, axis=-1, name=None):
    """a * sigmoid(b), a and b the halves of x along `axis`."""
    return TF.glu(amp1("glu", _t(x)), dim=axis)


def prelu(x, weight, data_format="NCHW", name=None):
    """x where x >= 0, else weight * x: one weight, or one per channel (axis
    1 for NC... formats, the last otherwise)."""
    v, w = _t(x), _t(weight)
    if w.numel() == 1:
        a = w.reshape(())
    else:
        shape = [1] * v.dim()
        shape[1 if data_format == "NCHW" else v.dim() - 1] = w.numel()
        a = w.reshape(shape)
    return torch.where(v >= 0, v, a * v)


def rrelu(x, lower=0.125, upper=0.3333333, training=True, name=None):
    """In training each negative element takes its own slope from
    U(lower, upper), drawn in f32 from the framework generator; in eval the
    mean slope (lower + upper) / 2."""
    v = _t(x)
    if training:
        a = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        a = a.uniform_(lower, upper, generator=_random.generator(v.device)).to(v.dtype)
        return torch.where(v >= 0, v, a * v)
    return torch.where(v >= 0, v, (lower + upper) / 2.0 * v)


relu_ = _inplace(relu)
elu_ = _inplace(elu)
softmax_ = _inplace(softmax)
tanh_ = _inplace(tanh)
hardtanh_ = _inplace(hardtanh)
leaky_relu_ = _inplace(leaky_relu)
thresholded_relu_ = _inplace(thresholded_relu)

__all__ = ["relu", "relu6", "sigmoid", "tanh", "gelu", "silu", "swish", "mish", "leaky_relu",
           "elu", "selu", "celu", "hardtanh", "hardshrink", "softshrink", "tanhshrink",
           "hardsigmoid", "hardswish", "softplus", "softsign", "thresholded_relu", "log_sigmoid",
           "maxout", "softmax", "log_softmax", "glu", "prelu", "rrelu", "relu_", "elu_",
           "softmax_", "tanh_", "hardtanh_", "leaky_relu_", "thresholded_relu_"]

# each public op is one recorded op of a static capture (core/record.py)
from ...core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
