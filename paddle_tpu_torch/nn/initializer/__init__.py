"""Weight initializers and ParamAttr (counterpart of
paddle_tpu/nn/initializer/__init__.py:34, 43, 76, 174).

An initializer is a callable (shape, dtype, device) -> tensor that draws
from the framework generator of `device` (framework/random.py), in f32
and then cast to `dtype`, as the JAX package draws f32 and casts. Torch's
generators give other numbers than jax's threefry keys from the same
seed: the distributions match, the values do not.
"""
from __future__ import annotations

import math

import torch

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


class XavierUniform(Initializer):
    """U(-l, l), l = sqrt(6 / (fan_in + fan_out)). The fans of a 2-D shape
    are its two sizes, so the limit is the same for paddle's [in, out] and
    torch's [out, in] Linear weight; a 1-D shape's are its size twice."""

    def __call__(self, shape, dtype, device):
        shape = tuple(shape)
        if len(shape) not in (1, 2):
            raise NotImplementedError("XavierUniform: only 1-D and 2-D shapes are ported")
        limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
        x = torch.empty(shape, dtype=torch.float32, device=device)
        return x.uniform_(-limit, limit, generator=_random.generator(device)).to(dtype)


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
    wins, then the default, then zeros for a bias and XavierUniform for a
    weight."""
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
        init = default_initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierUniform()
    return init, trainable, lr, reg, need_clip


__all__ = ["Initializer", "Constant", "Uniform", "Normal", "XavierUniform", "ParamAttr"]
