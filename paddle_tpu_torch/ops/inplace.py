"""The `*_` inplace family (counterpart of paddle_tpu/ops/inplace.py).

`op_(x, ...)` computes `op(x, ...)` and makes x hold the result, keeping
x's identity, and returns x. A result of x's shape and dtype is written
into x's storage. One of another dtype or shape (a comparison's bool, a
reshape) is taken by x outside autograd (`x.data = result`), as the JAX
package rebinds x; inside the autograd graph (x or the result requires
grad, grad mode on) that raises, since torch cannot change a tensor's
type in place there. A leaf that requires grad cannot be written in
place under grad mode: torch raises, as paddle does.

As methods, torch's own `*_` methods stay (ops/_patch.py); the
paddle-only ones (`cast_`, `equal_`, `greater_than_`, `scale_`, ...) are
attached from here.
"""
from __future__ import annotations

import math as _pymath

import torch

from ..framework import random as _random
from . import creation, linalg, logic, manipulation, math, search
from ._common import Tensor, scalar

_MODULES = (math, manipulation, logic, search, creation, linalg)


def _become(x: Tensor, out: Tensor) -> Tensor:
    """x takes `out`'s value (see the module docstring); returns x."""
    tracked = torch.is_grad_enabled() and (x.requires_grad or out.requires_grad)
    if out.dtype == x.dtype and out.shape == x.shape:
        if tracked:
            x.copy_(out)
        else:
            with torch.no_grad():
                x.copy_(out)
        return x
    if tracked:
        raise RuntimeError(
            f"an inplace op would change a tensor in the autograd graph from {x.dtype} "
            f"{tuple(x.shape)} to {out.dtype} {tuple(out.shape)}; use the op's out-of-place "
            "form, or run it under no_grad()")
    x.data = out
    return x


def _resolve(name):
    for m in _MODULES:
        fn = getattr(m, name, None)
        if fn is not None:
            return fn
    raise AttributeError(f"inplace generator: no base op `{name}`")


def _make_inplace(name):
    base = _resolve(name)

    def op_(x, *args, **kwargs):
        # in the graph, x's old value may be saved for the base op's
        # backward: compute from a copy, so writing x does not clobber it
        src = x.clone() if torch.is_grad_enabled() and x.requires_grad else x
        return _become(x, base(src, *args, **kwargs))

    op_.__name__ = op_.__qualname__ = name + "_"
    op_.__doc__ = f"Inplace variant of `{name}`: x holds the result; returns x."
    return op_


# every name here has its base op in one of _MODULES; ops whose inplace
# form needs another argument order or has no base (random fills) follow
_MECHANICAL = [
    "abs", "acos", "acosh", "addmm", "asin", "asinh", "atan", "atanh",
    "bitwise_and", "bitwise_left_shift", "bitwise_not", "bitwise_or",
    "bitwise_right_shift", "bitwise_xor",
    "cast", "copysign", "cos", "cosh", "cumprod", "cumsum",
    "digamma", "divide", "equal", "erf", "expm1",
    "flatten", "floor_divide", "floor_mod", "frac",
    "erfinv", "gammainc", "gammaincc", "gammaln", "gcd",
    "greater_equal", "greater_than", "hypot", "i0",
    "index_add", "index_put", "lcm", "ldexp", "lerp", "less_equal", "less_than",
    "lgamma", "log", "log10", "log1p", "log2",
    "logical_and", "logical_not", "logical_or", "logical_xor", "logit",
    "masked_scatter", "mod", "multigammaln", "multiply",
    "nan_to_num", "neg", "not_equal", "polygamma", "pow",
    "put_along_axis", "remainder", "renorm", "sigmoid",
    "sin", "sinh", "square", "tan", "tanh", "tril", "triu", "trunc",
]

_g = globals()
for _name in _MECHANICAL:
    _g[_name + "_"] = _make_inplace(_name)


def t_(x, name=None):
    return _become(x, manipulation.t(x.clone() if x.requires_grad else x))


def transpose_(x, perm, name=None):
    return _become(x, manipulation.transpose(x.clone() if x.requires_grad else x, perm))


def where_(condition, x=None, y=None, name=None):
    """x becomes where(condition, x, y)."""
    src = x.clone() if x.requires_grad else x
    return _become(x, manipulation.where(condition, src, y))


def _fill(x, sample):
    with torch.no_grad():
        x.copy_(sample.to(x.dtype))
    return x


def _uniform01(x, lo=0.0, hi=1.0):
    gen = _random.generator(x.device)
    u = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32)
    return u * (hi - lo) + lo


def normal_(x, mean=0.0, std=1.0, name=None):
    """Fill x with N(mean, std) samples from the framework generator."""
    gen = _random.generator(x.device)
    z = torch.randn(x.shape, generator=gen, device=x.device, dtype=torch.float32)
    return _fill(x, z * std + mean)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    """Fill x with U(min, max) samples (paddle's default range is [-1, 1))."""
    return _fill(x, _uniform01(x, min, max))


def cauchy_(x, loc=0, scale=1, name=None):
    """Fill x with Cauchy(loc, scale) samples by the inverse CDF."""
    u = _uniform01(x, 1e-7, 1.0 - 1e-7)
    return _fill(x, loc + scale * torch.tan(_pymath.pi * (u - 0.5)))


def geometric_(x, probs, name=None):
    """Fill x with Geometric(probs) samples on {1, 2, ...} by the inverse CDF."""
    u = _uniform01(x, 1e-7, 1.0 - 1e-7)
    p = torch.as_tensor(scalar(probs), dtype=torch.float32, device=x.device)
    return _fill(x, torch.ceil(torch.log(u) / torch.log1p(-p)))


def exponential_(x, lam=1.0, name=None):
    """Fill x with Exponential(lam) samples by the inverse CDF."""
    u = _uniform01(x, 1e-7, 1.0 - 1e-7)
    return _fill(x, -torch.log1p(-u) / lam)


__all__ = ([n + "_" for n in _MECHANICAL]
           + ["t_", "transpose_", "where_", "normal_", "uniform_", "cauchy_", "geometric_",
              "exponential_"])


def patch_tensor_inplace():
    """Attach the paddle-only inplace ops as Tensor methods (torch's own
    `*_` methods stay); `x.where_(y, condition)` takes paddle's method order."""
    for n in __all__:
        if hasattr(torch.Tensor, n):
            continue
        fn = _g[n]
        if n == "where_":
            def m(self, y, condition, _fn=fn):
                return _fn(condition, self, y)

            setattr(torch.Tensor, n, m)
        else:
            setattr(torch.Tensor, n, fn)
