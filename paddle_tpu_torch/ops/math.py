"""Elementwise and reduction math ops (counterpart of paddle_tpu/ops/math.py).

Each op runs on its inputs' device; each op the JAX package applies with
autograd casts its inputs under AMP by the same name first (`amp`), and
the checks (isnan, allclose, ...) do not, as there. Dtypes follow the JAX
package under x64: a math function of an int64 tensor is float64, of a
smaller integer float32 (`inexact`); reductions of integers keep jnp's
types.
"""
from __future__ import annotations

import builtins
import itertools

import numpy as np
import torch

from ..framework import dtype as _dtype
from ._common import Tensor, _t, amp, amp1, axes as _axes, binary_promote as _binary_promote
from ._common import inexact, scalar


def _binop(opname, fn, to_inexact=False):
    def op(x, y, name=None):
        x, y = _binary_promote(x, y)
        if to_inexact:
            x, y = inexact(x), inexact(y)
        x, y = amp(opname, x, y)
        return fn(x, y)

    op.__name__ = op.__qualname__ = opname
    return op


def _ldexp(x, y):
    return torch.ldexp(x, y.to(torch.int32))


add = _binop("add", torch.add)
subtract = _binop("subtract", torch.sub)
multiply = _binop("multiply", torch.mul)
divide = _binop("divide", torch.true_divide, to_inexact=True)
floor_divide = _binop("floor_divide", torch.floor_divide)
mod = _binop("mod", torch.remainder)
remainder = mod
floor_mod = mod
pow_op = _binop("pow", torch.pow)
maximum = _binop("maximum", torch.maximum)
minimum = _binop("minimum", torch.minimum)
fmax = _binop("fmax", torch.fmax)
fmin = _binop("fmin", torch.fmin)
atan2 = _binop("atan2", torch.atan2, to_inexact=True)
heaviside = _binop("heaviside", torch.heaviside)
copysign = _binop("copysign", torch.copysign, to_inexact=True)
hypot = _binop("hypot", torch.hypot, to_inexact=True)
nextafter = _binop("nextafter", torch.nextafter, to_inexact=True)
ldexp = _binop("ldexp", _ldexp)
logaddexp = _binop("logaddexp", torch.logaddexp, to_inexact=True)
gcd = _binop("gcd", torch.gcd)
lcm = _binop("lcm", torch.lcm)


def pow(x, y, name=None):  # noqa: A001 - paddle API name
    return pow_op(x, y)


def divide_no_nan(x, y):
    x, y = _binary_promote(x, y)
    x, y = amp("divide_no_nan", x, y)
    zero = y == 0
    return torch.where(zero, torch.zeros((), dtype=x.dtype, device=x.device),
                       x / torch.where(zero, torch.ones_like(y), y))


def _unop(opname, fn, to_inexact=True):
    def op(x, name=None):
        x = _t(x)
        return fn(amp1(opname, inexact(x) if to_inexact else x))

    op.__name__ = op.__qualname__ = opname
    return op


def _imag(v):
    return torch.imag(v) if v.is_complex() else torch.zeros_like(v)


def _real(v):
    return torch.real(v) if v.is_complex() else v


exp = _unop("exp", torch.exp)
expm1 = _unop("expm1", torch.expm1)
log = _unop("log", torch.log)
log2 = _unop("log2", torch.log2)
log10 = _unop("log10", torch.log10)
log1p = _unop("log1p", torch.log1p)
sqrt = _unop("sqrt", torch.sqrt)
rsqrt = _unop("rsqrt", torch.rsqrt)
abs = _unop("abs", torch.abs, to_inexact=False)  # noqa: A001
absolute = abs
neg = _unop("neg", torch.neg, to_inexact=False)
negative = neg
sign = _unop("sign", torch.sgn, to_inexact=False)
sgn = sign
sin = _unop("sin", torch.sin)
cos = _unop("cos", torch.cos)
tan = _unop("tan", torch.tan)
asin = _unop("asin", torch.asin)
acos = _unop("acos", torch.acos)
atan = _unop("atan", torch.atan)
arcsin, arccos, arctan = asin, acos, atan
sinh = _unop("sinh", torch.sinh)
cosh = _unop("cosh", torch.cosh)
tanh = _unop("tanh", torch.tanh)
asinh = _unop("asinh", torch.asinh)
acosh = _unop("acosh", torch.acosh)
atanh = _unop("atanh", torch.atanh)
floor = _unop("floor", torch.floor, to_inexact=False)
ceil = _unop("ceil", torch.ceil, to_inexact=False)
trunc = _unop("trunc", torch.trunc, to_inexact=False)
frac = _unop("frac", lambda v: v - torch.trunc(v), to_inexact=False)
reciprocal = _unop("reciprocal", torch.reciprocal)
square = _unop("square", torch.square, to_inexact=False)
erf = _unop("erf", torch.special.erf)
erfinv = _unop("erfinv", torch.special.erfinv)
lgamma = _unop("lgamma", torch.lgamma)
digamma = _unop("digamma", torch.special.digamma)
i0 = _unop("i0", torch.special.i0)
i0e = _unop("i0e", torch.special.i0e)
i1 = _unop("i1", torch.special.i1)
i1e = _unop("i1e", torch.special.i1e)
deg2rad = _unop("deg2rad", torch.deg2rad)
rad2deg = _unop("rad2deg", torch.rad2deg)
angle = _unop("angle", torch.angle)
conj = _unop("conj", torch.conj_physical, to_inexact=False)
real = _unop("real", _real, to_inexact=False)
imag = _unop("imag", _imag, to_inexact=False)
sigmoid = _unop("sigmoid", torch.sigmoid)


def polygamma_impl(n, x):
    """jax.scipy.special.polygamma's argument order: (n, x)."""
    return torch.special.polygamma(int(n), inexact(_t(x)))


def polygamma(x, n):
    return torch.special.polygamma(int(n), amp1("polygamma", inexact(_t(x))))


def round(x, decimals=0, name=None):  # noqa: A001
    x = amp1("round", _t(x))
    return torch.round(x, decimals=decimals) if decimals else torch.round(x)


def rint(x):
    return torch.round(amp1("rint", _t(x)))


def logit(x, eps=None):
    return torch.logit(amp1("logit", inexact(_t(x))), eps)


def clip(x, min=None, max=None, name=None):  # noqa: A001
    x = amp1("clip", _t(x))
    return torch.clamp(x, scalar(min), scalar(max))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    x = amp1("scale", _t(x))
    s = scale.detach().to(x.dtype) if isinstance(scale, Tensor) else \
        torch.tensor(scale, dtype=x.dtype, device=x.device)
    b = _dtype.round_to(bias, x.dtype) if x.is_floating_point() else bias
    out = x * s + b if bias_after_scale else (x + b) * s
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def increment(x, value=1.0):
    from .inplace import _become

    return _become(x, add(x, value))


def stanh(x, scale_a=0.67, scale_b=1.7159):
    x = amp1("stanh", inexact(_t(x)))
    return scale_b * torch.tanh(scale_a * x)


def multiplex(inputs, index):
    stacked = torch.stack([_t(i) for i in inputs], 0)
    idx = _t(index).reshape(-1)
    return stacked[idx, torch.arange(stacked.shape[1], device=stacked.device)].detach()


def addmm(input, x, y, beta=1.0, alpha=1.0):
    i, a, b = amp("addmm", _t(input), _t(x), _t(y))
    return beta * i + alpha * (a @ b)


def inner(x, y):
    return torch.inner(*amp("inner", *_binary_promote(x, y)))


def outer(x, y):
    a, b = amp("outer", *_binary_promote(x, y))
    return torch.outer(a.reshape(-1), b.reshape(-1))


def dot(x, y):
    a, b = amp("dot", *_binary_promote(x, y))
    return torch.sum(a * b) if a.ndim == 1 else torch.sum(a * b, -1)


def kron(x, y):
    return torch.kron(*amp("kron", *_binary_promote(x, y)))


def cross(x, y, axis=9):
    a, b = amp("cross", *_binary_promote(x, y))
    ax = next(i for i, s in enumerate(a.shape) if s == 3) if axis == 9 else axis
    return torch.linalg.cross(a, b, dim=ax)


def trace(x, offset=0, axis1=0, axis2=1):
    x = amp1("trace", _t(x))
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def lerp(x, y, weight):
    a, b = _binary_promote(x, y)
    if isinstance(weight, Tensor):
        a, b, w = amp("lerp", a, b, weight)
        return a + w * (b - a)
    a, b = amp("lerp", a, b)
    return a + weight * (b - a)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(amp1("nan_to_num", _t(x)), nan=nan, posinf=posinf, neginf=neginf)


# ---- reductions ----

def _keep_all(out, v, keepdim):
    """A full reduction's result with keepdim: every axis kept as 1."""
    return out.reshape((1,) * v.ndim) if keepdim else out


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    v = amp1("sum", _t(x))
    d = _dtype.convert_dtype(dtype) if dtype is not None else None
    if d is None and v.dtype == torch.bool:
        d = torch.int64
    ax = _axes(axis)
    if ax is None:
        return _keep_all(torch.sum(v, dtype=d), v, keepdim)
    return torch.sum(v, dim=ax, keepdim=keepdim, dtype=d)


def mean(x, axis=None, keepdim=False, name=None):
    v = inexact(amp1("mean", _t(x)))
    ax = _axes(axis)
    if ax is None:
        return _keep_all(torch.mean(v), v, keepdim)
    return torch.mean(v, dim=ax, keepdim=keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    v = amp1("prod", _t(x))
    d = _dtype.convert_dtype(dtype) if dtype is not None else None
    if d is None and not (v.is_floating_point() or v.is_complex()):
        d = torch.int64
    ax = _axes(axis)
    if ax is None:
        return _keep_all(torch.prod(v, dtype=d), v, keepdim)
    if isinstance(ax, tuple):
        out = v.to(d) if d is not None else v
        for a in sorted((a % v.ndim for a in ax), reverse=True):
            out = torch.prod(out, a, keepdim=keepdim)
        return out
    return torch.prod(v, ax, keepdim=keepdim, dtype=d)


def _extreme(name, fn):
    def op(x, axis=None, keepdim=False, name=None):
        v = amp1(name, _t(x))
        ax = _axes(axis)
        if ax is None:
            return _keep_all(fn(v), v, keepdim)
        return fn(v, dim=ax, keepdim=keepdim)

    op.__name__ = op.__qualname__ = name
    return op


max = _extreme("max", torch.amax)  # noqa: A001
min = _extreme("min", torch.amin)  # noqa: A001


def amax(x, axis=None, keepdim=False):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False):
    return min(x, axis, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False):
    v = amp1("nansum", _t(x))
    d = _dtype.convert_dtype(dtype) if dtype is not None else None
    if d is None and not (v.is_floating_point() or v.is_complex()):
        d = torch.int64
    ax = _axes(axis)
    if ax is None:
        return _keep_all(torch.nansum(v, dtype=d), v, keepdim)
    return torch.nansum(v, dim=ax, keepdim=keepdim, dtype=d)


def nanmean(x, axis=None, keepdim=False):
    v = inexact(amp1("nanmean", _t(x)))
    ax = _axes(axis)
    if ax is None:
        return _keep_all(torch.nanmean(v), v, keepdim)
    return torch.nanmean(v, dim=ax, keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False):
    v = _t(x)
    ax = _axes(axis)
    out = torch.count_nonzero(v, dim=ax)
    if keepdim:
        dims = range(v.ndim) if ax is None else ([ax] if isinstance(ax, int) else ax)
        for a in sorted(d % v.ndim for d in dims):
            out = out.unsqueeze(a)
    return out


def logsumexp(x, axis=None, keepdim=False):
    v = inexact(amp1("logsumexp", _t(x)))
    ax = _axes(axis)
    if ax is None:
        ax = tuple(range(v.ndim))
    return torch.logsumexp(v, dim=ax, keepdim=keepdim)


def _scan_dtype(v, dtype):
    if dtype is not None:
        return _dtype.convert_dtype(dtype)
    if v.dtype == torch.bool:
        return torch.int64
    return v.dtype  # jnp's cumsum/cumprod keep an integer type


def cumsum(x, axis=None, dtype=None, name=None):
    v = amp1("cumsum", _t(x))
    d = _scan_dtype(v, dtype)
    if axis is None:
        return torch.cumsum(v.reshape(-1), 0, dtype=d)
    return torch.cumsum(v, int(_axes(axis)), dtype=d)


def cumprod(x, dim=None, dtype=None, name=None):
    v = amp1("cumprod", _t(x))
    d = _scan_dtype(v, dtype)
    if dim is None:
        return torch.cumprod(v.reshape(-1), 0, dtype=d)
    return torch.cumprod(v, dim, dtype=d)


def cummax(x, axis=None, dtype="int64"):
    v = amp1("cummax_vals", _t(x))
    vv, ax = (v.reshape(-1), 0) if axis is None else (v, axis)
    vals, idx = torch.cummax(vv, ax)
    return vals, idx.to(_dtype.convert_dtype(dtype))


def cummin(x, axis=None, dtype="int64"):
    neg_vals, idx = cummax(neg(_t(x)), axis=axis, dtype=dtype)
    return neg(neg_vals), idx


def logcumsumexp(x, axis=None):
    v = inexact(amp1("logcumsumexp", _t(x)))
    if axis is None:
        return torch.logcumsumexp(v.reshape(-1), 0)
    return torch.logcumsumexp(v, axis)


def diff(x, n=1, axis=-1, prepend=None, append=None):
    v = amp1("diff", _t(x))
    p = _t(prepend, v.device).to(v.dtype) if prepend is not None else None
    a = _t(append, v.device).to(v.dtype) if append is not None else None
    return torch.diff(v, n=n, dim=axis, prepend=p, append=a)


# ---- checks (non-differentiable) ----

def isnan(x):
    return torch.isnan(_t(x))


def isinf(x):
    return torch.isinf(_t(x))


def isfinite(x):
    return torch.isfinite(_t(x))


def isneginf(x):
    return torch.isneginf(_t(x))


def isposinf(x):
    return torch.isposinf(_t(x))


def isreal(x):
    return torch.isreal(_t(x))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _binary_promote(x, y)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor (torch.allclose returns a Python bool)."""
    return isclose(x, y, rtol, atol, equal_nan).all()


def equal_all(x, y):
    a, b = _t(x), _t(y)
    if a.shape != b.shape:
        return torch.tensor(False, device=a.device)
    a, b = _binary_promote(a, b)
    return (a == b).all()


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    v = _t(x)
    ax = _axes(axis)
    return _keep_all(torch.any(v), v, keepdim) if ax is None else torch.any(v, dim=ax,
                                                                            keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    v = _t(x)
    ax = _axes(axis)
    return _keep_all(torch.all(v), v, keepdim) if ax is None else torch.all(v, dim=ax,
                                                                            keepdim=keepdim)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def _moments(name, fn):
    def op(x, axis=None, unbiased=True, keepdim=False, name=None):
        v = inexact(amp1(name, _t(x)))
        ax = _axes(axis)
        out = fn(v, dim=ax, correction=1 if unbiased else 0, keepdim=keepdim)
        return out

    op.__name__ = op.__qualname__ = name
    return op


std = _moments("std", torch.std)
var = _moments("var", torch.var)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        yv, xv = amp("trapezoid", _t(y), _t(x))
        return torch.trapezoid(yv, xv, dim=axis)
    return torch.trapezoid(amp1("trapezoid", _t(y)), dx=dx if dx is not None else 1.0, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        yv, xv = amp("cumulative_trapezoid", _t(y), _t(x))
        return torch.cumulative_trapezoid(yv, xv, dim=axis)
    return torch.cumulative_trapezoid(amp1("cumulative_trapezoid", _t(y)),
                                      dx=dx if dx is not None else 1.0, dim=axis)


def renorm(x, p, axis, max_norm, name=None):
    """Clamp the p-norm of each slice along `axis` to max_norm (the JAX
    package's formula: sanitized before the power, so a zero slice has a
    finite gradient)."""
    v = amp1("renorm", _t(x))
    moved = torch.movedim(v, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    sumsq = torch.sum(torch.abs(flat) ** p, 1)
    norms = torch.where(sumsq > 0, torch.clamp(sumsq, min=1e-24) ** (1.0 / p),
                        torch.zeros_like(sumsq))
    s = torch.where(norms > max_norm, max_norm / torch.clamp(norms, min=1e-12),
                    torch.ones_like(norms))
    return torch.movedim((flat * s[:, None]).reshape(moved.shape), 0, axis)


def vander(x, n=None, increasing=False, name=None):
    """Columns x^(n-1) .. x^0 (x^0 .. x^(n-1) when increasing): powers of
    an integer exponent (torch.vander's backward writes a saved tensor)."""
    v = amp1("vander", _t(x))
    cols = v.shape[0] if n is None else n
    p = torch.arange(cols, device=v.device)
    return v.unsqueeze(-1) ** (p if increasing else p.flip(0))


def tensordot(x, y, axes=2, name=None):
    ax = axes
    if isinstance(ax, (list, tuple)):
        ax = [list(a) if isinstance(a, (list, tuple)) else [a] for a in ax]
    a, b = amp("tensordot", _t(x), _t(y))
    return torch.tensordot(a, b, dims=ax)


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    vals = amp("add_n", *[_t(i) for i in inputs])
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out


def gammaln(x, name=None):
    return torch.lgamma(amp1("gammaln", inexact(_t(x))))


def gammainc(x, y, name=None):
    a, b = amp("gammainc", inexact(_t(x)), inexact(_t(y)))
    return torch.special.gammainc(a, b)


def gammaincc(x, y, name=None):
    a, b = amp("gammaincc", inexact(_t(x)), inexact(_t(y)))
    return torch.special.gammaincc(a, b)


def multigammaln(x, p, name=None):
    return torch.special.multigammaln(amp1("multigammaln", inexact(_t(x))), p)


def frexp(x, name=None):
    m, e = torch.frexp(amp1("frexp", _t(x)))
    return m, e.to(m.dtype)


def signbit(x, name=None):
    return torch.signbit(_t(x))


def combinations(x, r=2, with_replacement=False, name=None):
    v = amp1("combinations", _t(x))
    picker = itertools.combinations_with_replacement if with_replacement else itertools.combinations
    idx = np.asarray(list(picker(builtins.range(v.shape[0]), r)), dtype=np.int64).reshape(-1, r)
    return v[torch.from_numpy(idx).to(v.device)]


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and getattr(_v, "__module__", None) == __name__
           and callable(_v)]

# each public op is one recorded op of a static capture (core/record.py)
from ..core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
