"""Tensor creation (counterpart of paddle_tpu/ops/creation.py).

New tensors go to the framework device (`set_device`; `cuda:0` unless
the caller asked for the CPU); a `*_like` op, and an op of a tensor, to
that tensor's device. Default dtypes are the JAX package's under x64:
`to_tensor([1, 2])` and `arange(5)` are int64, `full` takes int64 for an
int and bool for a bool, `randint` defaults to int64.

The random ops draw from the framework's seeded generators
(framework/random.py), one per device: `paddle.seed(s)` makes them
reproducible. They cannot give jax.random's bits; each draws from the
same distribution as the JAX package's op.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import record as _record
from ..framework import device as _device
from ..framework import dtype as _dtype
from ..framework import random as _random
from ..framework.io import numpy_to_tensor
from ._common import Tensor, _t, amp, amp1, int_list as _shape_list, scalar as _scalar


def _dt(dtype, default=None):
    return default if dtype is None else _dtype.convert_dtype(dtype)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> torch.Tensor:
    """A new tensor on `place` (default: the framework device) holding a
    copy of `data` (a tensor, numpy array, list or scalar). Without a
    dtype, float64 data takes the default float type, as in paddle;
    other types keep theirs. stop_gradient=False makes it a leaf that
    requires grad. Under a static capture it is a constant of the
    program, made unrecorded, as the JAX package makes it outside `apply`."""
    dev = _device.resolve(place)
    with _record.suspended():
        if isinstance(data, torch.Tensor):
            t = data.detach().to(dev, copy=True)
        else:
            t = numpy_to_tensor(np.asarray(data)).to(dev)
            if dtype is None and t.dtype == torch.float64:
                t = t.to(_dtype.get_default_dtype())
        if dtype is not None:
            t = t.to(_dtype.convert_dtype(dtype))
    return t.requires_grad_(not stop_gradient)


def _dev():
    return _device.current_device()


def zeros(shape, dtype=None) -> Tensor:
    return torch.zeros(_shape_list(shape), dtype=_dt(dtype, _dtype.get_default_dtype()),
                       device=_dev())


def ones(shape, dtype=None) -> Tensor:
    return torch.ones(_shape_list(shape), dtype=_dt(dtype, _dtype.get_default_dtype()),
                      device=_dev())


def full(shape, fill_value, dtype=None) -> Tensor:
    fill_value = _scalar(fill_value)
    if dtype is None:
        if isinstance(fill_value, (bool, np.bool_)):
            dtype = torch.bool
        elif isinstance(fill_value, (int, np.integer)):
            dtype = torch.int64
        else:
            dtype = _dtype.get_default_dtype()
    return torch.full(_shape_list(shape), fill_value, dtype=_dt(dtype), device=_dev())


def empty(shape, dtype=None) -> Tensor:
    """Zeros, as the JAX package's (a defined value, not uninitialized memory)."""
    return zeros(shape, dtype)


def zeros_like(x, dtype=None) -> Tensor:
    x = _t(x)
    return torch.zeros(x.shape, dtype=_dt(dtype, x.dtype), device=x.device)


def ones_like(x, dtype=None) -> Tensor:
    x = _t(x)
    return torch.ones(x.shape, dtype=_dt(dtype, x.dtype), device=x.device)


def full_like(x, fill_value, dtype=None) -> Tensor:
    x = _t(x)
    return torch.full(x.shape, _scalar(fill_value), dtype=_dt(dtype, x.dtype), device=x.device)


def empty_like(x, dtype=None) -> Tensor:
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None) -> Tensor:
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer)) for v in (start, end, step))
        dtype = torch.int64 if ints else _dtype.get_default_dtype()
    return torch.arange(start, end, step, dtype=_dt(dtype), device=_dev())


def linspace(start, stop, num, dtype=None) -> Tensor:
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dt(dtype, _dtype.get_default_dtype()), device=_dev())


def logspace(start, stop, num, base=10.0, dtype=None) -> Tensor:
    return torch.logspace(_scalar(start), _scalar(stop), int(num), base=base,
                          dtype=_dt(dtype, _dtype.get_default_dtype()), device=_dev())


def eye(num_rows, num_columns=None, dtype=None) -> Tensor:
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype, _dtype.get_default_dtype()), device=_dev())


def diag(x, offset=0, padding_value=0) -> Tensor:
    v = amp1("diag", _t(x))
    if v.ndim == 1:
        out = torch.diag(v, offset)
        if padding_value != 0:
            keep = torch.zeros(out.shape, dtype=torch.bool, device=v.device)
            keep.diagonal(offset).fill_(True)
            out = torch.where(keep, out, torch.tensor(padding_value, dtype=out.dtype,
                                                      device=v.device))
        return out
    return torch.diagonal(v, offset)


def diagflat(x, offset=0) -> Tensor:
    return torch.diagflat(amp1("diagflat", _t(x)), offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1) -> Tensor:
    return torch.diag_embed(amp1("diag_embed", _t(x)), offset, dim1, dim2)


def diagonal(x, offset=0, axis1=0, axis2=1) -> Tensor:
    return torch.diagonal(amp1("diagonal", _t(x)), offset, axis1, axis2)


def tril(x, diagonal=0) -> Tensor:
    return torch.tril(amp1("tril", _t(x)), diagonal)


def triu(x, diagonal=0) -> Tensor:
    return torch.triu(amp1("triu", _t(x)), diagonal)


def tril_indices(row, col, offset=0, dtype="int64"):
    return torch.tril_indices(row, col, offset, dtype=_dt(dtype), device=_dev())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return torch.triu_indices(row, row if col is None else col, offset, dtype=_dt(dtype),
                              device=_dev())


def meshgrid(*args):
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) else args
    return list(torch.meshgrid(*[_t(t) for t in ts], indexing="ij"))


def assign(x, output=None) -> Tensor:
    """A copy of x outside autograd; with `output`, written into it."""
    out = _t(x).detach().clone() if isinstance(x, Tensor) else to_tensor(x)
    if output is not None:
        return output.set_value(out)
    return out


def clone(x) -> Tensor:
    return amp1("clone", _t(x)).clone()


def complex(real, imag) -> Tensor:  # noqa: A001
    r, i = amp("complex", _t(real), _t(imag))
    return torch.complex(r, i)


def polar(abs_t, angle) -> Tensor:
    a, th = amp("polar", _t(abs_t), _t(angle))
    return torch.complex(a * torch.cos(th), a * torch.sin(th))


def clone_detached(x) -> Tensor:
    return _t(x).detach().clone()


# ---- random creation (python/paddle/tensor/random.py) ----

def _gen(device=None):
    return _random.generator(device if device is not None else _dev())


def rand(shape, dtype=None) -> Tensor:
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0) -> Tensor:  # noqa: A002
    gen = _gen()
    u = torch.rand(_shape_list(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (u * (max - min) + min).to(_dt(dtype, _dtype.get_default_dtype()))


def randn(shape, dtype=None) -> Tensor:
    gen = _gen()
    return torch.randn(_shape_list(shape), generator=gen, device=gen.device,
                       dtype=torch.float32).to(_dt(dtype, _dtype.get_default_dtype()))


def standard_normal(shape, dtype=None) -> Tensor:
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = _t(mean), _t(std)
        dev = m.device if isinstance(mean, Tensor) else s.device
        shp = torch.broadcast_shapes(m.shape, s.shape)
        gen = _gen(dev)
        z = torch.randn(shp, generator=gen, device=dev, dtype=torch.float32)
        return z * s.to(dev) + m.to(dev)
    gen = _gen()
    z = torch.randn(_shape_list([1] if shape is None else shape), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return z * std + mean


def randint(low=0, high=None, shape=(1,), dtype="int64") -> Tensor:
    if high is None:
        low, high = 0, low
    gen = _gen()
    return torch.randint(int(low), int(high), _shape_list(shape), generator=gen,
                         device=gen.device, dtype=_dt(dtype))


def randint_like(x, low=0, high=None, dtype=None) -> Tensor:
    x = _t(x)
    if high is None:
        low, high = 0, low
    gen = _gen(x.device)
    out = torch.randint(int(low), int(high), x.shape, generator=gen, device=x.device,
                        dtype=torch.int64)
    return out.to(_dt(dtype, x.dtype))


def randperm(n, dtype="int64") -> Tensor:
    gen = _gen()
    return torch.randperm(int(n), generator=gen, device=gen.device, dtype=_dt(dtype))


def bernoulli(x) -> Tensor:
    x = _t(x)
    return torch.bernoulli(x.detach().float(), generator=_gen(x.device)).to(x.dtype)


def poisson(x) -> Tensor:
    x = _t(x)
    return torch.poisson(x.detach().float(), generator=_gen(x.device)).to(x.dtype)


def multinomial(x, num_samples=1, replacement=False) -> Tensor:
    x = _t(x)
    return torch.multinomial(x.detach().float(), num_samples, replacement=replacement,
                             generator=_gen(x.device))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1) -> Tensor:
    """softmax((x + g) / temperature) with g ~ Gumbel(0, 1); `hard` gives the
    one-hot of its argmax with the soft gradient (straight through)."""
    x = amp1("gumbel_softmax", _t(x))
    gen = _gen(x.device)
    u = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    y = torch.softmax((x + g.to(x.dtype)) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def binomial(count, prob, name=None) -> Tensor:
    c, p = torch.broadcast_tensors(_t(count).detach().float(), _t(prob).detach().float())
    return torch.binomial(c, p, generator=_gen(c.device)).to(torch.int64)


def standard_gamma(x, name=None) -> Tensor:
    """Gamma(alpha=x, scale=1)."""
    x = _t(x)
    return torch._standard_gamma(x.detach().float(), generator=_gen(x.device)).to(x.dtype)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False, default_initializer=None):
    """A standalone learnable parameter on the framework device, initialized
    as a Layer's (nn/layer.py create_parameter)."""
    from ..nn.layer import Layer

    return Layer().create_parameter(list(shape), attr=attr, dtype=dtype, is_bias=is_bias,
                                    default_initializer=default_initializer)


def create_tensor(dtype, name=None, persistable=False):
    """An empty tensor of `dtype`, to be filled by assign or set_value."""
    t = torch.zeros((0,), dtype=_dt(dtype), device=_dev())
    t.persistable = persistable
    return t



__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and getattr(_v, "__module__", None) == __name__
           and callable(_v)]
