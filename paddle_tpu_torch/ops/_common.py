"""What the op modules share: turning arguments into tensors, the AMP cast
of an op's inputs (the JAX package casts inside every op it applies,
paddle_tpu/core/apply.py:45-55), and the JAX package's dtype rules (it
runs with x64 on, ops/pallas.py:783-786)."""
from __future__ import annotations

import numpy as np
import torch

from ..amp import amp_cast_inputs, get_amp_state
from ..framework import device as _device
from ..framework import dtype as _dtype
from ..framework.io import numpy_to_tensor

Tensor = torch.Tensor


def _t(x, device=None) -> Tensor:
    """A tensor as it is; anything else through numpy (a Python float is
    float64, an int int64, as jnp.asarray under x64) on `device` (default:
    the framework device)."""
    if isinstance(x, Tensor):
        return x
    return numpy_to_tensor(np.asarray(x)).to(_device.resolve(device))


def amp(name, *vals):
    """`vals` cast as the op `name` casts its inputs under the active AMP
    state; returned as they are outside AMP."""
    if get_amp_state() is None:
        return vals
    return tuple(amp_cast_inputs(name, list(vals)))


def amp1(name, x):
    return x if get_amp_state() is None else amp_cast_inputs(name, [x])[0]


def inexact(x: Tensor) -> Tensor:
    """x as the floating type a jnp math function computes in: int64 (and
    uint64) become float64, other integers and bool float32."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float64 if x.dtype in (torch.int64, torch.uint64) else torch.float32)


def _scalar_tensor(y, like: Tensor) -> Tensor:
    """A Python scalar beside tensor `like`, as the JAX package's
    _binary_promote types it: a bool stays bool, an int takes like's dtype
    (int64 beside a bool), a float like's floating dtype (the default
    float beside an integer)."""
    if isinstance(y, (bool, np.bool_)):
        return torch.tensor(bool(y), device=like.device)
    if isinstance(y, (int, np.integer)):
        d = torch.int64 if like.dtype == torch.bool else like.dtype
        return torch.tensor(int(y), dtype=d, device=like.device)
    if isinstance(y, complex):
        d = like.dtype if like.is_complex() else torch.complex64
        return torch.tensor(y, dtype=d, device=like.device)
    d = like.dtype if (like.is_floating_point() or like.is_complex()) else _dtype.get_default_dtype()
    return torch.tensor(float(y), dtype=d, device=like.device)


_SCALARS = (bool, int, float, complex, np.number, np.bool_)


def binary_promote(x, y):
    """Two op arguments as two tensors of one dtype (paddle_tpu/ops/math.py
    _binary_promote, then jnp's promotion, which torch.promote_types
    matches for these types regardless of rank)."""
    if isinstance(x, Tensor):
        y = _scalar_tensor(y, x) if isinstance(y, _SCALARS) else _t(y, x.device)
    elif isinstance(y, Tensor):
        x = _scalar_tensor(x, y) if isinstance(x, _SCALARS) else _t(x, y.device)
    else:
        x, y = _t(x), _t(y)
    if x.dtype != y.dtype:
        d = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(d), y.to(d)
    return x, y


def axes(axis):
    """paddle's axis argument (int, list, tuple, tensor or None) as torch's dim."""
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        a = axis.tolist()
        return tuple(a) if isinstance(a, list) else int(a)
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def int_list(shape):
    """A shape argument (int, list with tensors in it, or a tensor) as ints."""
    if isinstance(shape, Tensor):
        return [int(s) for s in shape.reshape(-1).tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s) for s in shape]


def scalar(v):
    """A 1-element tensor argument as a Python number; anything else as is."""
    return v.item() if isinstance(v, Tensor) else v
