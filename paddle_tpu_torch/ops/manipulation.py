"""Shape and layout manipulation (counterpart of paddle_tpu/ops/manipulation.py).

paddle's forms: `reshape` copies a 0 dim from the input, `squeeze` drops
only the named axes of size 1, `gather` is a take along one axis
(index_select, with a multi-dimensional index flattened), `split` takes a
section count or sizes (with one -1), and `unsqueeze` a list of axes.
Ops whose output size depends on the data (masked_select, nonzero,
unique) run on their inputs' device like the rest.
"""
from __future__ import annotations

import builtins

import torch

from ..framework import dtype as _dtype
from ._common import Tensor, _t, amp, amp1, binary_promote, int_list as _static_shape, scalar


def reshape(x, shape, name=None):
    x = amp1("reshape", _t(x))
    shp = _static_shape(shape)
    if 0 in shp:  # paddle: 0 copies the input's dim
        shp = [x.shape[i] if s == 0 else s for i, s in enumerate(shp)]
    return torch.reshape(x, shp)


def reshape_(x, shape, name=None):
    from .inplace import _become

    return _become(x, reshape(x, shape))


def transpose(x, perm, name=None):
    return amp1("transpose", _t(x)).permute(*[int(p) for p in perm])


def moveaxis(x, source, destination):
    return torch.movedim(amp1("moveaxis", _t(x)), source, destination)


def swapaxes(x, axis0, axis1):
    return torch.swapaxes(amp1("swapaxes", _t(x)), axis0, axis1)


def t(x):
    x = amp1("t", _t(x))
    return x if x.ndim < 2 else x.t()


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes start_axis..stop_axis (inclusive) merged into one."""
    x = amp1("flatten", _t(x))
    return torch.flatten(x, start_axis, stop_axis)


def squeeze(x, axis=None, name=None):
    x = amp1("squeeze", _t(x))
    if axis is None:
        return torch.squeeze(x)
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    ax = tuple(int(a) % x.ndim for a in ax if x.shape[int(a) % x.ndim] == 1)
    return torch.squeeze(x, ax) if ax else x


def squeeze_(x, axis=None):
    from .inplace import _become

    return _become(x, squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    x = amp1("unsqueeze", _t(x))
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    out = x
    for a in sorted(int(scalar(a)) for a in ax):
        out = out.unsqueeze(a % (out.ndim + 1) if a >= 0 else a + out.ndim + 1)
    return out


def unsqueeze_(x, axis):
    from .inplace import _become

    return _become(x, unsqueeze(x, axis))


def concat(x, axis=0, name=None):
    return torch.cat(amp("concat", *[_t(i) for i in x]), dim=int(scalar(axis)))


def stack(x, axis=0, name=None):
    return torch.stack(amp("stack", *[_t(i) for i in x]), dim=axis)


def hstack(x):
    return torch.hstack(amp("hstack", *[_t(i) for i in x]))


def vstack(x):
    return torch.vstack(amp("vstack", *[_t(i) for i in x]))


def dstack(x):
    return torch.dstack(amp("dstack", *[_t(i) for i in x]))


def split(x, num_or_sections, axis=0, name=None):
    x = amp1("split", _t(x))
    axis = int(scalar(axis))
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dimension {axis} (size {dim}) is not divisible by {num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        if -1 in sizes:
            rest = dim - builtins.sum(s for s in sizes if s != -1)
            sizes = [rest if s == -1 else s for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def tensor_split(x, num_or_indices, axis=0):
    x = amp1("tensor_split", _t(x))
    spec = list(num_or_indices) if isinstance(num_or_indices, (list, tuple)) else num_or_indices
    return list(torch.tensor_split(x, spec, dim=axis))


def unbind(x, axis=0):
    return list(torch.unbind(amp1("unbind", _t(x)), dim=axis))


def tile(x, repeat_times, name=None):
    return torch.tile(amp1("tile", _t(x)), _static_shape(repeat_times))


def expand(x, shape, name=None):
    x = amp1("expand", _t(x))
    shp = _static_shape(shape)
    pad = len(shp) - x.ndim
    full = [x.shape[i - pad] if s == -1 else s for i, s in enumerate(shp)]
    return x.expand(full)


def expand_as(x, y, name=None):
    return expand(x, list(_t(y).shape))


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(amp1("broadcast_to", _t(x)), _static_shape(shape))


def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*amp("broadcast_tensors", *[_t(i) for i in inputs])))


def cast(x, dtype):
    """A new tensor (a view when the dtype is already `dtype`: torch's .to
    would hand x itself back, and a static capture records no op that
    returns its input)."""
    x = amp1("cast", _t(x))
    out = x.to(_dtype.convert_dtype(dtype))
    return x.view_as(x) if out is x else out


def gather(x, index, axis=0, name=None):
    x, index = amp("gather", _t(x), _t(index))
    axis = int(scalar(axis))
    idx = index.reshape(-1) if index.ndim > 1 else index
    if idx.ndim == 0:
        return torch.select(x, axis, int(idx))
    return torch.index_select(x, axis, idx)


def gather_nd(x, index, name=None):
    v, idx = amp("gather_nd", _t(x), _t(index))
    k = idx.shape[-1]
    flat = idx.reshape(-1, k)
    out = v[tuple(flat[:, j] for j in range(k))]
    return out.reshape(tuple(idx.shape[:-1]) + tuple(v.shape[k:]))


def scatter(x, index, updates, overwrite=True, name=None):
    v, i, u = amp("scatter", _t(x), _t(index), _t(updates))
    i = i.reshape(-1)
    if overwrite:
        return v.index_put((i,), u)
    z = v.index_put((i,), torch.zeros_like(u))
    return z.index_put((i,), u, accumulate=True)


def scatter_(x, index, updates, overwrite=True):
    from .inplace import _become

    return _become(x, scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    v, idx, u = amp("scatter_nd_add", _t(x), _t(index), _t(updates))
    k = idx.shape[-1]
    flat = idx.reshape(-1, k)
    uflat = u.reshape((-1,) + tuple(v.shape[k:]))
    return v.index_put(tuple(flat[:, j] for j in range(k)), uflat, accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    u = _t(updates)
    z = torch.zeros(_static_shape(shape), dtype=u.dtype, device=u.device)
    return scatter_nd_add(z, index, u)


def index_select(x, index, axis=0, name=None):
    v, i = amp("index_select", _t(x), _t(index))
    return torch.index_select(v, axis, i)


def index_sample(x, index):
    v, i = amp("index_sample", _t(x), _t(index))
    return torch.take_along_dim(v, i, dim=1)


def index_add(x, index, axis, value):
    v, i, u = amp("index_add", _t(x), _t(index), _t(value))
    return torch.index_add(v, axis % v.ndim, i, u)


def index_put(x, indices, value, accumulate=False):
    v, u = amp("index_put", _t(x), _t(value))
    return v.index_put(tuple(_t(i) for i in indices), u, accumulate=accumulate)


def take_along_axis(arr, indices, axis, broadcast=True):
    v, i = amp("take_along_axis", _t(arr), _t(indices))
    return torch.take_along_dim(v, i, dim=axis)


def put_along_axis(arr, indices, values, axis, reduce="assign"):
    v, i = _t(arr), _t(indices)
    u = _t(values, v.device)
    v, i, u = amp("put_along_axis", v, i, u)
    u = torch.broadcast_to(u.to(v.dtype), i.shape)
    ax = axis % v.ndim
    if reduce == "assign":
        return torch.scatter(v, ax, i, u)
    if reduce == "add":
        return torch.scatter_add(v, ax, i, u)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(v, ax, i, u, reduce="prod")
    raise ValueError(f"unsupported reduce {reduce}")


def take(x, index, mode="raise"):
    v, i = amp("take", _t(x), _t(index))
    flat = v.reshape(-1)
    n = flat.shape[0]
    if mode == "wrap":
        i = torch.remainder(i, n)
    elif mode == "clip":
        i = torch.clamp(i, 0, n - 1)
    else:
        i = torch.where(i < 0, i + n, i)
    return flat[i]


def masked_select(x, mask, name=None):
    v, m = amp1("masked_select", _t(x)), _t(mask)
    return torch.masked_select(v, m)


def masked_fill(x, mask, value):
    v, m = amp1("masked_fill", _t(x)), _t(mask)
    val = value.detach().to(v.dtype) if isinstance(value, Tensor) else value
    return torch.masked_fill(v, m, val)


def masked_fill_(x, mask, value):
    from .inplace import _become

    return _become(x, masked_fill(x, mask, value))


def masked_scatter(x, mask, value):
    v, u = amp("masked_scatter", _t(x), _t(value))
    return torch.masked_scatter(v, torch.broadcast_to(_t(mask), v.shape), u.to(v.dtype))


def where(condition, x=None, y=None, name=None):
    condition = _t(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x, y = binary_promote(x, y)
    c, x, y = amp("where", condition, x, y)
    return torch.where(c, x, y)


def nonzero(x, as_tuple=False):
    x = _t(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def roll(x, shifts, axis=None, name=None):
    x = amp1("roll", _t(x))
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def flip(x, axis, name=None):
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(amp1("flip", _t(x)), [int(a) for a in ax])


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(amp1("rot90", _t(x)), k, list(axes))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = amp1("repeat_interleave", _t(x))
    if isinstance(repeats, Tensor):
        repeats = repeats.to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def slice(x, axes, starts, ends):  # noqa: A001
    x = amp1("slice", _t(x))
    idx = [builtins.slice(None)] * x.ndim
    for a, s, e in zip(axes, _static_shape(starts), _static_shape(ends)):
        idx[a] = builtins.slice(s, e)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides):
    x = amp1("strided_slice", _t(x))
    idx = [builtins.slice(None)] * x.ndim
    backward = []  # torch slices forward only: a negative stride is an index_select
    for a, s, e, st in zip(axes, _static_shape(starts), _static_shape(ends),
                           _static_shape(strides)):
        if st > 0:
            idx[a] = builtins.slice(s, e, st)
        else:
            backward.append((a, range(*builtins.slice(s, e, st).indices(x.shape[a]))))
    out = x[tuple(idx)]
    for a, r in backward:
        out = out.index_select(a, torch.tensor(list(r), dtype=torch.int64, device=x.device))
    return out


def crop(x, shape=None, offsets=None):
    x = amp1("crop", _t(x))
    shp = _static_shape(shape)
    offs = _static_shape(offsets) if offsets is not None else [0] * len(shp)
    shp = [x.shape[i] - offs[i] if s == -1 else s for i, s in enumerate(shp)]
    # lax.dynamic_slice clamps each start so that the window fits
    offs = [builtins.min(builtins.max(o, 0), x.shape[i] - s) for i, (o, s) in enumerate(zip(offs, shp))]
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):  # noqa: A002
    v = _t(input)
    size = index_num // nshards
    return torch.where(v // size == shard_id, v % size,
                       torch.tensor(ignore_value, dtype=v.dtype, device=v.device))


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64"):
    v = _t(x)
    out, inverse, counts = torch.unique(v if axis is not None else v.reshape(-1), sorted=True,
                                        return_inverse=True, return_counts=True, dim=axis)
    res = [out]
    if return_index:  # the first position of each unique value (np.unique's)
        n = inverse.shape[0]
        pos = torch.arange(n, device=v.device)
        first = torch.full((out.shape[0] if axis is None else out.shape[axis],), n,
                           dtype=torch.int64, device=v.device)
        res.append(first.scatter_reduce(0, inverse.reshape(-1), pos, reduce="amin"))
    if return_inverse:
        res.append(inverse.reshape(-1) if axis is None else inverse)
    if return_counts:
        res.append(counts)
    return res[0] if len(res) == 1 else tuple(res)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    v = _t(x).reshape(-1)
    out, inverse, counts = torch.unique_consecutive(v, return_inverse=True, return_counts=True)
    res = [out] + ([inverse] if return_inverse else []) + ([counts] if return_counts else [])
    return res[0] if len(res) == 1 else tuple(res)


def as_complex(x):
    return torch.view_as_complex(amp1("as_complex", _t(x)).contiguous())


def as_real(x):
    return torch.view_as_real(amp1("as_real", _t(x)))


def view(x, shape_or_dtype):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def view_as(x, other):
    return reshape(x, list(_t(other).shape))


def as_strided(x, shape, stride, offset=0):
    x = amp1("as_strided", _t(x))
    return torch.as_strided(x.contiguous().reshape(-1), list(shape), list(stride), offset)


def atleast_1d(*inputs):
    outs = [torch.atleast_1d(amp1("atleast_1d", _t(x))) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs):
    outs = [torch.atleast_2d(amp1("atleast_2d", _t(x))) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs):
    outs = [torch.atleast_3d(amp1("atleast_3d", _t(x))) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def numel(x):
    x = _t(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def shape(x):
    x = _t(x)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def rank(x):
    x = _t(x)
    return torch.tensor(x.ndim, dtype=torch.int32, device=x.device)


def is_tensor(x):
    return isinstance(x, Tensor)


def is_floating_point(x):
    return _t(x).is_floating_point()


def is_integer(x):
    x = _t(x)
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def is_complex(x):
    return _t(x).is_complex()


def is_empty(x):
    x = _t(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def unfold(x, axis, size, step):
    """Windows along `axis`, the window dim appended last."""
    return amp1("unfold_tensor", _t(x)).unfold(axis, size, step)


def pad_sequences(*a, **k):
    raise NotImplementedError


def unstack(x, axis=0, num=None):
    if num is not None and int(x.shape[axis]) != num:
        raise ValueError(f"unstack: num={num} != size of axis {axis} ({int(x.shape[axis])})")
    return unbind(x, axis)


def tolist(x):
    return _t(x).tolist()


def column_stack(x, name=None):
    return torch.column_stack(amp("column_stack", *[_t(i) for i in x]))


def row_stack(x, name=None):
    return torch.vstack(amp("row_stack", *[_t(i) for i in x]))


def _np_split_args(num_or_indices):
    if isinstance(num_or_indices, Tensor):
        num_or_indices = num_or_indices.tolist()
    if isinstance(num_or_indices, (list, tuple)):
        return [int(i) for i in num_or_indices]
    return int(num_or_indices)


def hsplit(x, num_or_indices, name=None):
    return list(torch.hsplit(amp1("hsplit", _t(x)), _np_split_args(num_or_indices)))


def vsplit(x, num_or_indices, name=None):
    return list(torch.vsplit(amp1("vsplit", _t(x)), _np_split_args(num_or_indices)))


def dsplit(x, num_or_indices, name=None):
    return list(torch.dsplit(amp1("dsplit", _t(x)), _np_split_args(num_or_indices)))


def unflatten(x, axis, shape, name=None):
    x = amp1("unflatten", _t(x))
    return torch.unflatten(x, axis % x.ndim, _static_shape(shape))


def index_fill(x, index, axis, value, name=None):
    v, i = amp("index_fill", _t(x), _t(index))
    return torch.index_fill(v, axis % v.ndim, i, scalar(value))


def index_fill_(x, index, axis, value, name=None):
    from .inplace import _become

    return _become(x, index_fill(x, index, axis, value))


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    v, w = amp("diagonal_scatter", _t(x), _t(y))
    return torch.diagonal_scatter(v, w.to(v.dtype), offset, axis1, axis2)


def select_scatter(x, values, axis, index, name=None):
    v, w = amp("select_scatter", _t(x), _t(values))
    return torch.select_scatter(v, w.to(v.dtype), axis, index)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    v, w = amp("slice_scatter", _t(x), _t(value))
    sl = [builtins.slice(None)] * v.ndim
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        sl[ax] = builtins.slice(int(st), int(en), int(sd))
    out = v.clone()
    out[tuple(sl)] = w.to(v.dtype)
    return out


# paddle exports `flip as reverse`
reverse = flip


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and getattr(_v, "__module__", None) == __name__
           and callable(_v)]

# each public op is one recorded op of a static capture (core/record.py)
from ..core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
