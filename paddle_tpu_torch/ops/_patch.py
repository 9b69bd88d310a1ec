"""paddle's method forms on torch.Tensor (counterpart of paddle_tpu/ops/_patch.py).

Three rules (core/tensor.py):
1. every op of math, manipulation, linalg, search and logic whose name
   torch.Tensor lacks becomes a method (`x.concat`, `x.astype`, `x.scale_`);
2. `WIDENED` torch methods take paddle's forms where torch refuses the
   call, and fall through to the saved C method for every call torch
   accepts (`x.transpose([0, 2, 1])`, `x.reshape([0, -1])`,
   `x.gather(index, axis=1)`; `numpy()` is in core/tensor.py);
3. `CONFLICTS`: one call form that means different things in the two
   packages keeps torch's meaning; paddle's is the function
   `paddle_tpu_torch.<name>`.
Every other name the two Tensor classes share means the same in both for
the forms torch accepts; the dunders (`+`, `==`, `@`, ...) are torch's.
An integer tensor's torch method returns torch's float32 where the
paddle function returns float64 for int64 (the JAX package runs x64).
"""
from __future__ import annotations

import torch

from ..core import tensor as _core_tensor
from . import creation, inplace, linalg, logic, manipulation, math, search

CONFLICTS = {
    "shape": "torch.Size (a tuple) in torch, a list in paddle",
    "size": "a method in torch, the element count (an int property) in paddle",
    "dtype": "a torch.dtype in torch, a numpy dtype in the JAX package",
    "name": "torch's read-only attribute (None)",
    "max": "x.max(axis) is (values, indices) in torch, the values in paddle",
    "min": "x.min(axis) is (values, indices) in torch, the values in paddle",
    "split": "x.split(2) takes a chunk size in torch, a section count in paddle",
    "sort": "(values, indices) in torch, the values in paddle",
    "sum": "positional order: (dim, keepdim, dtype) in torch, (axis, dtype, keepdim) in paddle",
    "nansum": "positional order: (dim, keepdim, dtype) in torch, (axis, dtype, keepdim) in paddle",
    "cumsum": "an int32 cumsum is int64 in torch, int32 in paddle",
    "cumprod": "an int32 cumprod is int64 in torch, int32 in paddle",
    "mode": "the index of a mode's first occurrence in torch, its last in paddle",
    "median": "the lower middle (and its index with a dim) in torch, the mean of the two "
              "middles in paddle",
    "nanmedian": "the lower middle in torch, the mean of the two middles in paddle",
    "unique": "positional order: (sorted, return_inverse, ...) in torch, (return_index, ...) "
              "in paddle",
    "view": "x.view(dtype) reinterprets the bits in torch, casts in paddle",
    "where": "x.where(condition, y) in torch; paddle's method takes the condition as self",
    "scatter": "(dim, index, src) in torch, (index, updates, overwrite) in paddle",
    "scatter_": "(dim, index, src) in torch, (index, updates, overwrite) in paddle",
    "index_add": "(dim, index, source) in torch, (index, axis, value) in paddle",
    "index_add_": "(dim, index, source) in torch, (index, axis, value) in paddle",
    "index_fill": "(dim, index, value) in torch, (index, axis, value) in paddle",
    "index_fill_": "(dim, index, value) in torch, (index, axis, value) in paddle",
    "slice_scatter": "(src, dim, start, end, step) in torch, (value, axes, starts, ends, "
                     "strides) in paddle",
    "histogram": "(hist, bin_edges) in torch, the counts in paddle",
    "svd": "x.svd() gives V in torch, paddle's svd gives V^H",
    "eig": "torch's Tensor.eig is removed (raises)",
    "triangular_solve": "self is B in torch, A in paddle",
    "cov": "positional order: (correction, fweights, aweights) in torch, (rowvar, ddof, ...) "
           "in paddle",
    "equal": "x.equal(y) is one bool (all equal) in torch, elementwise in paddle",
    "allclose": "a Python bool in torch, a 0-d bool tensor in paddle",
    "frexp": "the exponent is int32 in torch, the mantissa's dtype in paddle",
    "real": "a property in torch, a method in paddle",
    "imag": "a property in torch, a method in paddle",
    "divide": "int64 / int64 is float32 in torch, float64 in the JAX package (x64)",
    "cuda": "the second positional is non_blocking in torch, blocking in paddle",
    "uniform_": "U(0, 1) by default in torch, U(-1, 1) in paddle",
    "greater_equal_": "keeps x's dtype in torch (1.0/0.0), makes x bool in paddle",
    "less_equal_": "keeps x's dtype in torch, makes x bool in paddle",
    "not_equal_": "keeps x's dtype in torch, makes x bool in paddle",
    "logical_and_": "keeps x's dtype in torch, makes x bool in paddle",
    "logical_or_": "keeps x's dtype in torch, makes x bool in paddle",
    "logical_xor_": "keeps x's dtype in torch, makes x bool in paddle",
    "logical_not_": "keeps x's dtype in torch, makes x bool in paddle",
    "stft": "torch's signature; paddle's stft waits for the signal/fft slice",
    "istft": "torch's signature; paddle's istft waits for the signal/fft slice",
}

# torch.Tensor's own attribute names, before any of paddle's are attached
TORCH_NAMES = frozenset(dir(torch.Tensor))

WIDENED = ("numpy", "transpose", "unsqueeze", "gather", "index_select", "reshape", "expand",
           "tile")

# the saved C methods the widened forms fall through to
TORCH_METHODS = {name: getattr(torch.Tensor, name) for name in WIDENED}

_c_transpose = TORCH_METHODS["transpose"]
_c_unsqueeze = TORCH_METHODS["unsqueeze"]
_c_gather = TORCH_METHODS["gather"]
_c_index_select = TORCH_METHODS["index_select"]
_c_reshape = TORCH_METHODS["reshape"]
_c_expand = TORCH_METHODS["expand"]
_c_tile = TORCH_METHODS["tile"]


def transpose(self, *args, **kwargs):
    """torch's transpose(dim0, dim1); paddle's transpose(perm) for a list."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)) and not kwargs:
        return manipulation.transpose(self, args[0])
    if "perm" in kwargs and not args:
        return manipulation.transpose(self, kwargs["perm"])
    return _c_transpose(self, *args, **kwargs)


def unsqueeze(self, *args, **kwargs):
    """torch's unsqueeze(dim); paddle's unsqueeze(axis) for a list of axes."""
    axis = args[0] if len(args) == 1 else kwargs.get("axis")
    if isinstance(axis, (list, tuple)):
        return manipulation.unsqueeze(self, axis)
    return _c_unsqueeze(self, *args, **kwargs)


def gather(self, *args, **kwargs):
    """torch's gather(dim, index); paddle's gather(index, axis=0) (a take
    along the axis) when the index comes first."""
    if (args and isinstance(args[0], torch.Tensor)) or ("axis" in kwargs and "dim" not in kwargs):
        return manipulation.gather(self, *args, **kwargs)
    return _c_gather(self, *args, **kwargs)


def index_select(self, *args, **kwargs):
    """torch's index_select(dim, index); paddle's index_select(index, axis=0)."""
    if (args and isinstance(args[0], torch.Tensor)) or ("axis" in kwargs and "dim" not in kwargs):
        return manipulation.index_select(self, *args, **kwargs)
    return _c_index_select(self, *args, **kwargs)


def _paddle_shape(args, kwargs, key):
    """The one list or tensor shape argument of a paddle call, or None."""
    if len(args) == 1 and not kwargs and isinstance(args[0], (list, tuple, torch.Tensor)):
        return args[0]
    if not args and set(kwargs) == {key}:
        return kwargs[key]
    return None


def reshape(self, *args, **kwargs):
    """torch's reshape; paddle's for a tensor shape or a 0 (copy the dim)
    in the shape of a non-empty tensor, which torch refuses."""
    if len(args) == 1 and not kwargs:  # the one form that can be paddle's
        shape = args[0]
        if isinstance(shape, torch.Tensor) or (isinstance(shape, (list, tuple)) and 0 in shape
                                               and self.numel()):
            return manipulation.reshape(self, shape)
    elif "shape" in kwargs and not args and isinstance(kwargs["shape"], torch.Tensor):
        return manipulation.reshape(self, kwargs["shape"])
    return _c_reshape(self, *args, **kwargs)


def expand(self, *args, **kwargs):
    """torch's expand(*sizes); paddle's expand(shape) for `shape=` or a tensor."""
    shape = _paddle_shape(args, kwargs, "shape")
    if isinstance(shape, torch.Tensor) or "shape" in kwargs:
        return manipulation.expand(self, shape)
    return _c_expand(self, *args, **kwargs)


def tile(self, *args, **kwargs):
    """torch's tile(dims); paddle's tile(repeat_times) for that keyword or a tensor."""
    reps = _paddle_shape(args, kwargs, "repeat_times")
    if isinstance(reps, torch.Tensor) or "repeat_times" in kwargs:
        return manipulation.tile(self, reps)
    return _c_tile(self, *args, **kwargs)


def patch_tensor():
    """Attach the method forms (rules 1 and 2); run once, at import."""
    T = torch.Tensor
    _core_tensor.install()
    for fn in (transpose, unsqueeze, gather, index_select, reshape, expand, tile):
        setattr(T, fn.__name__, fn)
    for mod in (math, manipulation, linalg, search, logic):
        for name, fn in vars(mod).items():
            if (name.startswith("_") or getattr(fn, "__module__", None) != mod.__name__
                    or isinstance(fn, type) or hasattr(T, name)):
                continue
            setattr(T, name, fn)
    T.polar = creation.polar
    T.create_parameter = staticmethod(creation.create_parameter)
    T.create_tensor = staticmethod(creation.create_tensor)
    T.scale_ = inplace._make_inplace("scale")
    inplace.patch_tensor_inplace()
