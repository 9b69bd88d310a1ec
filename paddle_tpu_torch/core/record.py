"""Program capture: how an op reaches the Program `static.program_guard`
records into (the port's counterpart of paddle_tpu/core/apply.py:45-55 and
:254-262, `apply` and `_record_static`).

The JAX package has one op entry, `core.apply(name, fn, *args)`, and
records every op there under paddle's name. The port has none: its op
functions run torch directly, and its models and layers call torch
themselves (`x + y`, `.view`, `TF.silu`). Capture therefore has two
halves, both active only inside a guard:

- every public op function of the port (ops/*, nn.functional,
  incubate.nn.functional) is wrapped by `op`: called at the top
  level, it runs once and is recorded as ONE op under its paddle name,
  its replay the function itself. The calls it makes inside are not
  recorded (a depth count), so `linear`'s inner matmul and transpose
  never appear, and a kernel launched through ctypes, which no torch
  hook sees, replays because the function that launches it does.
- `CaptureMode`, a `torch.overrides.TorchFunctionMode`, sees the torch
  calls made at the top level, by model and user code, and records each
  under the JAX package's name for it (`TensorBase.add` is "add",
  `view` is "reshape", `__getitem__` is "getitem"). Creation calls with
  no tensor input (`torch.arange`, `zeros_like`) are not recorded: their
  results become external inputs of the program, as a tensor made
  outside `apply` does in the JAX package.

A recorded op's replay (`Replay`) takes the op's flattened arguments,
tensors and literals alike (`in_refs` holds one entry for each), and
restores what it was captured under: the AMP state of a paddle op (the
JAX package folds the cast into the recorded fn, apply.py:45-55, so a
Program run outside `auto_cast` computes what it captured), and, for an
op that drew from the framework generators, the generators' states
before the draw, so a replay draws the capture's numbers again (the JAX
package closes over the capture's key). A method whose torch meaning
differs from paddle's (ops/_patch.py `CONFLICTS`) replays the callable
that was called: `paddle.max(x, 1)` is recorded and replayed with
paddle's meaning, `x.max(1)` with torch's.

An in-place torch call on a tensor that is already a program var
raises: the replay of a recorded list cannot mutate a value it already
handed on. On any other tensor (a parameter being initialized) it runs
unrecorded.
"""
from __future__ import annotations

import functools

import torch
from torch.overrides import TorchFunctionMode

from . import state

_tls = state._tls
_ACTIVE = state.ACTIVE
_LEAF = object()  # a flattened leaf's place in a spec
_NO_AMP = object()  # a Replay that leaves the AMP state alone


# ---------------------------------------------------------------------------
# arguments as leaves
# ---------------------------------------------------------------------------

def _flatten(obj, leaves):
    t = type(obj)
    if t is list or t is tuple:
        return (t, [_flatten(o, leaves) for o in obj])
    if t is dict:
        return (dict, [(k, _flatten(v, leaves)) for k, v in obj.items()])
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a namedtuple
        return (t, [_flatten(o, leaves) for o in obj])
    leaves.append(obj)
    return _LEAF


def _unflatten(spec, it):
    if spec is _LEAF:
        return next(it)
    t, items = spec
    if t is dict:
        return {k: _unflatten(s, it) for k, s in items}
    vals = [_unflatten(s, it) for s in items]
    if t is list:
        return vals
    if t is tuple:
        return tuple(vals)
    return t(*vals)


def flatten_call(args, kwargs):
    """(leaves, spec) of a call's positional and keyword arguments."""
    leaves = []
    spec = _flatten((tuple(args), dict(kwargs)), leaves)
    return leaves, spec


class Replay:
    """A recorded op's callable: `Replay(*leaves)` rebuilds the call's
    arguments from its leaves and calls the target under the captured AMP
    state and generator states."""

    __slots__ = ("target", "spec", "amp", "rng")

    def __init__(self, target, spec, amp=_NO_AMP, rng=None):
        self.target = target
        self.spec = spec
        self.amp = amp
        self.rng = rng

    def __call__(self, *vals):
        args, kwargs = _unflatten(self.spec, iter(vals))
        amp_mod = rnd = None
        if self.amp is not _NO_AMP:
            from .. import amp as amp_mod

            prev_amp = amp_mod._set_amp_state(self.amp)
        if self.rng is not None:
            from ..framework import random as rnd

            saved = rnd.get_rng_state()
            rnd.set_rng_state(self.rng)
        try:
            return self.target(*args, **kwargs)
        finally:
            if rnd is not None:
                rnd.set_rng_state(saved)
            if amp_mod is not None:
                amp_mod._set_amp_state(prev_amp)

    def __repr__(self):
        return f"<replay {getattr(self.target, '__qualname__', self.target)}>"


# ---------------------------------------------------------------------------
# recording one call
# ---------------------------------------------------------------------------

def _rng_changed(before, after) -> bool:
    if before.keys() != after.keys():
        return True
    return any(not torch.equal(before[k], after[k]) for k in before)


def _out_tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [o for o in out if isinstance(o, torch.Tensor)]
    return []


def record_call(name, target, args, kwargs, carry_amp=True):
    """Run `target(*args, **kwargs)` as one op of the Program being
    captured (its inner calls unrecorded) and record it under `name`."""
    from ..framework import random as rnd

    prog = state.get_program_capture()
    before = rnd.get_rng_state()
    _tls.depth += 1
    try:
        out = target(*args, **kwargs)
    finally:
        _tls.depth -= 1
    outs = _out_tensors(out)
    if not outs:
        return out
    leaves, spec = flatten_call(args, kwargs)
    ids = {id(x) for x in leaves if isinstance(x, torch.Tensor)}
    if all(id(o) in ids for o in outs):
        return out  # the op handed an input back: nothing new to record
    amp = _NO_AMP
    if carry_amp:
        from ..amp import get_amp_state

        amp = get_amp_state()
    rng = before if _rng_changed(before, rnd.get_rng_state()) else None
    prog.record_op(name, Replay(target, spec, amp, rng), leaves, {}, out)
    return out


def op(fn):
    """`fn` as one recorded op, named by its `__name__`, when called at the
    top level under a program_guard. Outside capture the wrapper is one
    list read and the call."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _ACTIVE[0] or _tls.depth or _tls.program_capture is None:
            return fn(*args, **kwargs)
        return record_call(name, fn, args, kwargs)

    return wrapper


def apply(name, fn, *args, **kwargs):
    """`fn(*args, **kwargs)` as one recorded op `name` (the JAX package's
    `core.apply` for code that has a function but no op of its own, as
    the Llama attention's RoPE)."""
    if not _ACTIVE[0] or _tls.depth or _tls.program_capture is None:
        return fn(*args, **kwargs)
    return record_call(name, fn, args, kwargs)


def apply_nograd(name, fn, *args, **kwargs):
    """`apply` for an op that is never differentiable (a comparison, an
    argmax): `fn` runs without autograd, now and at every replay."""
    return apply(name, _NoGrad(fn), *args, **kwargs)


class _NoGrad:
    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, **kwargs):
        with torch.no_grad():
            return self.fn(*args, **kwargs)


def record_module(namespace):
    """Wrap every public function a module defines (its globals) as a
    recorded op under its own `__name__` (aliases of one function share
    one wrapper, and with it the function's name)."""
    done = {}
    for n, fn in list(namespace.items()):
        if (n.startswith("_") or not callable(fn) or isinstance(fn, type)
                or getattr(fn, "__module__", None) != namespace["__name__"]):
            continue
        w = done.get(id(fn))
        if w is None:
            w = done[id(fn)] = op(fn)
        namespace[n] = w


class suspended:
    """Nothing inside is recorded (parameter initialization inside a
    program_guard)."""

    def __enter__(self):
        _tls.depth += 1
        return self

    def __exit__(self, *exc):
        _tls.depth -= 1
        return False


# ---------------------------------------------------------------------------
# torch calls made at the top level
# ---------------------------------------------------------------------------

# torch's name -> the JAX package's recorded name; a torch name not here
# is recorded as it is
TORCH_NAMES = {
    "add": "add", "__add__": "add", "__radd__": "add",
    "sub": "subtract", "subtract": "subtract", "__sub__": "subtract", "__rsub__": "subtract",
    "rsub": "subtract",
    "mul": "multiply", "multiply": "multiply", "__mul__": "multiply", "__rmul__": "multiply",
    "div": "divide", "divide": "divide", "true_divide": "divide", "__truediv__": "divide",
    "__rtruediv__": "divide",
    "floor_divide": "floor_divide", "__floordiv__": "floor_divide",
    "remainder": "mod", "__mod__": "mod",
    "pow": "pow", "__pow__": "pow", "__rpow__": "pow",
    "matmul": "matmul", "__matmul__": "matmul", "mm": "matmul",
    "neg": "neg", "__neg__": "neg",
    "view": "reshape", "reshape": "reshape", "view_as": "reshape", "reshape_as": "reshape",
    "__getitem__": "getitem",
    "transpose": "transpose", "permute": "transpose", "t": "transpose", "swapaxes": "transpose",
    "T": "transpose", "mT": "transpose",
    "to": "cast", "float": "cast", "double": "cast", "half": "cast", "bfloat16": "cast",
    "int": "cast", "long": "cast", "bool": "cast", "type_as": "cast",
    "cat": "concat", "concat": "concat", "concatenate": "concat",
    "repeat": "tile", "clamp": "clip", "clip": "clip",
    "eq": "equal", "__eq__": "equal", "ne": "not_equal", "__ne__": "not_equal",
    "lt": "less_than", "__lt__": "less_than", "le": "less_equal", "__le__": "less_equal",
    "gt": "greater_than", "__gt__": "greater_than", "ge": "greater_equal",
    "__ge__": "greater_equal",
    "__and__": "bitwise_and", "__or__": "bitwise_or", "__xor__": "bitwise_xor",
    "__invert__": "bitwise_not", "amax": "max", "amin": "min",
}

# in-place calls that only touch autograd metadata: run, never refused
_METADATA_INPLACE = frozenset({"requires_grad_", "retain_grad", "share_memory_", "detach_"})
_INPLACE_DUNDERS = frozenset({
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__", "__ifloordiv__",
    "__imod__", "__ipow__", "__iand__", "__ior__", "__ixor__", "__ilshift__", "__irshift__",
})


class DynamicShape(tuple):
    """The shape of a static.data placeholder with -1 dims (a tuple:
    torch.Size takes no subclass): reading a dynamic dim in Python raises
    (the dry run's 1 would be baked into the program); static dims read
    as usual."""

    def __new__(cls, dims, dynamic):
        self = super().__new__(cls, dims)
        self._dynamic = frozenset(dynamic)
        return self

    def _refuse(self, i):
        raise RuntimeError(
            f"dim {i} of this static.data placeholder is dynamic (-1): reading it in Python "
            "during capture would bake the dry-run size into the program; pass -1 to "
            "reshape, or read it in the graph (paddle.shape)")

    def __getitem__(self, i):
        if isinstance(i, slice):
            for j in range(len(self))[i]:
                if j in self._dynamic:
                    self._refuse(j)
            return torch.Size(super().__getitem__(i))
        j = i + len(self) if i < 0 else i
        if j in self._dynamic:
            self._refuse(j)
        return super().__getitem__(i)

    def __iter__(self):
        if self._dynamic:
            self._refuse(min(self._dynamic))
        return super().__iter__()


def _dynamic_dims(x):
    return getattr(x, "_dynamic_dims", None) if isinstance(x, torch.Tensor) else None


class CaptureMode(TorchFunctionMode):
    """Records the torch calls made at the top level of a capture."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        prog = _tls.program_capture
        if _tls.depth or prog is None:
            return func(*args, **kwargs)
        fname = getattr(func, "__name__", "")
        if fname == "__get__":  # a property read
            attr = getattr(getattr(func, "__self__", None), "__name__", "")
            if attr == "shape":
                dyn = _dynamic_dims(args[0] if args else None)
                out = func(*args, **kwargs)
                return DynamicShape(out, dyn) if dyn else out
            if attr not in ("T", "mT"):
                return func(*args, **kwargs)
            fname = attr
        elif fname in ("size", "__len__"):
            dyn = _dynamic_dims(args[0] if args else None)
            if dyn:
                shape = DynamicShape(args[0].shape, dyn)
                if fname == "__len__":
                    return shape[0]
                dim = args[1] if len(args) > 1 else kwargs.get("dim")
                return shape if dim is None else shape[dim]
            return func(*args, **kwargs)
        if (fname.endswith("_") and not fname.startswith("__")) or fname in _INPLACE_DUNDERS:
            target = args[0] if args else None
            if (fname not in _METADATA_INPLACE and isinstance(target, torch.Tensor)
                    and id(target) in prog._id2var):
                raise RuntimeError(
                    f"in-place {fname} on a tensor the program computes cannot be "
                    "recorded: use the out-of-place form under program_guard")
            return func(*args, **kwargs)
        if fname.endswith("_like") or not any(
                isinstance(x, torch.Tensor) for x in flatten_call(args, kwargs)[0]):
            return func(*args, **kwargs)  # creation: an external input, as in the JAX package
        return record_call(TORCH_NAMES.get(fname, fname), func, args, kwargs, carry_amp=False)
