"""The op parity table: one row per call of a paddle op, with inputs made
from a seed by numpy. It imports numpy and torch only, so both the CPU
tests (the port against the JAX package, tests/test_torch_ops_*.py) and
`chip_smoke.py`'s op_surface phase (the port on the card against the
port on the CPU) read it.

A row names the op (`getattr(package, name)`), its arguments and keyword
arguments. Tensor arguments are specs (`F` float, `I` integer, `B` bool,
`SPD` a symmetric positive definite matrix; a list of specs is a list of
tensors); anything else is passed as it is. `grad` rows also compare the
gradient of sum(w * out) over every float output (w seeded by numpy)
with respect to every float tensor input. `bf16` rows run a second time
with the float inputs in bfloat16. `tol` names the tolerance of TOL.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

# forward and gradient tolerances, relative and absolute, by row kind:
# f32 rows differ by summation order and libm ulps; "linalg" by LAPACK vs
# XLA's decompositions (reconstructions, conditioned inputs); bf16 rows by
# a bf16 rounding of the output (2^-8) and of intermediates in a few ops
TOL = {
    "f32": dict(rtol=2e-5, atol=2e-6),
    "f32_grad": dict(rtol=1e-4, atol=1e-5),
    "linalg": dict(rtol=2e-4, atol=2e-5),
    "linalg_grad": dict(rtol=2e-3, atol=2e-4),
    "bf16": dict(rtol=1.6e-2, atol=1.6e-2),
    "bf16_grad": dict(rtol=4e-2, atol=4e-2),
}


@dataclasses.dataclass(frozen=True)
class F:
    """A float32 tensor, uniform in [lo, hi)."""
    shape: Tuple[int, ...]
    lo: float = -2.0
    hi: float = 2.0
    sort: bool = False


@dataclasses.dataclass(frozen=True)
class I:  # noqa: E742
    """An integer tensor, uniform in [lo, hi)."""
    shape: Tuple[int, ...]
    lo: int = 0
    hi: int = 5
    dtype: str = "int64"
    sort: bool = False


@dataclasses.dataclass(frozen=True)
class B:
    """A bool tensor."""
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class SPD:
    """A well-conditioned symmetric positive definite float32 matrix."""
    n: int


@dataclasses.dataclass(frozen=True)
class Perm:
    """An int64 permutation of range(n), optionally cut to its first k."""
    n: int
    k: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Arr:
    """A fixed array (nested tuples) of `dtype`: labels of +-1, lengths."""
    value: Any
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class Row:
    name: str
    args: Tuple[Any, ...]
    kwargs: Tuple[Tuple[str, Any], ...] = ()
    grad: bool = True
    tol: str = "f32"
    bf16: bool = False
    tag: str = ""

    @property
    def id(self) -> str:
        return self.name + (f"[{self.tag}]" if self.tag else "")


def R(name, *args, grad=True, tol="f32", bf16=False, tag="", **kwargs):
    return Row(name, args, tuple(sorted(kwargs.items())), grad, tol, bf16, tag)


def _make(spec, rng):
    if isinstance(spec, F):
        a = rng.uniform(spec.lo, spec.hi, spec.shape).astype(np.float32)
        return ("t", np.sort(a, -1) if spec.sort else a)
    if isinstance(spec, I):
        a = rng.randint(spec.lo, spec.hi, spec.shape).astype(spec.dtype)
        return ("t", np.sort(a, -1) if spec.sort else a)
    if isinstance(spec, B):
        return ("t", rng.rand(*spec.shape) < 0.5)
    if isinstance(spec, SPD):
        a = rng.randn(spec.n, spec.n).astype(np.float32)
        return ("t", (a @ a.T / spec.n + np.eye(spec.n, dtype=np.float32)).astype(np.float32))
    if isinstance(spec, Perm):
        p = rng.permutation(spec.n).astype(np.int64)
        return ("t", p[:spec.k] if spec.k is not None else p)
    if isinstance(spec, Arr):
        return ("t", np.array(spec.value, spec.dtype))
    if isinstance(spec, (list, tuple)) and spec and isinstance(spec[0], (F, I, B, SPD, Perm, Arr)):
        return ("list", type(spec)(_make(s, rng) for s in spec))
    return ("raw", spec)


def make_args(row: Row):
    """The row's arguments as tagged numpy values, from its own seed."""
    rng = np.random.RandomState(zlib.crc32(row.id.encode()) % (2 ** 31))
    return [_make(a, rng) for a in row.args], {k: _make(v, rng) for k, v in row.kwargs}


def weights(shape, i):
    """The cotangent of output i: seeded by its shape and index."""
    rng = np.random.RandomState(1000 + i + 7 * len(shape))
    return rng.uniform(0.5, 1.5, shape).astype(np.float32)


def flat_outputs(out):
    if isinstance(out, (list, tuple)):
        res = []
        for o in out:
            res.extend(flat_outputs(o))
        return res
    return [out]


# ---- the port side (used by the tests and by chip_smoke.py) ----

def to_torch(tagged, device, dtype=None, requires_grad=False, leaves=None):
    kind, v = tagged
    if kind == "raw":
        return v
    if kind == "list":
        return type(v)(to_torch(t, device, dtype, requires_grad, leaves) for t in v)
    t = torch.from_numpy(np.array(v)).to(device)
    if t.is_floating_point():
        if dtype is not None:
            t = t.to(dtype)
        if requires_grad:
            t.requires_grad_(True)
            leaves.append(t)
    return t


_OP_MODULES = ("creation", "math", "manipulation", "logic", "search", "linalg", "einsum",
               "inplace")


def resolve(pkg, name):
    """paddle.<name> (a dotted name: paddle.nn.functional.<op>), else
    paddle.linalg.<name>, else the ops module that defines it (a few ops are
    not exported at the top in either package)."""
    if "." in name:
        obj = pkg
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj
    for ns in (pkg, pkg.linalg):
        if hasattr(ns, name):
            return getattr(ns, name)
    for m in _OP_MODULES:
        mod = getattr(pkg.ops, m)
        if hasattr(mod, name):
            return getattr(mod, name)
    raise AttributeError(f"{pkg.__name__} has no op {name}")


def run_port(ptt, row: Row, device, dtype=None, grad=None):
    """(outputs, grads): the port's op on `device` with the float inputs in
    `dtype` (f32 when None); grads of sum(w * out) per float input when
    `grad` (default: the row's), else None. Outputs as CPU tensors."""
    grad = row.grad if grad is None else grad
    args, kwargs = make_args(row)
    leaves: list = []
    targs = [to_torch(a, device, dtype, grad, leaves) for a in args]
    tkw = {k: to_torch(v, device, dtype, grad, leaves) for k, v in kwargs.items()}
    out = resolve(ptt, row.name)(*targs, **tkw)
    outs = flat_outputs(out)
    grads = None
    if grad and leaves:
        loss = 0
        for i, o in enumerate(outs):
            if isinstance(o, torch.Tensor) and o.is_floating_point() and o.requires_grad:
                w = torch.from_numpy(weights(tuple(o.shape), i)).to(o.device)
                loss = loss + (o.float() * w).sum()
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True)) if torch.is_tensor(
            loss) else [None] * len(leaves)
        grads = [g.detach().cpu() if g is not None else None for g in grads]
    outs = [o.detach().cpu() if isinstance(o, torch.Tensor) else o for o in outs]
    return outs, grads


# ---- the rows ----

M, V, S = (3, 4), (5,), (2, 3, 4)  # a matrix, a vector, a 3-d tensor
UNIT = F(M, 0.1, 0.9)

_UNARY = ["exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh", "asinh", "abs",
          "neg", "negative", "absolute", "square", "sigmoid", "erf", "deg2rad", "rad2deg",
          "arctan", "floor", "ceil", "trunc", "frac", "sign", "sgn", "round", "rint", "stanh",
          "i0", "i0e", "i1", "i1e", "real", "conj"]
_POSITIVE = ["log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal", "lgamma", "digamma",
             "gammaln", "acosh"]
_UNIT = ["asin", "acos", "atanh", "arcsin", "arccos", "erfinv", "logit"]
_BINARY = ["add", "subtract", "multiply", "maximum", "minimum", "fmax", "fmin", "atan2", "hypot",
           "logaddexp", "copysign"]
_BF16 = {"exp", "sin", "tanh", "sigmoid", "abs", "square", "sqrt", "log", "rsqrt", "add",
         "subtract", "multiply", "divide", "maximum", "matmul", "sum", "mean", "max", "cumsum",
         "logsumexp", "concat", "reshape", "transpose", "gather", "where", "scale", "clip",
         "einsum", "bmm", "norm", "stack", "split", "squeeze", "unsqueeze", "flatten",
         "masked_fill", "take_along_axis", "std", "var", "prod", "sort", "topk", "argmax",
         "cast", "erf", "lerp", "index_select", "tile", "expand", "flip", "roll"}
_NOGRAD_ROUNDING = {"floor", "ceil", "trunc", "round", "rint", "sign", "sgn"}

ROWS = []
for _n in _UNARY:
    ROWS.append(R(_n, F(M), grad=_n not in _NOGRAD_ROUNDING, bf16=_n in _BF16))
for _n in _POSITIVE:
    ROWS.append(R(_n, F(M, 1.2, 3.0), bf16=_n in _BF16))
for _n in _UNIT:
    ROWS.append(R(_n, UNIT, bf16=_n in _BF16))
for _n in _BINARY:
    ROWS.append(R(_n, F(M), F(M), bf16=_n in _BF16))
    ROWS.append(R(_n, F((2, 1, 4)), F((3, 1)), tag="broadcast"))

ROWS += [
    R("divide", F(M), F(M, 0.5, 2.0), bf16=True),
    R("divide", I(M, 1, 9), I(M, 1, 4), tag="int64"),
    R("divide", I(M, 1, 9, "int32"), I(M, 1, 4, "int32"), tag="int32"),
    R("add", F(M), 2.5, tag="scalar"), R("add", I(M), 3, tag="int_scalar"),
    R("add", I(M), 2.5, tag="int_float_scalar"), R("multiply", B(M), I(M), tag="bool_int"),
    R("add", I(M, 0, 5, "int32"), I(M), tag="int32_int64"),
    R("floor_divide", I(M, -9, 9), I(M, 1, 4)), R("floor_divide", F(M), F(M, 0.5, 2), tag="f32",
                                                  grad=False),
    R("mod", I(M, -9, 9), I(M, 1, 4)), R("mod", F(M), F(M, 0.5, 2), tag="f32"),
    R("remainder", F(M), 1.5), R("floor_mod", I(M, -9, 9), 4),
    R("pow", F(M, 0.5, 2), F(M, -1, 2)), R("pow", F(M), 2, tag="int_exponent"),
    R("pow", I(M), 2, tag="int"), R("pow_op", F(M, 0.5, 2), 1.5),
    R("heaviside", F(M), F(M), grad=False), R("nextafter", F(M), F(M), grad=False),
    R("ldexp", F(M), I(M, -2, 3), grad=False), R("gcd", I(M, 1, 30), I(M, 1, 30)),
    R("lcm", I(M, 1, 12), I(M, 1, 12)), R("divide_no_nan", F(M), F(M)),
    R("polygamma", F(M, 1.2, 3.0), 1), R("round", F(M), decimals=1, tag="decimals", grad=False),
    R("logit", UNIT, eps=0.2, tag="eps"), R("clip", F(M), -0.5, 0.7, bf16=True),
    R("clip", F(M), min=-0.5, tag="min_only"),
    R("scale", F(M), 2.0, 0.5, bf16=True), R("scale", F(M), 2.0, 0.5, False, tag="bias_first"),
    R("stanh", F(M), 0.5, 1.2, tag="args"),
    R("addmm", F((3, 2)), F((3, 4)), F((4, 2)), beta=0.5, alpha=2.0),
    R("inner", F((3, 4)), F((2, 4))), R("outer", F(V), F((4,))),
    R("dot", F(V), F(V)), R("dot", F(M), F(M), tag="2d"), R("kron", F((2, 3)), F((2, 2))),
    R("cross", F((4, 3)), F((4, 3))), R("cross", F((3, 5)), F((3, 5)), axis=0, tag="axis"),
    R("trace", F((4, 4))), R("trace", F(S), offset=1, axis1=1, axis2=2, tag="axes"),
    R("lerp", F(M), F(M), 0.3, bf16=True), R("lerp", F(M), F(M), F(M, 0, 1), tag="tensor_weight"),
    R("nan_to_num", F(M)),
    R("sum", F(S), bf16=True), R("sum", F(S), axis=1, keepdim=True, tag="axis_keep"),
    R("sum", F(S), axis=[0, 2], tag="axes"), R("sum", B(M), tag="bool"),
    R("sum", I(M, 0, 5, "int32"), tag="int32"), R("sum", F(S), keepdim=True, tag="keep_all"),
    R("sum", F(M), dtype="float64", tag="dtype"),
    R("mean", F(S), bf16=True), R("mean", F(S), axis=-1, keepdim=True, tag="axis"),
    R("mean", I(M), tag="int64"),
    R("prod", F(M, 0.5, 1.5), bf16=True), R("prod", F(S, 0.5, 1.5), axis=1, tag="axis"),
    R("prod", I(M, 1, 3, "int32"), tag="int32"),
    R("max", F(S), bf16=True), R("max", F(S), axis=1, tag="axis"),
    R("max", F(S), axis=[0, 2], keepdim=True, tag="axes_keep"),
    R("min", F(S)), R("min", F(S), axis=-1, keepdim=True, tag="axis"),
    R("amax", F(S), axis=1), R("amin", F(S), axis=0),
    R("nansum", F(M)), R("nanmean", F(M), axis=1),
    R("count_nonzero", I(M, 0, 2)), R("count_nonzero", I(S, 0, 2), axis=1, keepdim=True,
                                      tag="axis"),
    R("logsumexp", F(S), bf16=True), R("logsumexp", F(S), axis=1, keepdim=True, tag="axis"),
    R("cumsum", F(S), axis=1, bf16=True), R("cumsum", F(M), tag="flat"),
    R("cumsum", I(M, 0, 5, "int32"), axis=0, tag="int32"),
    R("cumprod", F(M, 0.5, 1.5), dim=1), R("cumprod", F(M, 0.5, 1.5), tag="flat"),
    R("cummax", F(M), axis=1), R("cummax", I(M, 0, 3), axis=0, tag="ties"),
    R("cummin", F(M), axis=0), R("logcumsumexp", F(M), axis=1),
    R("diff", F(M)), R("diff", F(M), n=2, axis=0, tag="n2"),
    R("diff", F(M), axis=1, prepend=F((3, 1)), append=F((3, 2)), tag="pad"),
    R("isnan", F(M)), R("isinf", F(M)), R("isfinite", F(M)), R("isneginf", F(M)),
    R("isposinf", F(M)), R("isreal", F(M)), R("signbit", F(M)),
    R("isclose", F(M), F(M)), R("allclose", F(M), F(M)), R("equal_all", I(M), I(M)),
    R("any", B(M)), R("any", B(S), axis=1, tag="axis"), R("all", B(M)),
    R("all", B(S), axis=[0, 1], keepdim=True, tag="axes"),
    R("broadcast_shape", [2, 1, 3], [4, 3]),
    R("std", F(S), bf16=True), R("std", F(S), axis=1, unbiased=False, keepdim=True, tag="axis"),
    R("var", F(S), bf16=True), R("var", F(S), axis=[0, 2], tag="axes"),
    R("trapezoid", F(M)), R("trapezoid", F(M), dx=0.5, axis=0, tag="dx"),
    R("trapezoid", F(M), x=F(M), tag="x"),
    R("cumulative_trapezoid", F(M)), R("cumulative_trapezoid", F(M), x=F(M), tag="x"),
    R("renorm", F(S), 2.0, 1, 1.5), R("vander", F((4,))), R("vander", F((4,)), 3, True,
                                                              tag="n_increasing"),
    R("tensordot", F(S), F((3, 4, 2))), R("tensordot", F(S), F((4, 2)), axes=[[2], [0]],
                                          tag="axes"),
    R("add_n", [F(M), F(M), F(M)]), R("gammainc", F(M, 0.5, 3), F(M, 0.5, 3), grad=False),
    R("gammaincc", F(M, 0.5, 3), F(M, 0.5, 3), grad=False),
    R("multigammaln", F(M, 2.5, 4.0), 2), R("frexp", F(M), grad=False),
    R("combinations", F((4,))), R("combinations", F((4,)), 3, True, tag="replacement"),
    R("multiplex", [F(M), F(M)], I((3, 1), 0, 2), grad=False),
    R("increment", F((1,)), 2.0, grad=False), R("angle", F(M), grad=False),
    R("imag", F(M), grad=False),
    # logic
    R("equal", I(M), I(M)), R("equal", F(M), 0.5, tag="scalar"), R("not_equal", I(M), I(M)),
    R("greater_than", F(M), F(M)), R("greater_equal", I(M), 2), R("less_than", F(M), F(M)),
    R("less_equal", I(M), I(M)), R("logical_and", B(M), B(M)), R("logical_or", B(M), B(M)),
    R("logical_xor", B(M), B(M)), R("logical_not", B(M)), R("logical_and", F(M), F(M),
                                                            tag="float"),
    R("bitwise_and", I(M, 0, 16), I(M, 0, 16)), R("bitwise_or", I(M, 0, 16), I(M, 0, 16)),
    R("bitwise_xor", I(M, 0, 16), I(M, 0, 16)), R("bitwise_not", I(M, -8, 8)),
    R("bitwise_left_shift", I(M, 0, 16), I(M, 0, 3)),
    R("bitwise_right_shift", I(M, 0, 64), I(M, 0, 3)), R("bitwise_and", B(M), B(M), tag="bool"),
    # search
    R("argmax", F(S), bf16=True), R("argmax", F(S), axis=1, keepdim=True, tag="axis"),
    R("argmax", F(S), keepdim=True, tag="keep_all"), R("argmin", F(S), axis=-1),
    R("argmin", F(S), dtype="int32", tag="int32"),
    R("argsort", F(S)), R("argsort", F(S), axis=0, descending=True, tag="descending"),
    R("argsort", I((12,), 0, 3), tag="ties"),
    R("sort", F(S), bf16=True), R("sort", F(S), axis=1, descending=True, tag="descending"),
    R("topk", F((3, 7)), 3, bf16=True), R("topk", F((3, 7)), 2, axis=0, largest=False,
                                          tag="smallest"),
    R("kthvalue", F((3, 7)), 3), R("kthvalue", F((3, 7)), 2, axis=0, keepdim=True, tag="axis"),
    R("mode", I((3, 9), 0, 3)), R("mode", I((4, 6), 0, 3), axis=0, tag="axis"),
    R("searchsorted", F((6,), sort=True), F((2, 3)), grad=False),
    R("searchsorted", I((6,), 0, 9, sort=True), I((4,), 0, 9), right=True, out_int32=True,
      tag="right"),
    R("searchsorted", F((2, 6), sort=True), F((2, 3)), grad=False, tag="batched"),
    R("bucketize", F((2, 3)), F((6,), sort=True), grad=False),
    R("median", F((3, 6))), R("median", F((3, 7)), axis=1, tag="odd"),
    R("median", F((3, 6)), axis=1, keepdim=True, mode="min", tag="min"),
    R("nanmedian", F((3, 6)), axis=1), R("quantile", F((3, 6)), 0.3),
    R("quantile", F((3, 6)), 0.75, axis=1, keepdim=True, tag="axis"),
    R("quantile", F(S), 0.5, axis=(0, 2), tag="axes"),
    R("nanquantile", F((3, 6)), 0.4, axis=0),
    R("histogram", F((20,)), bins=5, grad=False),
    R("histogram", F((20,)), bins=4, min=-1, max=1, tag="range", grad=False),
    R("histogram", F((20,)), bins=4, weight=F((20,), 0, 1), tag="weight", grad=False),
    R("histogram", F((20,)), bins=4, density=True, tag="density", grad=False),
    R("histogramdd", F((20, 2)), bins=3, grad=False),
    R("bincount", I((12,), 0, 6)), R("bincount", I((12,), 0, 6), weights=F((12,)), minlength=8,
                                     tag="weights", grad=False),
    # linalg
    R("matmul", F(M), F((4, 2)), bf16=True), R("matmul", F(S), F((4, 2)), tag="batched"),
    R("matmul", F((3, 2)), F((3, 4)), transpose_x=True, tag="transpose_x"),
    R("matmul", F(M), F((2, 4)), transpose_y=True, tag="transpose_y"),
    R("matmul", F(V), F((5, 2)), tag="vector"), R("mm", F(M), F((4, 2))),
    R("bmm", F(S), F((2, 4, 3)), bf16=True), R("mv", F(M), F((4,))),
    R("norm", F(S), bf16=True), R("norm", F(M), p=1, axis=1, tag="p1"),
    R("norm", F(M), p="fro", axis=[0, 1], tag="fro"), R("norm", F(M), p=float("inf"), tag="inf"),
    R("norm", F(M), p=3, axis=0, keepdim=True, tag="p3"),
    R("norm", F((3, 3)), p="nuc", axis=[0, 1], tag="nuc", tol="linalg"),
    R("vector_norm", F(S)), R("vector_norm", F(S), p=1, axis=[1, 2], tag="axes"),
    R("matrix_norm", F(S)), R("matrix_norm", F(S), p=1, tag="p1"),
    R("dist", F(M), F(M)), R("dist", F(M), F(M), p=float("inf"), tag="inf"),
    R("dist", F(M), F(M), p=0, tag="p0", grad=False), R("cdist", F((3, 4)), F((5, 4))),
    R("cholesky", SPD(4), tol="linalg"), R("cholesky", SPD(4), upper=True, tag="upper",
                                           tol="linalg"),
    R("cholesky_solve", F((4, 2)), F((4, 4), 0.5, 1.0), grad=False, tol="linalg"),
    R("inv", SPD(4), tol="linalg"), R("inverse", SPD(3), tol="linalg"),
    R("pinv", F((4, 3)), tol="linalg"), R("det", SPD(4), tol="linalg"),
    R("slogdet", SPD(4), tol="linalg"), R("solve", SPD(4), F((4, 2)), tol="linalg"),
    R("solve", SPD(4), F((4,)), tag="vector", tol="linalg"),
    R("triangular_solve", F((4, 4), 1.0, 2.0), F((4, 2)), tol="linalg"),
    R("triangular_solve", F((4, 4), 1.0, 2.0), F((4, 2)), upper=False, transpose=True,
      tag="lower_t", tol="linalg"),
    R("matrix_power", F((3, 3)), 3), R("matrix_rank", F((4, 3))),
    R("cond", SPD(3), tol="linalg"), R("multi_dot", [F((3, 4)), F((4, 5)), F((5, 2))]),
    R("corrcoef", F((3, 6))), R("cov", F((3, 6))), R("cov", F((6, 3)), rowvar=False, ddof=False,
                                                     tag="cols"),
    R("matrix_exp", F((3, 3), -0.5, 0.5), tol="linalg"),
    R("eigvalsh", SPD(4), tol="linalg"), R("svdvals", F((4, 3)), tol="linalg"),
    R("lstsq", F((6, 3)), F((6, 2)), grad=False, tol="linalg"),
    R("householder_product", F((4, 3)), F((3,)), tol="linalg", grad=False),
    R("einsum", "ij,jk->ik", F(M), F((4, 2)), bf16=True),
    R("einsum", "bij,bjk->bik", F(S), F((2, 4, 3)), tag="batched"),
    R("einsum", "ii->i", F((3, 3)), tag="diag"),
    # creation (deterministic)
    R("zeros", [2, 3]), R("zeros", [2], "int32", tag="dtype"), R("ones", [3, 2]),
    R("full", [2, 2], 3), R("full", [2, 2], 1.5, tag="float"), R("full", [2], True, tag="bool"),
    R("empty", [2, 3]), R("zeros_like", F(M)), R("ones_like", I(M)), R("full_like", F(M), 2.5),
    R("empty_like", F(M), dtype="int32"), R("arange", 5), R("arange", 1, 7, 2, tag="range"),
    R("arange", 0.0, 1.0, 0.25, tag="float"), R("linspace", 0, 1, 5),
    R("logspace", 0, 2, 4), R("logspace", 0, 3, 4, 2.0, tag="base"), R("eye", 3),
    R("eye", 2, 4, "int64", tag="rect"), R("diag", F((4,))), R("diag", F((4,)), 1, 5.0,
                                                                tag="padding"),
    R("diag", F((4, 4)), -1, tag="extract"), R("diagflat", F((2, 2)), 1),
    R("diag_embed", F((2, 3))), R("diag_embed", F((2, 3)), 1, 0, 2, tag="dims"),
    R("diagonal", F(S), 0, 1, 2), R("tril", F((4, 4))), R("triu", F((4, 4)), 1),
    R("tril_indices", 4, 3, 0), R("triu_indices", 4, None, 1), R("meshgrid", F((3,)), F((2,))),
    R("assign", F(M), grad=False), R("clone", F(M)), R("clone_detached", F(M), grad=False),
    R("complex", F(M), F(M), grad=False), R("polar", F(M, 0.5, 2), F(M), grad=False),
    R("to_tensor", [1, 2, 3]), R("to_tensor", [1.5, 2.0], tag="float"),
    R("to_tensor", [[1, 2]], "float64", tag="dtype"),
    # manipulation
    R("reshape", F(S), [4, 6], bf16=True), R("reshape", F(S), [0, -1], tag="zero_copy"),
    R("transpose", F(S), [2, 0, 1], bf16=True), R("moveaxis", F(S), 0, 2),
    R("swapaxes", F(S), 0, 2), R("t", F(M)), R("flatten", F(S), bf16=True),
    R("flatten", F(S), 1, 2, tag="range"),
    R("squeeze", F((1, 3, 1)), bf16=True), R("squeeze", F((1, 3, 1)), axis=[0, 1], tag="axes"),
    R("unsqueeze", F(M), [0, 2], bf16=True), R("unsqueeze", F(M), -1, tag="neg"),
    R("concat", [F(M), F((2, 4))], bf16=True), R("concat", [F(M), F((3, 2))], axis=1,
                                                 tag="axis1"),
    R("stack", [F(M), F(M)], bf16=True), R("stack", [F(M), F(M)], axis=2, tag="axis2"),
    R("hstack", [F(M), F((3, 2))]), R("vstack", [F(M), F((2, 4))]),
    R("dstack", [F(M), F(M)]), R("column_stack", [F((3,)), F((3,))]),
    R("row_stack", [F(M), F((1, 4))]),
    R("split", F((6, 4)), 3, bf16=True), R("split", F((6, 4)), [1, -1, 2], axis=0,
                                           tag="sections"),
    R("chunk", F((4, 6)), 2, axis=1), R("tensor_split", F((7, 2)), 3),
    R("tensor_split", F((7, 2)), [2, 5], tag="indices"),
    R("hsplit", F((2, 6)), 3), R("vsplit", F((6, 2)), [2, 4]), R("dsplit", F((2, 2, 4)), 2),
    R("unbind", F(S), 1), R("unstack", F(S)),
    R("tile", F((2, 3)), [2, 1], bf16=True), R("expand", F((3, 1)), [2, 3, 4], bf16=True),
    R("expand", F((3, 1)), [-1, 5], tag="keep"), R("expand_as", F((3, 1)), F((3, 4))),
    R("broadcast_to", F((3, 1)), [3, 4]), R("broadcast_tensors", [F((3, 1)), F((1, 4))]),
    R("cast", F(M), "int32", grad=False), R("cast", F(M), "bfloat16", tag="bf16"),
    R("cast", I(M), "float32", tag="int_to_float"),
    R("gather", F((5, 3)), I((4,), 0, 5), bf16=True), R("gather", F((3, 5)), I((2, 2), 0, 5),
                                                         axis=1, tag="axis_2d"),
    R("gather_nd", F(S), I((4, 2), 0, 2)), R("index_select", F((5, 3)), I((4,), 0, 5), bf16=True),
    R("index_select", F((3, 5)), I((2,), 0, 5), axis=1, tag="axis"),
    R("index_sample", F((3, 5)), I((3, 2), 0, 5)), R("take", F(M), I((5,), -12, 12)),
    R("take", F(M), I((5,), 0, 30), mode="wrap", tag="wrap"),
    R("take", F(M), I((5,), -5, 30), mode="clip", tag="clip"),
    R("take_along_axis", F(S), I((2, 3, 2), 0, 4), 2, bf16=True),
    R("put_along_axis", F(M), I((3, 1), 0, 4), F((3, 1)), 1),
    R("put_along_axis", F(M), I((3, 1), 0, 4), 2.0, 1, reduce="add", tag="add", grad=False),
    R("put_along_axis", F(M), I((3, 1), 0, 4), F((3, 1)), 1, reduce="multiply", tag="mul",
      grad=False),
    R("scatter", F((5, 3)), Perm(5, 3), F((3, 3))),
    R("scatter", F((5, 3)), I((4,), 0, 5), F((4, 3)), overwrite=False, tag="add"),
    R("scatter_nd_add", F((4, 3)), I((5, 1), 0, 4), F((5, 3))),
    R("scatter_nd", I((4, 2), 0, 3), F((4,)), [3, 3]),
    R("index_add", F((5, 3)), I((4,), 0, 5), 0, F((4, 3))),
    R("index_put", F((4, 3)), (Perm(4, 2), Perm(3, 2)), F((2,)), grad=False),
    R("index_put", F((4, 3)), (Perm(4, 2),), F((2, 3)), True, tag="accumulate"),
    R("index_fill", F((4, 3)), I((2,), 0, 3), 1, 7.0), R("masked_select", F(M), B(M), grad=False),
    R("masked_fill", F(M), B(M), -1.0, bf16=True), R("masked_scatter", F(M), B(M), F((12,))),
    R("where", B(M), F(M), F(M), bf16=True), R("where", B(M), F(M), 0.0, tag="scalar"),
    R("where", B(M), tag="nonzero"), R("nonzero", I(M, 0, 2)),
    R("nonzero", I(M, 0, 2), as_tuple=True, tag="tuple"),
    R("roll", F(M), 1, bf16=True), R("roll", F(M), [1, -1], [0, 1], tag="axes"),
    R("flip", F(S), [0, 2], bf16=True), R("reverse", F(M), 1), R("rot90", F(M)),
    R("rot90", F(S), 2, [1, 2], tag="k2"), R("repeat_interleave", F(M), 2, 0),
    R("repeat_interleave", F((3,)), I((3,), 1, 3), tag="tensor"),
    R("slice", F(S), [0, 2], [0, 1], [1, 3]), R("strided_slice", F(S), [1, 2], [0, 0], [3, 4],
                                                [2, 2]),
    R("strided_slice", F(S), [2], [3], [0], [-2], tag="negative"),
    R("crop", F(S), [1, 2, 2], [1, 0, 1]), R("shard_index", I((4, 1), 0, 20), 20, 2, 1),
    R("unique", I((12,), 0, 5)), R("unique", I((12,), 0, 5), True, True, True, tag="all"),
    R("unique_consecutive", I((12,), 0, 3)),
    R("unique_consecutive", I((12,), 0, 3), True, True, tag="all"),
    R("as_complex", F((3, 2)), grad=False),
    R("view", F(S), [6, 4]), R("view", F(M), "float64", tag="dtype"),
    R("view_as", F(S), F((4, 6))), R("as_strided", F((4, 4)), [2, 2], [4, 1], 1),
    R("atleast_1d", F(())), R("atleast_2d", F((3,))), R("atleast_3d", F((3, 2))),
    R("numel", F(S)), R("shape", F(S)), R("rank", F(S)), R("is_empty", F((0, 2))),
    R("unfold", F((2, 7)), 1, 3, 2), R("unflatten", F((2, 12)), 1, [3, 4]),
    R("diagonal_scatter", F((3, 3)), F((3,))), R("select_scatter", F(M), F((4,)), 0, 1),
    R("slice_scatter", F((4, 6)), F((2, 3)), [0, 1], [1, 0], [3, 6], [1, 2]),
    R("tolist", F(M), grad=False), R("is_tensor", F(M)), R("is_floating_point", F(M)),
    R("is_integer", I(M)), R("is_complex", F(M)),
]

# the mechanical inplace family: each op_ on the first row of its base op
# (forward only: x takes the result; the function returns x)
_INPLACE = ["abs", "acos", "acosh", "addmm", "asin", "asinh", "atan", "atanh", "bitwise_and",
            "bitwise_left_shift", "bitwise_not", "bitwise_or", "bitwise_right_shift",
            "bitwise_xor", "cast", "copysign", "cos", "cosh", "cumprod", "cumsum", "digamma",
            "divide", "equal", "erf", "expm1", "flatten", "floor_divide", "floor_mod", "frac",
            "erfinv", "gammainc", "gammaincc", "gammaln", "gcd", "greater_equal", "greater_than",
            "hypot", "i0", "index_add", "index_put", "lcm", "ldexp", "lerp", "less_equal",
            "less_than", "lgamma", "log", "log10", "log1p", "log2", "logical_and", "logical_not",
            "logical_or", "logical_xor", "logit", "masked_scatter", "mod", "multigammaln",
            "multiply", "nan_to_num", "neg", "not_equal", "polygamma", "pow", "put_along_axis",
            "remainder", "renorm", "sigmoid", "sin", "sinh", "square", "tan", "tanh", "tril",
            "triu", "trunc"]
_first = {}
for _r in ROWS:
    _first.setdefault(_r.name, _r)
INPLACE_ROWS = [dataclasses.replace(_first[_n], name=_n + "_", grad=False, bf16=False, tag="")
                for _n in _INPLACE]
INPLACE_ROWS += [R("t_", F(M), grad=False), R("transpose_", F(S), [1, 2, 0], grad=False),
                 R("reshape_", F(S), [4, 6], grad=False), R("squeeze_", F((1, 3)), grad=False),
                 R("unsqueeze_", F(M), 0, grad=False), R("scatter_", F((5, 3)), Perm(5, 3),
                                                         F((3, 3)), grad=False),
                 R("masked_fill_", F(M), B(M), 2.0, grad=False),
                 R("index_fill_", F((4, 3)), I((2,), 0, 3), 1, 7.0, grad=False)]

# functions whose results are random, or that take or make no tensor of
# values (covered by the semantic tests instead)
NOT_IN_TABLE = {
    "rand", "uniform", "randn", "standard_normal", "normal", "randint", "randint_like",
    "randperm", "bernoulli", "poisson", "multinomial", "gumbel_softmax", "binomial",
    "standard_gamma", "create_parameter", "create_tensor", "top_p_sampling", "svd_lowrank",
    "pad_sequences", "normal_", "uniform_", "cauchy_", "geometric_", "exponential_", "where_",
    "patch_tensor_inplace", "polygamma_impl",
    # decompositions with sign/phase freedom: held by their reconstructions
    "qr", "svd", "eig", "eigh", "eigvals", "lu", "lu_unpack", "pca_lowrank",
    "as_real",
}


# torch's own call forms of the widened methods (ops/_patch.py WIDENED), on
# x = arange(24.).reshape(2, 3, 4): each must give the saved C method's result
TORCH_FORMS = [
    ("transpose", (0, 1), {}), ("transpose", (), {"dim0": 2, "dim1": 0}),
    ("unsqueeze", (1,), {}), ("unsqueeze", (), {"dim": -1}),
    ("gather", (1, torch.tensor([[[0, 1, 0, 2]] * 3] * 2)), {}),
    ("gather", (), {"dim": 2, "index": torch.zeros(2, 3, 1, dtype=torch.int64)}),
    ("index_select", (0, torch.tensor([1, 0])), {}),
    ("index_select", (), {"dim": 2, "index": torch.tensor([3])}),
    ("reshape", (6, 4), {}), ("reshape", ([4, -1],), {}), ("reshape", ((24,),), {}),
    ("reshape", (), {"shape": (3, 8)}),
    ("expand", (5, 2, 3, 4), {}), ("expand", ([2, 3, 4],), {}), ("expand", (-1, 3, 4), {}),
    ("tile", ((2, 1),), {}), ("tile", ([1, 2, 1],), {}), ("tile", (2, 1, 1), {}),
]
