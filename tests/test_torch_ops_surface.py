"""The port's op surface as a whole: every public op of the JAX package's
eight op modules, its linalg namespace, its metric module and its
Tensor's attributes exists in the port or is on the explicit raise list;
the `*_` inplace family against the JAX package; the three method rules
(a paddle-only method is the function, a widened method's torch form is
torch's result, a conflict keeps torch's meaning)."""
import importlib

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.tensor import LATER_SLICE
from paddle_tpu_torch.ops import _patch

from torch_op_parity import assert_same, run_jax
from torch_op_table import (INPLACE_ROWS, NOT_IN_TABLE, ROWS, TOL, TORCH_FORMS, make_args,
                            resolve, to_torch)

OP_MODULES = ("creation", "math", "manipulation", "logic", "search", "linalg", "einsum",
              "inplace")


def _own_functions(mod):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and callable(v) and not isinstance(v, type)
                  and getattr(v, "__module__", None) == mod.__name__)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


@pytest.mark.parametrize("module", OP_MODULES)
def test_every_op_of_the_module_is_ported(module):
    jmod = importlib.import_module(f"paddle_tpu.ops.{module}")
    tmod = importlib.import_module(f"paddle_tpu_torch.ops.{module}")
    missing = [n for n in _own_functions(jmod) if not callable(getattr(tmod, n, None))]
    assert not missing, f"{module}: not in the port: {missing}"


def test_op_counts_and_table_coverage():
    """423 op functions in the eight modules; each is in the parity table
    or named in NOT_IN_TABLE (random, decompositions: the semantic tests)."""
    names = {n for m in OP_MODULES
             for n in _own_functions(importlib.import_module(f"paddle_tpu.ops.{m}"))}
    assert len(names) == 423
    tabled = {r.name for r in ROWS} | {r.name for r in INPLACE_ROWS}
    untested = sorted(names - tabled - NOT_IN_TABLE)
    assert not untested, f"ops in neither the table nor NOT_IN_TABLE: {untested}"


def test_linalg_namespace_and_metric_are_ported():
    jl = [n for n in dir(paddle.linalg) if not n.startswith("_")]
    assert len(jl) == 32
    assert [n for n in jl if not callable(getattr(ptt.linalg, n, None))] == []
    jm = [n for n, v in vars(paddle.metric).items()
          if not n.startswith("_") and getattr(v, "__module__", None) == "paddle_tpu.metric"]
    assert sorted(jm) == ["Accuracy", "Auc", "Metric", "Precision", "Recall", "accuracy"]
    assert [n for n in jm if not hasattr(ptt.metric, n)] == []


def test_top_level_exports():
    for name in ("Tensor", "to_tensor", "zeros", "matmul", "concat", "reshape", "argmax",
                 "equal", "cast", "sum", "einsum", "linalg", "autograd", "PyLayer", "grad",
                 "no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
                 "in_dynamic_mode", "disable_static", "enable_static", "metric", "abs_",
                 "set_printoptions", "bmm", "cdist", "inverse", "norm"):
        assert hasattr(ptt, name), name
    assert ptt.Tensor is torch.Tensor and ptt.in_dynamic_mode()


def test_tensor_attributes_are_ported_or_on_the_raise_list():
    """Every attribute of the JAX package's Tensor but its private storage
    fields (and `builtins_max`, the builtin `max` its search module
    re-exports) exists on torch.Tensor, or raises naming a later slice."""
    private = {n for n in dir(paddle.Tensor) if n.startswith("_")} - {"_dist_attr"}
    names = set(dir(paddle.Tensor)) - private - {"builtins_max"}
    missing = sorted(n for n in names if not hasattr(torch.Tensor, n))
    assert missing == []
    x = torch.ones(2)
    for name in LATER_SLICE:
        with pytest.raises(NotImplementedError, match="slice"):
            attr = getattr(x, name)
            attr()


def test_raise_list_holds_nothing_else():
    assert LATER_SLICE == {"process_mesh": "distributed", "placements": "distributed",
                           "is_dist": "distributed", "_dist_attr": "distributed"}
    assert {"stft", "istft"} <= set(_patch.CONFLICTS)  # torch's stay; paddle's: signal slice


@pytest.mark.parametrize("row", INPLACE_ROWS, ids=[r.id for r in INPLACE_ROWS])
def test_inplace_op_matches_jax(row):
    """x_ = op_(x, ...) is x, holding the JAX package's result (a
    comparison's bool included)."""
    want, _ = run_jax(row, grad=False)
    args, kwargs = make_args(row)
    targs = [to_torch(a, "cpu") for a in args]
    out = resolve(ptt, row.name)(*targs, **{k: to_torch(v, "cpu") for k, v in kwargs.items()})
    assert out is targs[0]
    assert_same(out, want[0], TOL["f32"], row.id)


def _method_cases():
    """Rows whose op is a method in both packages: not a conflict, and not
    one of the JAX Tensor's own methods (numel, clone, ... are not its op
    functions there either)."""
    cases = []
    for row in ROWS:
        jm = getattr(paddle.Tensor, row.name, None)
        if row.args and type(row.args[0]).__name__ in ("F", "I", "B", "SPD") \
                and row.name not in _patch.CONFLICTS and hasattr(torch.Tensor, row.name) \
                and getattr(jm, "__module__", None) != "paddle_tpu.core.tensor":
            cases.append(row)
    return cases


METHOD_ROWS = _method_cases()


@pytest.mark.parametrize("row", METHOD_ROWS, ids=[r.id for r in METHOD_ROWS])
def test_method_form(row):
    """x.op(*rest) against ptt.op(x, *rest): paddle-only and widened methods
    must take the call and give the function's result; a method torch
    shares may refuse paddle's form (torch's stays) but may not give
    another result (that would be a conflict, listed in CONFLICTS)."""
    args, kwargs = make_args(row)
    targs = [to_torch(a, "cpu") for a in args]
    tkw = {k: to_torch(v, "cpu") for k, v in kwargs.items()}
    want = resolve(ptt, row.name)(*targs, **tkw)
    torch_own = row.name in TORCH_NAMES and row.name not in _patch.WIDENED
    try:
        got = getattr(targs[0], row.name)(*targs[1:], **tkw)
    except (TypeError, RuntimeError):
        if torch_own:
            return  # torch refuses paddle's form: not a conflict
        raise
    for g, w in zip(_flat(got), _flat(want)):
        if isinstance(w, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.dtype == w.dtype and g.shape == w.shape, \
                (row.id, g, w)
            assert torch.equal(g, w) or torch.allclose(g.double(), w.double(), **TOL["f32"],
                                                       equal_nan=True), row.id
        else:
            assert g == w, row.id


def _flat(o):
    return [y for x in o for y in _flat(x)] if isinstance(o, (list, tuple)) else [o]


# torch.Tensor's own attribute names (those paddle shares keep torch's meaning)
TORCH_NAMES = set(_patch.TORCH_NAMES)



@pytest.mark.parametrize("name,args,kwargs", TORCH_FORMS,
                         ids=[f"{n}{a}" for n, a, _ in TORCH_FORMS])
def test_widened_method_keeps_torch_forms(name, args, kwargs):
    x = torch.arange(24.0).reshape(2, 3, 4)
    got = getattr(x, name)(*args, **kwargs)
    want = _patch.TORCH_METHODS[name](x, *args, **kwargs)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_widened_methods_take_paddle_forms():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert x.transpose([2, 0, 1]).shape == (4, 2, 3)
    assert x.transpose(perm=[1, 0, 2]).shape == (3, 2, 4)
    assert x.unsqueeze([0, 2]).shape == (1, 2, 1, 3, 4)
    i = torch.tensor([2, 0])
    assert torch.equal(x.gather(i, axis=1), x[:, [2, 0]])
    assert torch.equal(x.index_select(i, axis=2), x[:, :, [2, 0]])
    assert x.reshape([0, -1]).shape == (2, 12) and x.reshape(torch.tensor([4, 6])).shape == (4, 6)
    assert x[:, :1].expand(shape=[2, 5, 4]).shape == (2, 5, 4)
    assert x.tile(repeat_times=[1, 2, 1]).shape == (2, 6, 4)
    assert torch.zeros(0, 3).reshape([0, 3]).shape == (0, 3)  # torch accepts: torch's


def test_numpy_widened():
    x = torch.arange(6.0)
    a = x.numpy()
    a[0] = 7.0
    assert x[0] == 7.0  # torch's form still shares memory
    y = torch.ones(3, requires_grad=True)
    ya = y.numpy()
    np.testing.assert_array_equal(ya, np.ones(3, np.float32))
    ya[0] = 5.0
    assert float(y[0]) == 1.0  # a copy: writing it cannot change a tracked tensor
    b = torch.ones(2, dtype=torch.bfloat16).numpy()
    assert b.dtype.name == "bfloat16" and float(b[0]) == 1.0
    assert torch.ones(2).numpy(force=True).dtype == np.float32


def test_conflicts_keep_torch_meaning():
    x = torch.tensor([[3.0, 1.0, 2.0], [0.0, 5.0, 4.0]])
    vals, idx = x.max(1)
    assert torch.equal(vals, torch.tensor([3.0, 5.0])) and torch.equal(idx, torch.tensor([0, 1]))
    assert torch.equal(ptt.max(x, 1), vals)
    assert [t.shape[1] for t in torch.arange(6.0).reshape(1, 6).split(2, 1)] == [2, 2, 2]
    assert [t.shape[1] for t in ptt.split(torch.zeros(1, 6), 2, 1)] == [3, 3]
    assert isinstance(x.sort(), tuple) and torch.equal(ptt.sort(x), x.sort().values)
    assert isinstance(x.shape, torch.Size) and callable(x.size) and x.name is None
    assert x.equal(x) is True and ptt.equal(x, x).shape == x.shape
    assert torch.equal(x.sum(0, True), x.sum(dim=0, keepdim=True))
    assert x.view(torch.int32).dtype == torch.int32 and ptt.view(x, "int32")[0, 0] == 3
    assert torch.equal(x.where(x > 1, 0.0), torch.where(x > 1, x, torch.zeros(())))
    u = torch.empty(1000).uniform_()
    assert float(u.min()) >= 0.0
    ptt.seed(0)
    v = ptt.uniform_(torch.empty(1000))
    assert float(v.min()) < -0.5 and float(v.max()) > 0.5
    f = torch.tensor([1.0, 2.0])
    f.greater_equal_(torch.tensor(1.5))
    assert f.dtype == torch.float32  # torch's: the result in x's dtype
    assert ptt.greater_equal_(torch.tensor([1.0, 2.0]), 1.5).dtype == torch.bool
    for name in _patch.CONFLICTS:
        assert name in TORCH_NAMES, f"{name} is not a torch attribute: no conflict"


def test_shared_names_are_classified():
    """The 329 names the two Tensor classes share: 8 widened, the conflicts
    (each with its reason), and the rest the same; a conflict or a widened
    method is a name both classes have."""
    jax_names = {a for a in dir(paddle.Tensor) if not (a.startswith("__") and a.endswith("__"))}
    shared = jax_names & TORCH_NAMES
    assert len(shared) == 329
    assert set(_patch.CONFLICTS) <= shared and set(_patch.WIDENED) <= shared
    assert not set(_patch.CONFLICTS) & set(_patch.WIDENED)
    assert all(isinstance(r, str) and r for r in _patch.CONFLICTS.values())
    same = shared - set(_patch.CONFLICTS) - set(_patch.WIDENED)
    assert len(same) + len(_patch.CONFLICTS) + len(_patch.WIDENED) == 329
