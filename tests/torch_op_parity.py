"""Running a row of tests/torch_op_table.py through the JAX package and
through the port, and holding the two to the row's tolerance: outputs
(dtype included; integer and bool results exactly) and, for the grad
rows, the gradient of sum(w * out), the JAX package's by jax.grad as
tests/op_test.py takes it."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework.io import tensor_to_numpy

from torch_op_table import TOL, flat_outputs, make_args, resolve, run_port, weights


def _to_paddle(tagged, bf16, leaves=None, values=None):
    """A tagged argument as the JAX package takes it; float tensors come
    from `values` (jax.grad's tracers) when given, and are listed in `leaves`."""
    kind, v = tagged
    if kind == "raw":
        return v
    if kind == "list":
        return type(v)(_to_paddle(t, bf16, leaves, values) for t in v)
    a = np.array(v)
    if a.dtype.kind == "f":
        if bf16:
            a = a.astype(ml_dtypes.bfloat16)
        if leaves is not None:
            leaves.append(a)
        if values is not None:
            return paddle.to_tensor(values.pop(0))
    return paddle.to_tensor(a)


def _np(o):
    if isinstance(o, paddle.Tensor):
        return np.asarray(o._value)
    if isinstance(o, torch.Tensor):
        return tensor_to_numpy(o)
    return o


def run_jax(row, bf16=False, grad=None):
    grad = row.grad if grad is None else grad
    args, kwargs = make_args(row)
    leaves: list = []
    jargs = [_to_paddle(a, bf16, leaves) for a in args]
    jkw = {k: _to_paddle(v, bf16, leaves) for k, v in kwargs.items()}
    fn = resolve(paddle, row.name)
    outs = [_np(o) for o in flat_outputs(fn(*jargs, **jkw))]
    if not (grad and leaves):
        return outs, None

    def pure(*vals):
        vals = list(vals)
        a = [_to_paddle(t, bf16, None, vals) for t in args]
        k = {n: _to_paddle(t, bf16, None, vals) for n, t in kwargs.items()}
        with paddle.no_grad():
            res = flat_outputs(fn(*a, **k))
        acc = 0.0
        for i, o in enumerate(res):
            if isinstance(o, paddle.Tensor) and jnp.issubdtype(o._value.dtype, jnp.floating):
                acc = acc + jnp.sum(o._value.astype(jnp.float32)
                                    * weights(tuple(o._value.shape), i))
        return acc

    # one compile of the whole gradient, not one per primitive of an eager
    # jax.grad; an op that reads its input on the host (masked_scatter's
    # mask) cannot be traced by jit and takes the eager jax.grad
    grad_fn = jax.grad(pure, argnums=tuple(range(len(leaves))))
    vals = [jnp.asarray(v) for v in leaves]
    try:
        g = jax.jit(grad_fn)(*vals)
    except TypeError:  # jax's tracer conversion errors
        g = grad_fn(*vals)
    return outs, [np.asarray(x) for x in g]


def assert_same(got, want, tol, what):
    """One output or gradient of the port (`got`) against the JAX package's."""
    if not isinstance(want, np.ndarray):
        if isinstance(got, torch.Tensor):
            got = got.tolist()
        assert got == want or (isinstance(want, np.generic) and got == want.item()), \
            f"{what}: {got!r} != {want!r}"
        return
    got = np.asarray(got)
    assert got.dtype.name == want.dtype.name, f"{what}: dtype {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.complex128 if want.dtype.kind == "c"
                                              else np.float64),
                                   want.astype(np.complex128 if want.dtype.kind == "c"
                                               else np.float64), err_msg=what, **tol)


def check_row(row, bf16=False):
    """The port on the CPU against the JAX package on one row."""
    ptt.set_device("cpu")
    want, wgrads = run_jax(row, bf16)
    got, ggrads = run_port(ptt, row, "cpu", torch.bfloat16 if bf16 else None)
    kind = "bf16" if bf16 else row.tol
    assert len(got) == len(want), f"{row.id}: {len(got)} outputs != {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, TOL[kind], f"{row.id} output {i}")
    if wgrads is not None:
        assert ggrads is not None, f"{row.id}: the port's outputs carry no gradient"
        for i, (g, w) in enumerate(zip(ggrads, wgrads)):
            g = torch.zeros(w.shape, dtype=torch.float32) if g is None else g.float()
            assert_same(tensor_to_numpy(g), np.asarray(w, np.float32), TOL[kind + "_grad"],
                        f"{row.id} grad {i}")
