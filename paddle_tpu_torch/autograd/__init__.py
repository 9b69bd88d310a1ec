"""Public autograd API (counterpart of paddle_tpu/autograd/__init__.py) on
torch autograd.

`backward` runs torch's engine and fires the backward-end hooks
(core/autograd_engine.py); `grad` fires none (it collects, as the JAX
package's), and takes paddle's `no_grad_vars` (their
gradients are not collected) and raises paddle's error for an unused
input unless `allow_unused`. `PyLayer` is a torch.autograd.Function
underneath: `forward(ctx, ...)` runs without grad, `backward(ctx, *grads)`
returns one gradient per tensor input (or per input that requires grad).
`saved_tensors_hooks` is torch's (the JAX package's is a no-op: jax.vjp
owns its residuals there).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core import autograd_engine
from ..core.state import enable_grad, is_grad_enabled, no_grad, set_grad_enabled

saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "PyLayer", "PyLayerContext", "saved_tensors_hooks"]


def _as_list(ts):
    return [ts] if isinstance(ts, torch.Tensor) else list(ts)


def _seeds(roots, given):
    """One seed per root: the given one, else ones for a root of more than
    one element (the JAX package's rule; torch raises there)."""
    given = [None] * len(roots) if given is None else _as_list(given)
    return [autograd_engine.seed(r, g) for r, g in zip(roots, given)]


def backward(tensors: Sequence[torch.Tensor], grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate into the leaves' .grad."""
    tensors = _as_list(tensors)
    grad_tensors = _seeds(tensors, grad_tensors)
    with autograd_engine.backward_walk():
        torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
         only_inputs=True, allow_unused=False, no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    without touching any .grad. With create_graph the results are part of
    the graph (grad of grad)."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    grad_outputs = _seeds(outputs, grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    skip = {id(t) for t in (no_grad_vars or [])}
    wanted = [t for t in inputs if id(t) not in skip]
    with autograd_engine.backward_walk(collect=True):
        got = torch.autograd.grad(outputs, wanted, grad_outputs, retain_graph=retain_graph,
                                  create_graph=create_graph, allow_unused=True) if wanted else ()
    by_id = {id(t): g for t, g in zip(wanted, got)}
    results = [by_id.get(id(t)) for t in inputs]
    if not allow_unused and any(g is None for g in results):
        raise RuntimeError(
            "One of the differentiated tensors appears unused in the graph; "
            "pass allow_unused=True to return None for it.")
    return results


class _Saved(tuple):
    """ctx.saved_tensor: the saved tensors, readable as an attribute (the
    JAX package's property) or called (paddle's method)."""

    def __call__(self):
        return self


class PyLayerContext:
    """paddle.autograd.PyLayerContext over a torch.autograd.Function ctx."""

    def __init__(self, ctx=None):
        self._ctx = ctx
        self.materialize_grads = True
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._ctx.save_for_backward(*tensors)

    @property
    def saved_tensor(self):
        return _Saved(self._ctx.saved_tensors)

    def saved_tensors(self):
        return tuple(self._ctx.saved_tensors)

    def mark_not_inplace(self, *tensors):
        self.not_inplace_tensors = tensors

    def mark_non_differentiable(self, *tensors):
        self._ctx.mark_non_differentiable(*tensors)

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)
        self._ctx.set_materialize_grads(bool(value))


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kwargs, *args):
        ctx.layer_cls = kwargs.cls
        ctx.pctx = PyLayerContext(ctx)
        ctx.tensor_in = [isinstance(a, torch.Tensor) for a in args]
        ctx.diff_in = [isinstance(a, torch.Tensor) and a.requires_grad for a in args]
        return kwargs.cls.forward(ctx.pctx, *args, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        out = ctx.layer_cls.backward(ctx.pctx, *grads)
        out = (out,) if out is None or isinstance(out, torch.Tensor) else tuple(out)
        slots = ctx.diff_in if len(out) == sum(ctx.diff_in) and len(out) != sum(ctx.tensor_in) \
            else ctx.tensor_in
        if len(out) != sum(slots):
            raise RuntimeError(f"{ctx.layer_cls.__name__}.backward returned {len(out)} grads for "
                               f"{sum(ctx.tensor_in)} tensor inputs")
        it = iter(out)
        return (None,) + tuple(next(it) if s else None for s in slots)


class PyLayer:
    """A user-defined autograd op: subclass with static forward(ctx, ...)
    and backward(ctx, *grads), call `apply`."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _Function.apply(_Kwargs(kwargs, cls), *args)


class _Kwargs(dict):
    """The keyword arguments of a PyLayer call, carrying the layer class
    into the Function's forward (Function.apply takes positionals only)."""

    def __init__(self, kwargs, cls):
        super().__init__(kwargs)
        self.cls = cls
