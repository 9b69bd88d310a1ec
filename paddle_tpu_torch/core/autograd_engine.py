"""The public hooks of the JAX package's autograd engine
(paddle_tpu/core/autograd_engine.py:31-85) on torch autograd.

`register_backward_end_hook(fn)` calls fn(completed) at the end of every
backward that accumulates into `.grad` (`Tensor.backward`,
`autograd.backward`); completed is False when the walk raised.
`autograd.grad` collects gradients instead: it fires no hook, and
`grad_collection_active()` is True while it runs, so that per-leaf
observers that treat every backward as a training step (a grad reducer)
can sit it out. The JAX package's tape itself (jax.vjp closures on
GradNodes) has no counterpart: torch records the graph.

`Tensor.backward` takes paddle's `grad_tensor=` (torch's `gradient=`),
and a root of more than one element with no seed is seeded with ones,
as the JAX package and paddle seed it (torch raises there).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import weakref

import torch

_backward_end_hooks: dict = {}
_ids = itertools.count()
_grad_collection_depth = 0


def grad_collection_active() -> bool:
    """True inside `autograd.grad`."""
    return _grad_collection_depth > 0


class _BackwardEndHookHandle:
    __slots__ = ("_key",)

    def __init__(self, key):
        self._key = key

    def remove(self):
        _backward_end_hooks.pop(self._key, None)


def register_backward_end_hook(fn) -> _BackwardEndHookHandle:
    """Call fn(completed: bool) at the end of every training backward. A bound
    method is held weakly (its owner stays collectable); any other
    callable until the handle's `remove()`."""
    entry = weakref.WeakMethod(fn) if hasattr(fn, "__self__") else fn
    key = next(_ids)
    _backward_end_hooks[key] = entry
    return _BackwardEndHookHandle(key)


def _fire(completed: bool) -> None:
    for key, entry in list(_backward_end_hooks.items()):
        fn = entry() if isinstance(entry, weakref.WeakMethod) else entry
        if fn is None:
            _backward_end_hooks.pop(key, None)
        else:
            fn(completed)


@contextlib.contextmanager
def backward_walk(collect: bool = False):
    """Around one backward: the hooks fire after it (completed=False if it
    raised), unless `collect` marks an `autograd.grad` walk."""
    global _grad_collection_depth
    _grad_collection_depth += collect
    completed = False
    try:
        yield
        completed = True
    finally:
        _grad_collection_depth -= collect
        if _backward_end_hooks and not collect:
            _fire(completed)


_torch_backward = torch.Tensor.backward


def seed(root: torch.Tensor, grad):
    """The seed of `root`: `grad` when given, else ones for a root of more
    than one element (torch seeds a one-element root itself)."""
    if grad is None and root.numel() != 1:
        return torch.ones_like(root)
    return grad


@functools.wraps(_torch_backward)
def _backward(self, gradient=None, retain_graph=None, create_graph=False, inputs=None,
              grad_tensor=None):
    gradient = seed(self, gradient if gradient is not None else grad_tensor)
    if not _backward_end_hooks:
        return _torch_backward(self, gradient, retain_graph, create_graph, inputs)
    with backward_walk():
        return _torch_backward(self, gradient, retain_graph, create_graph, inputs)


def install() -> None:
    """Make `Tensor.backward` fire the hooks (torch's result unchanged)."""
    torch.Tensor.backward = _backward
