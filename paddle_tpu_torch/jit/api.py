"""paddle.jit.to_static (counterpart of paddle_tpu/jit/api.py:93-562).

The JAX package records one eager run of the function and then runs it
as one compiled XLA program. Here the captured function runs eagerly: a
call returns what the function returns, a step that holds
`loss.backward(); opt.step(); opt.clear_grad()` works inside it, and a
Layer passed in keeps its own forward bound. Capturing the step into a
CUDA graph is later work.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

class StaticFunction:
    """The callable to_static returns for a function."""

    def __init__(self, fn: Callable):
        self._fn = fn
        functools.update_wrapper(self, fn, updated=[])

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def enable_to_static(enable_to_static_bool) -> None:
    """paddle.jit.enable_to_static, accepted so callers run: a captured
    function runs eagerly either way, so there is nothing to switch."""


def to_static(function=None, input_spec=None, build_strategy=None, backend=None,
              full_graph=True):
    """A decorator or a call, on a function or a Layer (whose forward is
    replaced by a StaticFunction of the forward it had). input_spec,
    build_strategy, backend and full_graph are paddle's names, accepted
    and unused: the captured function runs eagerly."""

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            orig_forward = fn.forward  # bound before the replacement
            fn.forward = StaticFunction(orig_forward)
            return fn
        return StaticFunction(fn)

    return decorate(function) if function is not None else decorate
