"""paddle.jit.to_static and capture_program (counterpart of
paddle_tpu/jit/api.py:93-562 and :613-663).

The JAX package records one eager run of the function and then runs it
as one compiled XLA program. Here the captured function runs eagerly: a
call returns what the function returns, a step that holds
`loss.backward(); opt.step(); opt.clear_grad()` works inside it, and a
Layer passed in keeps its own forward bound. Capturing the step into a
CUDA graph is later work.

`capture_program` records one eager run into a static Program
(paddle.static), which the Executor replays and the pass pipeline
rewrites.

A call samples the memory watermark at its end, as the JAX package's
compiled step does (profiler.perf_attribution.sample_watermark); it
compiles nothing, so it records no compile-ledger event.
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
        out = self._fn(*args, **kwargs)
        from ..profiler import perf_attribution as _pa

        _pa.sample_watermark(tag="to_static_step")
        return out


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


def capture_program(function, *example_args, feed_names=None):
    """Record `function` (a callable or Layer) as a static Program with no
    model-code changes: one eager run under program_guard with each
    example arg replaced by a static.data feed of its shape and dtype that
    holds the example's values. Returns (program, feed_names, fetch_list)
    for Executor.run and the static.passes pipeline.

    `example_args` are tensors or array-likes; the tensor outputs the
    program recorded become the fetch_list. `feed_names` overrides the
    default arg0..argN names. The dry run's activations other than the
    outputs become meta tensors at the guard's exit
    (Program.release_activations): the Program keeps their shapes and
    dtypes, not a copy of the model's activations."""
    import numpy as np

    from ..core import record
    from ..framework.io import numpy_to_tensor
    from ..static import program as static_program

    names = list(feed_names) if feed_names is not None else [
        f"arg{i}" for i in range(len(example_args))
    ]
    if len(names) != len(example_args):
        raise ValueError(
            f"capture_program: {len(example_args)} example arg(s) but "
            f"{len(names)} feed name(s)"
        )
    main = static_program.Program()
    with static_program.program_guard(main, static_program.Program()):
        feeds = []
        for name, a in zip(names, example_args):
            raw = a if isinstance(a, torch.Tensor) else numpy_to_tensor(np.asarray(a))
            feeds.append(static_program.data(name, list(raw.shape),
                                             str(raw.dtype).replace("torch.", "")))
            # the placeholder carries the EXAMPLE values, not zeros: the
            # dry run computes real activations (value-dependent paths
            # behave as on this input); shapes and dtypes are the same
            with record.suspended():
                feeds[-1].copy_(raw.to(feeds[-1].device))
        out = function(*feeds)
    leaves = []
    stack = [out]
    while stack:
        o = stack.pop()
        if isinstance(o, (list, tuple)):
            stack.extend(reversed(o))
        elif isinstance(o, dict):
            stack.extend(reversed(list(o.values())))
        else:
            leaves.append(o)
    fetch_list = [t for t in leaves if isinstance(t, torch.Tensor) and id(t) in main._id2var]
    if isinstance(function, torch.nn.Module):
        main.name_vars(function.named_parameters())
    return main, names, fetch_list


def not_to_static(fn):
    """paddle.jit.not_to_static: marks `fn` to run as Python under
    to_static (every captured function runs eagerly here, so the mark is
    all there is to it)."""
    fn._paddle_not_to_static = True
    return fn


def ignore_module(modules):
    """paddle.jit.ignore_module: modules whose calls to_static leaves
    alone; accepted, as in the JAX package."""
    return None


def _cond_branches(true_fn, false_fn):
    def run(p, *vals):
        with torch.no_grad():
            take = bool(p.detach().cpu()) if isinstance(p, torch.Tensor) else bool(p)
        return true_fn(*vals) if take else false_fn(*vals)

    return run


def cond(pred, true_fn, false_fn, *operands):
    """true_fn(*operands) where `pred` holds, else false_fn(*operands) (also
    paddle.static.cond): one op "cond" under capture, whose replay reads
    `pred` and runs the branch it picks at every run; the branches'
    own ops are not recorded. `pred` is read on the host."""
    from ..core import record

    pred_t = pred if isinstance(pred, torch.Tensor) else torch.as_tensor(bool(pred))
    return record.apply("cond", _cond_branches(true_fn, false_fn), pred_t, *operands)
