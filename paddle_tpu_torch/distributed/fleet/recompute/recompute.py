"""Activation recompute (gradient checkpointing), the counterpart of
paddle_tpu/distributed/fleet/recompute/recompute.py.

`recompute(function, *args)` runs `function` under
torch.utils.checkpoint (non-reentrant): the forward keeps only the
segment's inputs, and the backward runs the segment again to rebuild what
it needs. A decoder layer recomputed this way launches its flash forward
kernel twice per step, once in the forward and once in the replay.

The replay must compute what the forward computed. torch's checkpoint
restores torch's global RNG states and its autocast state, neither of
which the framework uses, so this module restores the framework's own:
- the framework generators (framework/random.py): a dropout with no
  explicit seed draws it from them, so the replay draws the same seeds
  (the same masks) and leaves the generators as it found them, advanced
  once per segment in all, as the JAX package's replay of one jaxpr does;
- the framework's AMP state (amp.auto_cast): the backward usually runs
  outside `auto_cast`, and the replay casts as the forward did.
State writes inside a segment (a batch norm's running statistics) happen
in the replay again, as in torch's checkpoint.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

from ....amp import _set_amp_state, get_amp_state
from ....framework import random as _random


def recompute(function: Callable, *args, **kwargs):
    """paddle.distributed.fleet.utils.recompute. `use_reentrant` is
    accepted and ignored (always the non-reentrant form);
    `preserve_rng_state` passes to torch's checkpoint (the framework
    generators are always restored). Without grad mode it is a plain call."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    rng_before = _random.get_rng_state()
    amp_state = get_amp_state()
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:  # the forward
            return function(*a, **kw)
        # the replay in the backward: the forward's generators and AMP
        # state, then back to what the backward had
        rng_after = _random.get_rng_state()
        _random.set_rng_state(rng_before)
        amp_prev = _set_amp_state(amp_state)
        try:
            return function(*a, **kw)
        finally:
            _set_amp_state(amp_prev)
            _random.set_rng_state(rng_after)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=preserve, **kwargs)


class _Chunk:
    """One segment of a Sequential: its layers called in turn."""

    def __init__(self, layers):
        self.layers = tuple(layers)

    def __call__(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute a Sequential (or list of layers) in `ctx["segments"]`
    chunks of consecutive layers, each chunk one recomputed segment."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    step = max(1, len(layers) // max(1, segments))
    out = args[0] if len(args) == 1 else args
    for i in range(0, len(layers), step):
        out = recompute(_Chunk(layers[i:i + step]), out)
    return out


def recompute_hybrid(ctx, function, *args, **kwargs):
    """recompute under hybrid parallelism: on one device it is `recompute`
    (`ctx` keys mp_group, offload and partition are accepted; the
    framework generators are restored as above)."""
    if ctx is not None and not isinstance(ctx, dict):
        raise TypeError(f"recompute_hybrid ctx must be a dict, got {type(ctx)}")
    return recompute(function, *args, **kwargs)
