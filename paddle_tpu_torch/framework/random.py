"""Seeded generators (paddle.seed).

`seed(s)` fixes the seed; `generator(device)` hands out one explicit
torch.Generator per device, created from that seed on first use. Parameter
init and fresh dropout seeds draw from it, so a run is reproducible from
one integer. Torch's generators give other numbers than jax's threefry
keys from the same seed, so parity tests carry weights across
(utils/convert.py) instead of re-drawing them.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Union

import torch

_seed = 0
_generators: Dict[str, torch.Generator] = {}


def seed(s: int) -> None:
    """Reseed every device's generator."""
    global _seed
    _seed = int(s)
    _generators.clear()


def generator(device: Union[str, torch.device]) -> torch.Generator:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    gen = _generators.get(key)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_seed)
        _generators[key] = gen
    return gen


def get_rng_state() -> dict:
    """The state of every device generator drawn from so far: a recompute
    replay draws the same numbers again from it, and a checkpoint that
    saves it resumes the same draws."""
    return {key: gen.get_state() for key, gen in _generators.items()}


def set_rng_state(state: dict) -> None:
    """Put the generators back to `state` (get_rng_state's): those in it
    take its state, those created since are dropped (the next draw makes
    them anew from the seed, as before they existed)."""
    for key in list(_generators):
        if key not in state:
            del _generators[key]
    for key, st in state.items():
        gen = _generators.get(key)
        if gen is None:
            gen = _generators[key] = torch.Generator(device=torch.device(key))
        gen.set_state(st)


def fresh_int32_seed(device: Union[str, torch.device] = "cpu") -> int:
    """One int32 drawn from the device's generator (the dropout seed a
    call gets when it names none)."""
    gen = generator(device)
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=gen.device).item())


def next_uint32() -> int:
    """One uint32 from the CPU generator: the per-step seed of the
    optimizer's stochastic rounding (counterpart of `Adam._m2_key`,
    paddle_tpu/optimizer/optimizer.py:464-469). Drawn on the host, so a
    step on the card does not wait for the device to hand a seed back."""
    return int(torch.randint(0, 2 ** 32, (1,), dtype=torch.int64, generator=generator("cpu")))


def drawn_for_real():
    """A context in which a draw made while torch.export traces (under its
    fake tensors) is made for real, from the generator's state at that
    point: the exported graph then holds the numbers as a constant, as the
    JAX package's export closes over its key, and does not draw anew from
    the global generator at every run. Outside a trace it does nothing."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    stack = contextlib.ExitStack()
    if detect_fake_mode() is not None:
        stack.enter_context(unset_fake_temporarily())
        stack.enter_context(disable_proxy_modes_tracing())
    return stack


def fold_in(data: int) -> None:
    """Derive each generator's state from its current state and `data`
    (the JAX package's `Generator.fold_in`): deterministic, and different
    for each `data`. The training guardian's rollback restores the
    snapshot's states and folds in the rollback count, so the retried steps
    draw fresh but reproducible dropout instead of replaying the diverged
    draws."""
    for gen in _generators.values():
        s = int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=gen.device).item())
        gen.manual_seed((s ^ (int(data) * 0x9E3779B97F4A7C15)) & (2 ** 63 - 1))
