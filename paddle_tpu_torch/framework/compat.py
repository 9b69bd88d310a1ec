"""paddle compatibility names (counterpart of paddle_tpu/framework/compat.py):
check_shape and the CUDA RNG state functions."""
from __future__ import annotations

import torch

from . import random as _random


def check_shape(shape):
    """A shape argument must be a list or tuple of non-negative ints (or
    tensors), or an integer tensor: TypeError or ValueError otherwise."""
    if isinstance(shape, torch.Tensor):
        if shape.is_floating_point() or shape.is_complex() or shape.dtype == torch.bool:
            raise TypeError("shape tensor must be int32/int64")
        return
    if isinstance(shape, (list, tuple)):
        for ele in shape:
            if isinstance(ele, torch.Tensor):
                continue
            if not isinstance(ele, int):
                raise TypeError("All elements in `shape` must be integers")
            if ele < 0:
                raise ValueError("All elements in `shape` must be positive")
        return
    raise TypeError(f"shape must be list/tuple/Tensor, got {type(shape)}")


def get_cuda_rng_state():
    """The framework generators' state in a one-element list (paddle
    returns one state per card)."""
    return [_random.get_rng_state()]


def set_cuda_rng_state(state_list):
    if state_list:
        _random.set_rng_state(state_list[0])


def disable_signal_handler():
    """A no-op: the port installs no signal handlers of its own."""
