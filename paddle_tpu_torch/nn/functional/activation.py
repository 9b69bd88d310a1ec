"""Activations (counterpart of paddle_tpu/nn/functional/activation.py).
log_softmax is the black-listed op "log_softmax" (f32 under AMP O1); the
others are on no AMP list and run in their input's dtype."""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs
from ...framework import dtype as _dtype


def relu(x, name=None):
    return TF.relu(x)


def tanh(x, name=None):
    return torch.tanh(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def silu(x, name=None):
    return TF.silu(x)



def gelu(x, approximate=False, name=None):
    """Exact erf GELU by default (jax.nn.gelu(approximate=False)); the
    tanh form with approximate=True."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def log_softmax(x, axis=-1, dtype=None, name=None):
    """x cast to `dtype` first when one is given."""
    if dtype is not None:
        x = x.to(_dtype.convert_dtype(dtype))
    (x,) = amp_cast_inputs("log_softmax", [x])
    return torch.log_softmax(x, dim=axis)
