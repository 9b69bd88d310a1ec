"""Activations of the ERNIE slice (counterpart of
paddle_tpu/nn/functional/activation.py). None is on an AMP list: each
runs in its input's dtype."""
from __future__ import annotations

import torch
from torch.nn import functional as TF


def relu(x, name=None):
    return TF.relu(x)


def tanh(x, name=None):
    return torch.tanh(x)


def gelu(x, approximate=False, name=None):
    """Exact erf GELU by default (jax.nn.gelu(approximate=False)); the
    tanh form with approximate=True."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")
