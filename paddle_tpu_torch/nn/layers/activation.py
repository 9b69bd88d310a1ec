"""Activation layers (counterpart of paddle_tpu/nn/layers/activation.py)."""
from __future__ import annotations

from ..functional import activation as F
from ..layer import Layer


class Tanh(Layer):
    def forward(self, x):
        return F.tanh(x)
