"""Activation layers (counterpart of paddle_tpu/nn/layers/activation.py)."""
from __future__ import annotations

from ..functional import activation as F
from ..layer import Layer


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Tanh(Layer):
    def forward(self, x):
        return F.tanh(x)


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)
