"""LayerNorm and RMSNorm layers (counterpart of
paddle_tpu/nn/layers/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import layer_norm, rms_norm
from ..initializer import Constant
from ..layer import Layer


class LayerNorm(Layer):
    """Over the trailing `normalized_shape`; weight ones and bias zeros
    unless an attr says otherwise (False: none)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(self._normalized_shape, attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, epsilon={self.epsilon}"
