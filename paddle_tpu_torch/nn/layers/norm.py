"""Batch norm, LayerNorm and RMSNorm layers (counterpart of
paddle_tpu/nn/layers/norm.py). SyncBatchNorm waits for the distributed
slice."""
from __future__ import annotations

import torch
from torch import nn

from ...framework import device as _device
from .. import functional as F
from ..functional.norm import batch_norm, layer_norm, rms_norm
from ..initializer import Constant
from ..layer import Layer


class _BatchNormBase(Layer):
    """Weight ones and bias zeros (False: none); f32 buffers `_mean`
    (zeros) and `_variance` (ones), updated in training by
    functional.batch_norm with paddle's momentum (0.9 weighs the old
    value)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter([num_features], attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True,
                                          default_initializer=Constant(0.0))
        dev = _device.get_device()
        self.register_buffer("_mean", torch.zeros(num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(num_features, dtype=torch.float32, device=dev))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, weight=self.weight, bias=self.bias,
                          training=self.training, momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format, use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return (f"num_features={self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    """The legacy paddle.nn.BatchNorm: an activation (a functional's name)
    after the norm."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5, param_attr=None,
                 bias_attr=None, data_layout="NCHW", use_global_stats=None, **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr, bias_attr, data_layout,
                         use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


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
