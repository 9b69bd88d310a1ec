"""Norm layers (counterpart of paddle_tpu/nn/layers/norm.py): batch norm,
LayerNorm, RMSNorm, GroupNorm, InstanceNorm1D/2D/3D, LocalResponseNorm
and SpectralNorm. SyncBatchNorm waits for the distributed slice: making
one raises."""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core import record as _record
from ...framework import device as _device
from .. import functional as F
from ..functional.norm import batch_norm, layer_norm, rms_norm
from ..initializer import Constant, Normal
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
        dev = _device.current_device()
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


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the global batch of every rank: the distributed slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("SyncBatchNorm belongs to the port's distributed slice, which "
                                  "is not ported yet")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError("SyncBatchNorm belongs to the port's distributed slice, which "
                                  "is not ported yet")


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter([num_channels], attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr, is_bias=True,
                                          default_initializer=Constant(0.0))

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight, self.bias,
                            self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter([num_features], attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True,
                                          default_initializer=Constant(0.0))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """weight / sigma, sigma the largest singular value of the weight
    (axis `dim` first, the rest flattened) by `power_iters` steps of power
    iteration from the vectors weight_u [h] and weight_v [w], N(0, 1)
    parameters that take no gradient."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12, name=None,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.weight_u = self.create_parameter([h], default_initializer=Normal(0.0, 1.0))
        self.weight_u.requires_grad_(False)
        self.weight_v = self.create_parameter([w], default_initializer=Normal(0.0, 1.0))
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        # one op "spectral_norm" of a static capture, as in the JAX package
        return _record.apply("spectral_norm", self._normalized, weight, self.weight_u,
                             self.weight_v)

    def _normalized(self, weight, u, v):
        wm = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim], -1)
        for _ in range(self._power_iters):
            v = wm.t() @ u
            v = v / (torch.linalg.vector_norm(v) + self._epsilon)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + self._epsilon)
        return weight / (u @ wm @ v)
