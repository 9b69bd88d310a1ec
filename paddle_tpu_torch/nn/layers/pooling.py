"""Pooling layers (counterpart of paddle_tpu/nn/layers/pooling.py:8-48):
each calls its functional with the arguments it was built with."""
from __future__ import annotations

from .. import functional as F
from ..layer import Layer


def _pool_layer(fn_name):
    class _Pool(Layer):
        def __init__(self, kernel_size=None, stride=None, padding=0, **kwargs):
            super().__init__()
            self.kernel_size = kernel_size
            self.stride = stride
            self.padding = padding
            self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return getattr(F, fn_name)(x, self.kernel_size, self.stride, self.padding, **self.kwargs)

    _Pool.__name__ = _Pool.__qualname__ = fn_name.title().replace("_", "")
    return _Pool


MaxPool1D = _pool_layer("max_pool1d")
MaxPool2D = _pool_layer("max_pool2d")
MaxPool3D = _pool_layer("max_pool3d")
AvgPool1D = _pool_layer("avg_pool1d")
AvgPool2D = _pool_layer("avg_pool2d")
AvgPool3D = _pool_layer("avg_pool3d")


def _adaptive_pool_layer(fn_name):
    class _Pool(Layer):
        def __init__(self, output_size, **kwargs):
            super().__init__()
            self.output_size = output_size
            self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return getattr(F, fn_name)(x, self.output_size, **self.kwargs)

    _Pool.__name__ = _Pool.__qualname__ = fn_name.title().replace("_", "")
    return _Pool


AdaptiveAvgPool1D = _adaptive_pool_layer("adaptive_avg_pool1d")
AdaptiveAvgPool2D = _adaptive_pool_layer("adaptive_avg_pool2d")
AdaptiveAvgPool3D = _adaptive_pool_layer("adaptive_avg_pool3d")
