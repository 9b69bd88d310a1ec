"""Pooling layers (counterpart of paddle_tpu/nn/layers/pooling.py): each
calls its functional with the arguments it was built with."""
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

AdaptiveMaxPool1D = _adaptive_pool_layer("adaptive_max_pool1d")
AdaptiveMaxPool2D = _adaptive_pool_layer("adaptive_max_pool2d")
AdaptiveMaxPool3D = _adaptive_pool_layer("adaptive_max_pool3d")


def _unpool_layer(n, default_format):
    class _Unpool(Layer):
        def __init__(self, kernel_size, stride=None, padding=0, data_format=default_format,
                     output_size=None, name=None):
            super().__init__()
            self.args = (kernel_size, stride, padding, data_format, output_size)

        def forward(self, x, indices):
            k, s, p, df, osz = self.args
            return getattr(F, f"max_unpool{n}d")(x, indices, k, s, p, data_format=df,
                                                 output_size=osz)

    _Unpool.__name__ = _Unpool.__qualname__ = f"MaxUnPool{n}D"
    return _Unpool


MaxUnPool1D = _unpool_layer(1, "NCL")
MaxUnPool2D = _unpool_layer(2, "NCHW")
MaxUnPool3D = _unpool_layer(3, "NCDHW")


def _fractional_layer(n):
    class _Fractional(Layer):
        def __init__(self, output_size, kernel_size=None, random_u=None, return_mask=False,
                     name=None):
            super().__init__()
            self.args = (output_size, kernel_size, random_u, return_mask)

        def forward(self, x):
            return getattr(F, f"fractional_max_pool{n}d")(x, *self.args)

    _Fractional.__name__ = _Fractional.__qualname__ = f"FractionalMaxPool{n}D"
    return _Fractional


FractionalMaxPool2D = _fractional_layer(2)
FractionalMaxPool3D = _fractional_layer(3)
