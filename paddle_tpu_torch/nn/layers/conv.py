"""Conv1D/2D/3D (counterpart of paddle_tpu/nn/layers/conv.py:21-98).

The weight is [out, in/groups, *kernel] in both packages (it crosses
utils/convert.py as it is), drawn from Uniform(-k, k) with
k = 1/sqrt(fan_in), fan_in = in/groups * prod(kernel); the bias is zeros
(bias_attr=False: none). The transposed layers' weight is [in,
out/groups, *kernel] (torch's conv_transpose layout, and the JAX
package's), drawn as the JAX package draws it: U(-k, k) with the same
fan_in = in/groups * prod(kernel) (torch's own init differs); the bias
zeros.
"""
from __future__ import annotations

import math

from .. import functional as F
from ..initializer import Constant, Uniform
from ..layer import Layer

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transposed=False, output_padding=0):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode {padding_mode!r} is not ported (zeros only)")
        self._n = n
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        k = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        shape = ([in_channels, out_channels // groups] if transposed
                 else [out_channels, in_channels // groups])
        self.weight = self.create_parameter([*shape, *self._kernel_size], attr=weight_attr,
                                            default_initializer=Uniform(-k, k))
        self.bias = self.create_parameter([out_channels], attr=bias_attr, is_bias=True,
                                          default_initializer=Constant(0.0))

    def forward(self, x):
        return _CONV[self._n](x, self.weight, self.bias, self._stride, self._padding,
                              self._dilation, self._groups, self._data_format)

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, kernel_size={self._kernel_size}, "
                f"stride={self._stride}, padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format)


_CONV_T = {1: F.conv1d_transpose, 2: F.conv2d_transpose, 3: F.conv3d_transpose}


class _ConvTransposeNd(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride, padding, output_padding,
                 groups, dilation, weight_attr, bias_attr, data_format):
        super().__init__(in_channels, out_channels, kernel_size, n, stride, padding, dilation,
                         groups, "zeros", weight_attr, bias_attr, data_format, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return _CONV_T[self._n](x, self.weight, self.bias, self._stride, self._padding,
                                self._output_padding, self._groups, self._dilation, output_size,
                                self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding,
                         output_padding, groups, dilation, weight_attr, bias_attr, data_format)


class Conv2DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding,
                         output_padding, groups, dilation, weight_attr, bias_attr, data_format)


class Conv3DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding,
                         output_padding, groups, dilation, weight_attr, bias_attr, data_format)
