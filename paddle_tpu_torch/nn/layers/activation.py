"""Activation layers (counterpart of paddle_tpu/nn/layers/activation.py):
each calls its functional with the arguments it was built with."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from ..layer import Layer


def _simple(cls_name, fn_name):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._args = args
            self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return getattr(F, fn_name)(x, *self._args, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = cls_name
    return _Act


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
GELU = _simple("GELU", "gelu")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
LeakyReLU = _simple("LeakyReLU", "leaky_relu")
ELU = _simple("ELU", "elu")
SELU = _simple("SELU", "selu")
CELU = _simple("CELU", "celu")
Hardtanh = _simple("Hardtanh", "hardtanh")
Hardshrink = _simple("Hardshrink", "hardshrink")
Softshrink = _simple("Softshrink", "softshrink")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardswish = _simple("Hardswish", "hardswish")
Softplus = _simple("Softplus", "softplus")
Softsign = _simple("Softsign", "softsign")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu")
Maxout = _simple("Maxout", "maxout")
GLU = _simple("GLU", "glu")


class RReLU(Layer):
    """Random slopes in training, their mean in eval."""

    def __init__(self, lower=0.125, upper=0.3333333, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class PReLU(Layer):
    """Weight [num_parameters] (one slope, or one per channel), `init` each."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter([num_parameters], attr=weight_attr,
                                            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


class Softmax2D(Layer):
    """Softmax over the channels of a CHW or NCHW input."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(f"Softmax2D expects 3-D or 4-D input, got {x.ndim}-D")
        return F.softmax(x, axis=-3)
