"""Linear, Embedding and Dropout (counterpart of
paddle_tpu/nn/layers/common.py:16-72).

Linear keeps torch's [out, in] weight (utils/convert.py transposes the
JAX package's [in, out] on the way across) and initializes as paddle's:
the weight XavierUniform, the bias zeros, unless an attr says otherwise.
Its forward casts its inputs as the op "linear" under AMP: bf16 under O1.
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs
from ..functional import common as F
from ..initializer import Constant, XavierUniform
from ..layer import Layer


class Linear(Layer):
    """y = x W^T + b with W [out, in]. `device`/`dtype` place the
    parameters ("meta" allocates nothing)."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(dtype=dtype, device=device)
        self.weight = self.create_parameter([out_features, in_features], attr=weight_attr,
                                            default_initializer=XavierUniform(), **kw)
        self.bias = self.create_parameter([out_features], attr=bias_attr, is_bias=True,
                                          default_initializer=Constant(0.0), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = amp_cast_inputs("linear", [x, self.weight, self.bias])
        return TF.linear(x, w, b)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """Weight [num_embeddings, embedding_dim], XavierUniform by default;
    the padding_idx row is zeroed at construction and the lookup's output
    is zero wherever an id equals padding_idx (functional.embedding)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter([num_embeddings, embedding_dim], attr=weight_attr,
                                            default_initializer=XavierUniform())
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self) -> str:
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training, mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"
