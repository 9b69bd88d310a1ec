"""nn.Layer on torch.nn.Module (counterpart of paddle_tpu/nn/layer.py).

`create_parameter` follows paddle_tpu/nn/layer.py:114-136: the attr's
initializer overrides the default, a bias defaults to zeros and a weight
to XavierUniform, and attr=False gives no parameter (None). A ParamAttr's
learning rate, regularizer and need_clip land on the parameter as
`optimize_attr`, `regularizer` and `need_clip`. Parameters
are created on the framework device in the default dtype unless told
otherwise; on the "meta" device nothing is drawn (for loading, or for a
model that initializes itself after `to_empty`).
"""
from __future__ import annotations

import torch

from ..framework import device as _device
from ..framework import dtype as _dtype
from .initializer import _resolve_attr


class Layer(torch.nn.Module):
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        init, trainable, lr, reg, need_clip = _resolve_attr(attr, is_bias, default_initializer)
        if init is None:
            return None
        dt = _dtype.convert_dtype(dtype) if dtype is not None else _dtype.get_default_dtype()
        if str(device) == "meta":
            value = torch.empty(tuple(shape), dtype=dt, device="meta")
        else:
            value = init(shape, dt, _device.resolve(device))
        p = torch.nn.Parameter(value, requires_grad=trainable)
        # what the optimizer reads (paddle_tpu/nn/layer.py:132-135); a dtype
        # cast (Module.to, amp.decorate) keeps the object and these with it
        p.optimize_attr = {"learning_rate": lr}
        p.regularizer = reg
        p.need_clip = need_clip
        return p

    def add_sublayer(self, name, sublayer):
        """paddle's name for add_module; returns the sublayer."""
        self.add_module(str(name), sublayer)
        return sublayer
