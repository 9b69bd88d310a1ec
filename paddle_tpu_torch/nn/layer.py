"""nn.Layer on torch.nn.Module, and nn.Parameter (counterpart of
paddle_tpu/nn/layer.py).

`create_parameter` follows paddle_tpu/nn/layer.py:114-136: the attr's
initializer overrides the default, a bias defaults to zeros and a weight
to XavierUniform, and attr=False gives no parameter (None). A ParamAttr's
learning rate, regularizer and need_clip land on the parameter as
`optimize_attr`, `regularizer` and `need_clip`. Parameters
are created on the framework device in the default dtype unless told
otherwise; on the "meta" device nothing is drawn (for loading, or for a
model that initializes itself after `to_empty`).

The rest of paddle's Layer surface sits on torch's: `sublayers` and
`named_sublayers` walk the sublayers in paddle's order, `set_state_dict`
(`load_dict`) copies a state of tensors or numpy arrays in the JAX
package's layout into the parameters and buffers, `to` and `astype` take
dtype names ("bfloat16") and paddle's device names, and
`register_forward_post_hook` is torch's forward hook.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import record as _record
from ..framework import device as _device
from ..framework import dtype as _dtype
from ..framework.io import numpy_to_tensor
from .initializer import _resolve_attr


class Parameter(torch.nn.Parameter):
    """A trainable tensor; `trainable` is `requires_grad` (paddle's
    Parameter, whose stop_gradient is `not trainable`)."""

    def __new__(cls, data=None, trainable=True, name=None):
        return super().__new__(cls, data, requires_grad=trainable)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value) -> None:
        self.requires_grad_(bool(value))


def _is_dtype(arg) -> bool:
    if isinstance(arg, torch.dtype):
        return True
    if not isinstance(arg, str):
        return False
    try:
        _dtype.convert_dtype(arg)
        return True
    except (TypeError, ValueError, KeyError):
        return False


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
            with _record.suspended():  # initialization is no op of a static capture
                value = init(shape, dt, _device.resolve(device))
        p = Parameter(value, trainable=trainable)
        # what the optimizer reads (paddle_tpu/nn/layer.py:132-135); a dtype
        # cast (Module.to, amp.decorate) keeps the object and these with it
        p.optimize_attr = {"learning_rate": lr}
        p.regularizer = reg
        p.need_clip = need_clip
        return p

    def create_tensor(self, name=None, dtype=None):
        """A 0-d zero of `dtype` (the default dtype) on the framework device."""
        dt = _dtype.convert_dtype(dtype) if dtype is not None else _dtype.get_default_dtype()
        return torch.zeros((), dtype=dt, device=_device.current_device())

    def add_sublayer(self, name, sublayer):
        """paddle's name for add_module; returns the sublayer."""
        self.add_module(str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        """paddle's name for register_parameter; returns the parameter."""
        self.register_parameter(str(name), parameter)
        return parameter

    def named_sublayers(self, prefix="", include_self=False):
        """(name, layer) of every sublayer, depth first, each under its
        dotted path; with include_self first (prefix without its dot, self)."""
        if include_self:
            yield prefix.rstrip("."), self
        for name, sub in self._modules.items():
            if sub is None:
                continue
            yield f"{prefix}{name}", sub
            yield from sub.named_sublayers(prefix=f"{prefix}{name}.")

    def sublayers(self, include_self=False):
        return [layer for _, layer in self.named_sublayers(include_self=include_self)]

    def full_name(self) -> str:
        """The layer's name scope: its class name in lower case."""
        return type(self).__name__.lower()

    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs) after forward; a result other than
        None replaces the outputs. Returns a handle with remove()."""
        return self.register_forward_hook(hook)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy `state_dict` (tensors or numpy arrays, the JAX package's
        layout and names) into the parameters and buffers of the same name,
        each cast to the target's dtype. A shape mismatch raises ValueError.
        Returns (missing_keys, unexpected_keys)."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                target = own[k]
                val = v.detach() if isinstance(v, torch.Tensor) else numpy_to_tensor(np.asarray(v))
                if tuple(val.shape) != tuple(target.shape):
                    raise ValueError(f"shape mismatch for {k}: loaded {tuple(val.shape)} vs "
                                     f"param {tuple(target.shape)}")
                target.copy_(val.to(device=target.device, dtype=target.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    def to(self, *args, **kwargs):
        """torch's Module.to, also taking paddle's `to(device=None,
        dtype=None, blocking=None)` with names: "bfloat16", "float32",
        "gpu", "gpu:0", "cpu". A dtype casts the floating parameters and
        buffers only."""
        kwargs.pop("blocking", None)
        device, dtype = kwargs.pop("device", None), kwargs.pop("dtype", None)
        rest = []
        for a in args:
            if _is_dtype(a) and dtype is None:
                dtype = a
            elif isinstance(a, str) and device is None:
                device = a
            else:
                rest.append(a)
        if device is not None:
            rest.insert(0, _device._parse(device))
        if dtype is not None:
            kwargs["dtype"] = _dtype.convert_dtype(dtype)
        return super().to(*rest, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)
