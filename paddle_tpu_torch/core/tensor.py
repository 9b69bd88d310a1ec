"""paddle's Tensor surface on torch.Tensor (counterpart of
paddle_tpu/core/tensor.py:24-433).

`Tensor` is `torch.Tensor`: the port's models, parameters and kernels
take and return plain tensors, and a subclass with `__torch_function__`
would add a Python hop to every op. paddle's attributes are attached to
the class once, at import of the package (`install`, then
ops/_patch.py), under three rules:

1. a name torch lacks is added (`stop_gradient`, `place`, `astype`,
   `clear_grad`, `set_value`, the paddle-only ops and `*_` inplaces);
2. a torch method is widened only where every call torch accepts still
   returns torch's result (`numpy()` here; the rest in ops/_patch.py);
3. where one call form means different things in the two packages,
   torch's meaning stays, and paddle's is the function
   `paddle_tpu_torch.<op>` (ops/_patch.py `CONFLICTS`).

`stop_gradient` is `not requires_grad`. Setting it True on a tensor an op
produced detaches it in place (gradients stop there, as in paddle); on a
tensor that cannot require grad (integer, bool) setting it False does
nothing. `clear_grad` sets the gradient to None, as the JAX package does
(tensor.py:182). torch's read-only `.name` stays as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as _dtype
from ..framework.io import numpy_to_tensor, tensor_to_numpy
from . import record as _record

Tensor = torch.Tensor

# paddle-only attributes that belong to a later slice: reading them raises.
# (torch's own stft/istft stay: paddle's forms are ops/_patch.py conflicts.)
LATER_SLICE = {
    "process_mesh": "distributed", "placements": "distributed", "is_dist": "distributed",
    "_dist_attr": "distributed",
}


def later_slice(name: str):
    return NotImplementedError(f"Tensor.{name} belongs to the port's {LATER_SLICE[name]} slice, "
                               "which is not ported yet")


def _raising_method(name):
    def m(self, *args, **kwargs):
        raise later_slice(name)

    m.__name__ = name
    return m


def _raising_property(name):
    def get(self):
        raise later_slice(name)

    return property(get)


def _amp_cast(name, x):
    from ..amp import amp_cast_inputs, get_amp_state

    return x if get_amp_state() is None else amp_cast_inputs(name, [x])[0]


# ---- stop_gradient, place, persistable, value ----

def _get_stop_gradient(self) -> bool:
    return not self.requires_grad


def _set_stop_gradient(self, value) -> None:
    stop = bool(value)
    if self.requires_grad != stop:
        return
    if stop and self.grad_fn is not None:
        self.detach_()
    elif self.is_floating_point() or self.is_complex():
        self.requires_grad_(not stop)


def _place(self) -> torch.device:
    return self.device


def _value(self):
    return self


# ---- methods ----

def set_value(self, value):
    """Replace the value in place (paddle Tensor.set_value), outside
    autograd. Same shape and dtype: the storage is written; otherwise the
    tensor takes the new value's shape and dtype (the JAX package rebinds)."""
    if not isinstance(value, torch.Tensor):
        value = numpy_to_tensor(np.asarray(value)).to(self.dtype)
    value = value.detach().to(self.device)
    with torch.no_grad():
        if value.shape == self.shape and value.dtype == self.dtype:
            self.copy_(value)
        else:
            self.data = value.clone()
    return self


def astype(self, dtype):
    """A copy in `dtype` (the op "cast" under AMP, as in the JAX package)."""
    return _amp_cast("cast", self).to(_dtype.convert_dtype(dtype))


def clear_grad(self, set_to_zero=False) -> None:
    self.grad = None


def gradient(self):
    """The gradient as a numpy array, or None."""
    return None if self.grad is None else tensor_to_numpy(self.grad)


def tpu(self, device_id=0):
    """To the accelerator (the JAX package's TPU; here CUDA device `device_id`)."""
    return self.to(torch.device("cuda", device_id))


def apply(self, func):
    """func(self) outside autograd (paddle Tensor.apply)."""
    with torch.no_grad():
        return func(self)


_torch_numpy = torch.Tensor.numpy


def numpy(self, *args, **kwargs):
    """torch's numpy(), widened: a tensor torch refuses (on the card,
    requiring grad, bfloat16) is copied to a host array (bf16 as
    ml_dtypes.bfloat16), as paddle does. A CPU tensor torch accepts
    still shares its memory."""
    if args or kwargs or (self.device.type == "cpu" and not self.requires_grad
                          and self.dtype != torch.bfloat16):
        return _torch_numpy(self, *args, **kwargs)
    a = tensor_to_numpy(self)
    # a CPU tensor's array is a view of its storage: copy, so that writing
    # the array cannot change a tensor autograd tracks
    return a.copy() if self.device.type == "cpu" else a


def set_printoptions(precision=None, threshold=None, edgeitems=None, sci_mode=None, linewidth=None):
    """paddle.set_printoptions (counterpart of tensor.py:422): torch's."""
    torch.set_printoptions(precision=precision, threshold=threshold, edgeitems=edgeitems,
                           linewidth=linewidth, sci_mode=sci_mode)


def install() -> None:
    """Attach the attributes above (rule 1, and `numpy` under rule 2)."""
    T = torch.Tensor
    T.stop_gradient = property(_get_stop_gradient, _set_stop_gradient)
    T.place = property(_place)
    T.persistable = False  # an instance sets its own
    T.value = property(_value)
    for fn in (set_value, astype, clear_grad, gradient, tpu, apply, numpy):
        setattr(T, fn.__name__, fn)
    T.cast = astype
    T.clear_gradient = clear_grad
    T.is_dist = _raising_method("is_dist")
    # the JAX package's method form: the tensor binds as the op's name
    T.apply_nograd = _record.apply_nograd
    for name in ("process_mesh", "placements", "_dist_attr"):
        setattr(T, name, _raising_property(name))
