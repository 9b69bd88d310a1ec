"""to_tensor (counterpart of paddle_tpu/ops/creation.py:25)."""
from __future__ import annotations

import numpy as np
import torch

from ..framework import device as _device
from ..framework import dtype as _dtype
from ..framework.io import numpy_to_tensor


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> torch.Tensor:
    """A new tensor on `place` (default: the framework device) holding a
    copy of `data` (a tensor, numpy array, list or scalar). Without a
    dtype, float64 data takes the default float type, as in paddle;
    other types keep theirs. stop_gradient=False makes it a leaf that
    requires grad."""
    dev = _device.resolve(place)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(dev, copy=True)
    else:
        t = numpy_to_tensor(np.asarray(data)).to(dev)
        if dtype is None and t.dtype == torch.float64:
            t = t.to(_dtype.get_default_dtype())
    if dtype is not None:
        t = t.to(_dtype.convert_dtype(dtype))
    return t.requires_grad_(not stop_gradient)
