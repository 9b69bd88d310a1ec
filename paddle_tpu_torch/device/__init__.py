"""paddle.device (counterpart of paddle_tpu/device/__init__.py): device
selection and Places, and `device.cuda`'s queries on torch.cuda."""
from __future__ import annotations

import torch

from ..framework.device import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place,  # noqa: F401
                                TPUPlace, device_count, get_device, set_device)
from . import cuda  # noqa: F401


def is_compiled_with_tpu() -> bool:
    return False


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_all_custom_device_type():
    return []


def get_available_device():
    gpus = [f"gpu:{i}" for i in range(torch.cuda.device_count())] if torch.cuda.is_available() \
        else []
    return ["cpu"] + gpus


def get_available_custom_device():
    return []


def synchronize(device=None):
    """Wait for every kernel queued on the card (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
