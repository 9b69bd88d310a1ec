"""paddle.device.cuda (counterpart of paddle_tpu/device/cuda.py) on torch.cuda."""
from __future__ import annotations

import torch


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_device_id() -> int:
    return torch.cuda.current_device()


def get_device_name(device_id=0) -> str:
    return torch.cuda.get_device_name(device_id)


def get_device_capability(device_id=0):
    return torch.cuda.get_device_capability(device_id)


def get_device_properties(device=None):
    return torch.cuda.get_device_properties(0 if device is None else device)


def max_memory_allocated(device=None) -> int:
    return torch.cuda.max_memory_allocated(device)


def max_memory_reserved(device=None) -> int:
    return torch.cuda.max_memory_reserved(device)


def memory_allocated(device=None) -> int:
    return torch.cuda.memory_allocated(device)


def memory_reserved(device=None) -> int:
    return torch.cuda.memory_reserved(device)


def empty_cache() -> None:
    torch.cuda.empty_cache()


def synchronize(device=None) -> None:
    torch.cuda.synchronize(device)
