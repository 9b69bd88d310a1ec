"""Device selection (paddle.set_device / paddle.get_device) and Places
(counterpart of paddle_tpu/framework/device.py).

Entry points run on `cuda:0` unless the caller asks for the CPU. There is
no quiet fallback: without CUDA and without `set_device("cpu")`,
`current_device()` raises, so a run that was meant for the card can never
report CPU numbers as if they were the card's. `get_device()` names that
device as paddle does, "gpu:0" or "cpu:0"; the port's own callers take
the torch.device from `current_device()`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

_requested: Optional[torch.device] = None


def _parse(device: Union[str, torch.device]) -> torch.device:
    if isinstance(device, torch.device):
        return device
    name = str(device).strip().lower()
    if name in ("gpu", "cuda"):
        return torch.device("cuda", 0)
    if name.startswith("gpu:"):
        return torch.device("cuda", int(name.split(":", 1)[1]))
    return torch.device(name)


def set_device(device: Union[str, torch.device]) -> torch.device:
    """Select the device entry points allocate on: "cpu", "gpu", "gpu:N",
    "cuda", "cuda:N" or a torch.device. Returns the resolved device."""
    global _requested
    dev = _parse(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    _requested = dev
    return dev


def current_device() -> torch.device:
    """The device entry points use: the one set_device() chose, else
    cuda:0. Raises when CUDA is needed and absent."""
    dev = _requested if _requested is not None else torch.device("cuda", 0)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on cuda:0 by default and CUDA is not "
            "available; call paddle_tpu_torch.set_device('cpu') (or "
            "Config.disable_gpu()) to run on the CPU"
        )
    return dev


def resolve(device: Union[None, str, torch.device]) -> torch.device:
    """An explicit device argument, else current_device()."""
    if device is None:
        return current_device()
    dev = _parse(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def _paddle_name(dev: torch.device) -> str:
    return f"{'gpu' if dev.type == 'cuda' else dev.type}:{dev.index or 0}"


def get_device() -> str:
    """paddle.get_device: the current device's name, "gpu:N" or "cpu:0"
    (paddle_tpu/framework/device.py:119-122)."""
    return _paddle_name(current_device())


class Place:
    """A device as paddle names it: (device_type, device_id), over a
    torch.device. Equal to another Place, or to a name set_device takes,
    of the same device."""

    __slots__ = ("_device",)

    def __init__(self, device="cpu"):
        if isinstance(device, Place):
            device = device._device
        self._device = _parse(device)

    @property
    def torch_device(self) -> torch.device:
        return self._device

    @property
    def device_type(self) -> str:
        return "gpu" if self._device.type == "cuda" else self._device.type

    @property
    def device_id(self) -> int:
        return self._device.index or 0

    def is_gpu_place(self) -> bool:
        return self._device.type == "cuda"

    def is_cpu_place(self) -> bool:
        return self._device.type == "cpu"

    def is_tpu_place(self) -> bool:
        return False

    def __eq__(self, other):
        if isinstance(other, str):
            try:
                other = Place(other)
            except (RuntimeError, ValueError):
                return NotImplemented
        if isinstance(other, Place):
            return (self.device_type, self.device_id) == (other.device_type, other.device_id)
        return NotImplemented

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"


class CPUPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("cpu")


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__(torch.device("cuda", int(device_id)))


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: a host place."""


class TPUPlace(Place):
    """The port is not built for a TPU: making one raises."""

    def __init__(self, device_id: int = 0):
        raise RuntimeError("paddle_tpu_torch is not built for a TPU (is_compiled_with_tpu() is "
                           "False)")


def device_count(kind: Optional[str] = None) -> int:
    """The number of devices of `kind` ("gpu"/"cuda" or "cpu"); with no
    kind, the CUDA devices (1 on a host without one: the CPU)."""
    if kind in ("cpu",):
        return 1
    if kind in (None, "gpu", "cuda"):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return n if kind is not None or n else 1
    return 0
