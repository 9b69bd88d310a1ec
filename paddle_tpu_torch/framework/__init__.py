"""Device, dtype, flags, seeded generators, paddle.save/load, the training
guardian and the monitor shim over telemetry."""
from . import device, dtype, flags, guardian, io, monitor, random

__all__ = ["device", "dtype", "flags", "guardian", "io", "monitor", "random"]
