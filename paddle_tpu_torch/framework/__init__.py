"""Device, dtype, flags, seeded generators and paddle.save/load."""
from . import device, dtype, flags, io, random

__all__ = ["device", "dtype", "flags", "io", "random"]
