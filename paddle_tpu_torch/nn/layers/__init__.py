from .common import Linear
from .norm import RMSNorm

__all__ = ["Linear", "RMSNorm"]
