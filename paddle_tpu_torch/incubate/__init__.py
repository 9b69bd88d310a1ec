"""Fused ops (counterpart of paddle_tpu/incubate)."""
from . import nn

__all__ = ["nn"]
