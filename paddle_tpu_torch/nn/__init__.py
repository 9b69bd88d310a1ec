"""Layers, functionals and gradient clipping."""
from . import clip, functional
from .clip import ClipGradByGlobalNorm
from .layers import Linear, RMSNorm

__all__ = ["clip", "functional", "ClipGradByGlobalNorm", "Linear", "RMSNorm"]
