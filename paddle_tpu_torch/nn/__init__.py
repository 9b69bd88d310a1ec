"""Layers, functionals, initializers and gradient clipping."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm
from .initializer import ParamAttr
from .layer import Layer
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers_all

__all__ = ["clip", "functional", "initializer", "ClipGradByGlobalNorm", "ParamAttr", "Layer",
           *_layers_all]
