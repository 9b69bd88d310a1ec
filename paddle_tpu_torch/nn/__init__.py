"""paddle.nn (counterpart of paddle_tpu/nn/__init__.py): layers,
functionals, initializers, gradient clipping, seq2seq decoding and
nn.utils."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_
from .initializer import ParamAttr
from .layer import Layer, Parameter
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers_all
from . import decode, utils  # noqa: E402
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: E402

__all__ = ["clip", "functional", "initializer", "decode", "utils", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_", "ParamAttr", "Layer",
           "Parameter", "BeamSearchDecoder", "dynamic_decode", *_layers_all]
