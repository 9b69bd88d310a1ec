"""Layers, functionals, initializers and gradient clipping."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm
from .initializer import ParamAttr
from .layer import Layer
from .layers import (Dropout, Embedding, LayerNorm, Linear, MultiHeadAttention, RMSNorm, Tanh,
                     TransformerEncoder, TransformerEncoderLayer)

__all__ = ["clip", "functional", "initializer", "ClipGradByGlobalNorm", "ParamAttr", "Layer",
           "Dropout", "Embedding", "LayerNorm", "Linear", "MultiHeadAttention",
           "RMSNorm", "Tanh", "TransformerEncoder", "TransformerEncoderLayer"]
