"""Functionals of the ported slices."""
from .activation import gelu, relu, tanh
from .attention import scaled_dot_product_attention
from .common import dropout, embedding, linear
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "relu", "tanh", "scaled_dot_product_attention", "dropout", "embedding",
           "linear", "layer_norm", "rms_norm"]
