"""Functionals of the ported slices."""
from .activation import gelu, relu, tanh
from .attention import scaled_dot_product_attention
from .common import dropout, embedding, linear
from .conv import conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d, conv3d_transpose
from .loss import cross_entropy
from .norm import batch_norm, layer_norm, rms_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
                      adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, fractional_max_pool2d, fractional_max_pool3d,
                      lp_pool2d, max_pool1d, max_pool2d, max_pool3d, max_unpool1d, max_unpool2d,
                      max_unpool3d)

__all__ = ["gelu", "relu", "tanh", "scaled_dot_product_attention", "dropout", "embedding",
           "linear", "conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "cross_entropy", "batch_norm", "layer_norm", "rms_norm",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "fractional_max_pool2d", "fractional_max_pool3d",
           "lp_pool2d", "max_pool1d", "max_pool2d", "max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d"]
