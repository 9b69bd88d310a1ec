"""Functionals of the ported slices."""
from .activation import gelu, log_softmax, relu, sigmoid, silu, tanh
from .attention import scaled_dot_product_attention
from .common import dropout, embedding, interpolate, linear, upsample
from .conv import conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d, conv3d_transpose
from .loss import binary_cross_entropy_with_logits, cross_entropy, ctc_loss
from .norm import batch_norm, layer_norm, rms_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
                      adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, fractional_max_pool2d, fractional_max_pool3d,
                      lp_pool2d, max_pool1d, max_pool2d, max_pool3d, max_unpool1d, max_unpool2d,
                      max_unpool3d)

__all__ = ["gelu", "log_softmax", "relu", "sigmoid", "silu", "tanh",
           "scaled_dot_product_attention", "dropout", "embedding", "interpolate", "linear",
           "upsample", "conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "binary_cross_entropy_with_logits", "cross_entropy", "ctc_loss",
           "batch_norm", "layer_norm", "rms_norm",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "fractional_max_pool2d", "fractional_max_pool3d",
           "lp_pool2d", "max_pool1d", "max_pool2d", "max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d"]
