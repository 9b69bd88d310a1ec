"""paddle.nn.functional (counterpart of paddle_tpu/nn/functional/__init__.py)."""
from torch import Tensor  # noqa: F401

from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation_all
from .attention import (flash_attention, flash_attention_with_sparse_mask, flash_attn_unpadded,
                        scaled_dot_product_attention, sparse_attention)
from .common import (affine_grid, alpha_dropout, bilinear, channel_shuffle, cosine_similarity,
                     dropout, dropout2d, dropout3d, embedding, fold, gather_tree, grid_sample,
                     gumbel_softmax, interpolate, label_smooth, linear, normalize, one_hot, pad,
                     pdist, pixel_shuffle, pixel_unshuffle, sequence_mask, temporal_shift, unfold,
                     upsample, zeropad2d)
from .conv import conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d, conv3d_transpose
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits, class_center_sample,
                   cosine_embedding_loss, cross_entropy, ctc_loss, dice_loss, edit_distance,
                   gaussian_nll_loss, hinge_embedding_loss, hsigmoid_loss, huber_loss, kl_div,
                   l1_loss, log_loss, margin_cross_entropy, margin_ranking_loss, mse_loss,
                   multi_label_soft_margin_loss, multi_margin_loss, nll_loss, npair_loss,
                   pairwise_distance, poisson_nll_loss, rnnt_loss, sigmoid_focal_loss,
                   smooth_l1_loss, soft_margin_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss, triplet_margin_with_distance_loss)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm, local_response_norm,
                   rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
                      adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, fractional_max_pool2d, fractional_max_pool3d,
                      lp_pool2d, max_pool1d, max_pool2d, max_pool3d, max_unpool1d, max_unpool2d,
                      max_unpool3d)

__all__ = [*_activation_all,
           "flash_attention", "flash_attention_with_sparse_mask", "flash_attn_unpadded",
           "scaled_dot_product_attention", "sparse_attention",
           "affine_grid", "alpha_dropout", "bilinear", "channel_shuffle", "cosine_similarity",
           "dropout", "dropout2d", "dropout3d", "embedding", "fold", "gather_tree", "grid_sample",
           "gumbel_softmax", "interpolate", "label_smooth", "linear", "normalize", "one_hot", "pad",
           "pdist", "pixel_shuffle", "pixel_unshuffle", "sequence_mask", "temporal_shift",
           "unfold", "upsample", "zeropad2d",
           "conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose",
           "binary_cross_entropy", "binary_cross_entropy_with_logits", "class_center_sample",
           "cosine_embedding_loss", "cross_entropy", "ctc_loss", "dice_loss", "edit_distance",
           "gaussian_nll_loss", "hinge_embedding_loss", "hsigmoid_loss", "huber_loss", "kl_div",
           "l1_loss", "log_loss", "margin_cross_entropy", "margin_ranking_loss", "mse_loss",
           "multi_label_soft_margin_loss", "multi_margin_loss", "nll_loss", "npair_loss",
           "pairwise_distance", "poisson_nll_loss", "rnnt_loss", "sigmoid_focal_loss",
           "smooth_l1_loss", "soft_margin_loss", "softmax_with_cross_entropy",
           "square_error_cost", "triplet_margin_loss", "triplet_margin_with_distance_loss",
           "batch_norm", "group_norm", "instance_norm", "layer_norm", "local_response_norm",
           "rms_norm",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "fractional_max_pool2d", "fractional_max_pool3d",
           "lp_pool2d", "max_pool1d", "max_pool2d", "max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d"]
