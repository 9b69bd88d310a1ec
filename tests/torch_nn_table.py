"""The nn.functional parity table: one row per call of a functional the nn
slice ported, in tests/torch_op_table.py's row format (the name is
dotted: `nn.functional.<op>`). It imports numpy and torch only, so the
CPU tests (tests/test_torch_nn_functional.py, the port against the JAX
package) and `chip_smoke.py`'s nn_surface phase (the port on the card
against the port on the CPU) both read it.

Rows of functions whose results are random (the training dropouts,
rrelu in training, gumbel_softmax, class_center_sample) are held by the
semantic tests instead; their eval forms are rows here.
"""
from __future__ import annotations

from torch_op_table import Arr, F, I, R

M, V, S = (3, 4), (5,), (2, 3, 4)
IMG = (2, 4, 6, 6)
SIGNS = Arr((1.0, -1.0, 1.0, -1.0, 1.0))


def _f(name, *args, **kw):
    return R("nn.functional." + name, *args, **kw)


_ACTIVATIONS = ["relu", "relu6", "sigmoid", "tanh", "gelu", "silu", "swish", "mish", "selu",
                "celu", "hardshrink", "softshrink", "tanhshrink", "hardsigmoid", "hardswish",
                "softsign", "log_sigmoid", "leaky_relu", "elu", "hardtanh", "softplus",
                "thresholded_relu"]

ROWS = [_f(n, F(S, -4.0, 4.0), bf16=True) for n in _ACTIVATIONS]
ROWS += [
    _f("gelu", F(S), approximate=True, tag="tanh"),
    _f("leaky_relu", F(S), 0.2, tag="slope"),
    _f("elu", F(S), 0.5, tag="alpha"), _f("celu", F(S), 2.0, tag="alpha"),
    _f("hardtanh", F(S), -0.5, 0.7, tag="range"),
    _f("softplus", F(S, -4.0, 4.0), 2.0, 3.0, tag="beta"),
    _f("thresholded_relu", F(S), 0.5, tag="threshold"),
    _f("maxout", F(IMG), 2), _f("maxout", F((2, 4, 6)), 3, axis=-1, tag="last"),
    _f("softmax", F(S), bf16=True), _f("softmax", F(S), axis=0, tag="axis0"),
    _f("softmax", F(S), dtype="float64", tag="dtype"),
    _f("log_softmax", F(S), axis=1, tag="axis1"),
    _f("glu", F((3, 6))), _f("glu", F((4, 3, 2)), axis=0, tag="axis0"),
    _f("prelu", F(IMG), F((4,), 0.0, 0.5)), _f("prelu", F(S), F((1,), 0.0, 0.5), tag="scalar"),
    _f("prelu", F((2, 3, 3, 4)), F((4,), 0.0, 0.5), data_format="NHWC", tag="nhwc"),
    _f("rrelu", F(S), training=False),
]
ROWS += [_f(n + "_", F(S), grad=False) for n in ("relu", "elu", "softmax", "tanh", "hardtanh",
                                               "leaky_relu", "thresholded_relu")]

ROWS += [
    # common
    _f("one_hot", I(V, -1, 5), 4, grad=False),
    _f("label_smooth", F(M, 0.0, 1.0)), _f("label_smooth", F(M, 0.0, 1.0), epsilon=0.2,
                                           tag="eps"),
    _f("label_smooth", F(M, 0.0, 1.0), prior_dist=F((1, 4), 0.0, 0.5), tag="prior"),
    _f("pad", F(IMG), [1, 2]), _f("pad", F(IMG), [1, 0, 2, 1], value=1.5, tag="value"),
    _f("pad", F(IMG), [2, 1, 1, 3], mode="reflect", tag="reflect"),
    _f("pad", F(IMG), [2, 1, 1, 3], mode="replicate", tag="replicate"),
    _f("pad", F(IMG), [2, 1, 1, 3], mode="circular", tag="circular"),
    _f("pad", F((2, 5, 5, 3)), [1, 2, 0, 1], mode="reflect", data_format="NHWC", tag="nhwc"),
    _f("pad", F(S), [0, 1, 1, 0, 2, 2], tag="full_rank"),
    _f("pad", F((2, 3, 5)), [2, 3], mode="reflect", data_format="NCL", tag="1d"),
    _f("zeropad2d", F(IMG), [1, 0, 2, 1]),
    _f("normalize", F(S)), _f("normalize", F(S), p=1.0, axis=-1, tag="l1"),
    _f("cosine_similarity", F(S), F(S), axis=-1),
    _f("pairwise_distance", F(M), F(M)),
    _f("pairwise_distance", F(M), F(M), p=float("inf"), keepdim=True, tag="inf"),
    _f("pairwise_distance", F(M), F(M), p=1.0, tag="l1"),
    _f("pdist", F((5, 3))), _f("pdist", F((5, 3)), p=1.0, tag="l1"),
    _f("pdist", F((5, 3)), p=float("inf"), tag="inf"),
    _f("unfold", F(IMG), 2), _f("unfold", F(IMG), [2, 3], 2, 1, 1, tag="strided"),
    _f("unfold", F(IMG), 2, paddings=[1, 0, 0, 1], tag="asym"),
    _f("fold", F((2, 16, 16)), [5, 5], 2),
    _f("fold", F((2, 8, 12)), [5, 6], 2, strides=2, paddings=1, tag="strided"),
    _f("pixel_shuffle", F((2, 8, 3, 3)), 2),
    _f("pixel_shuffle", F((2, 3, 3, 8)), 2, data_format="NHWC", tag="nhwc"),
    _f("pixel_unshuffle", F((2, 2, 4, 6)), 2),
    _f("channel_shuffle", F((2, 6, 2, 2)), 3),
    _f("channel_shuffle", F((2, 2, 2, 6)), 2, data_format="NHWC", tag="nhwc"),
    _f("grid_sample", F(IMG), F((2, 3, 5, 2), -1.1, 1.1)),
    _f("grid_sample", F(IMG), F((2, 3, 5, 2), -1.1, 1.1), align_corners=False, tag="half"),
    _f("grid_sample", F(IMG), F((2, 3, 5, 2), -1.3, 1.3), padding_mode="border", tag="border"),
    _f("grid_sample", F(IMG), F((2, 3, 5, 2), -1.3, 1.3), padding_mode="reflection",
       tag="reflection"),
    _f("grid_sample", F(IMG), F((2, 3, 5, 2), -1.3, 1.3), padding_mode="reflection",
       align_corners=False, tag="reflection_half"),
    _f("grid_sample", F(IMG), F((2, 3, 5, 2), -1.0, 1.0), mode="nearest", grad=False,
       tag="nearest"),
    _f("affine_grid", F((2, 2, 3)), [2, 1, 4, 5]),
    _f("affine_grid", F((2, 2, 3)), [2, 1, 4, 5], align_corners=False, tag="half"),
    _f("sequence_mask", I((3,), 1, 5), maxlen=6, grad=False),
    _f("sequence_mask", I((2, 3), 1, 5), grad=False, dtype="float32", tag="nomax"),
    _f("bilinear", F((3, 4)), F((3, 5)), F((2, 4, 5)), F((2,))),
    _f("temporal_shift", F((4, 4, 2, 2)), 2),
    _f("temporal_shift", F((4, 2, 2, 8)), 2, 0.25, data_format="NHWC", tag="nhwc"),
    _f("gather_tree", I((4, 2, 3), 0, 10), I((4, 2, 3), 0, 3), grad=False),
    _f("dropout", F(S), 0.3, training=False, tag="eval"),
    _f("dropout", F(S), 0.3, training=False, mode="downscale_in_infer", tag="downscale_eval"),
    _f("dropout2d", F(IMG), 0.3, training=False), _f("dropout3d", F((2, 3, 2, 2, 2)), 0.3,
                                                     training=False),
    _f("alpha_dropout", F(S), 0.3, training=False),
    # losses
    _f("mse_loss", F(M), F(M)), _f("mse_loss", F(M), F(M), reduction="none", tag="none"),
    _f("l1_loss", F(M), F(M), reduction="sum"),
    _f("smooth_l1_loss", F(M), F(M), delta=0.5), _f("huber_loss", F(M), F(M), delta=0.5),
    _f("binary_cross_entropy", F(M, 0.05, 0.95), F(M, 0.0, 1.0)),
    _f("binary_cross_entropy", F(M, 0.05, 0.95), F(M, 0.0, 1.0), weight=F((4,), 0.5, 1.5),
       reduction="sum", tag="weight"),
    _f("kl_div", F(M, -3.0, -0.1), F(M, 0.01, 1.0)),
    _f("kl_div", F(M, -3.0, -0.1), F(M, -3.0, -0.1), reduction="batchmean", log_target=True,
       tag="log_target"),
    _f("margin_ranking_loss", F(V), F(V), SIGNS, margin=0.3),
    _f("hinge_embedding_loss", F(V), SIGNS, margin=0.5),
    _f("cosine_embedding_loss", F((5, 4)), F((5, 4)), SIGNS, margin=0.1),
    _f("triplet_margin_loss", F(M), F(M), F(M)),
    _f("triplet_margin_loss", F(M), F(M), F(M), p=1.0, swap=True, reduction="none",
       tag="swap"),
    _f("triplet_margin_with_distance_loss", F(M), F(M), F(M), margin=0.5, swap=True),
    _f("log_loss", F(M, 0.1, 0.9), F(M, 0.0, 1.0)),
    _f("square_error_cost", F(M), F(M)),
    _f("sigmoid_focal_loss", F(M), F(M, 0.0, 1.0)),
    _f("sigmoid_focal_loss", F(M), F(M, 0.0, 1.0), normalizer=F((1,), 1.0, 2.0),
       reduction="mean", tag="normalizer"),
    _f("dice_loss", F((3, 4), 0.0, 1.0), I((3, 1), 0, 4)),
    _f("npair_loss", F((4, 3)), F((4, 3)), I((4,), 0, 2)),
    _f("margin_cross_entropy", F((4, 5), -0.9, 0.9), I((4,), 0, 5), return_softmax=True),
    _f("margin_cross_entropy", F((4, 5), -0.9, 0.9), I((4,), 0, 5), margin2=0.3, margin3=0.1,
       scale=8.0, reduction="none", tag="margins"),
    _f("hsigmoid_loss", F((4, 3)), I((4,), 0, 5), 5, F((4, 3)), F((4,))),
    _f("hsigmoid_loss", F((4, 3)), I((4,), 0, 3), 3, F((3, 3)),
       path_table=Arr(((0, 1, -1), (0, 2, -1), (0, 1, 2)), "int64"),
       path_code=Arr(((0, 1, 0), (1, 0, 0), (0, 0, 1)), "int64"), tag="custom"),
    _f("rnnt_loss", F((2, 3, 3, 4)), I((2, 2), 1, 4, "int32"), Arr((3, 2), "int32"),
       Arr((2, 1), "int32")),
    _f("rnnt_loss", F((2, 3, 3, 4)), I((2, 2), 1, 4, "int32"), Arr((3, 3), "int32"),
       Arr((2, 2), "int32"), fastemit_lambda=0.5, reduction="sum", tag="fastemit"),
    _f("edit_distance", I((3, 5), 0, 4), I((3, 4), 0, 4), grad=False),
    _f("edit_distance", I((3, 5), 0, 4), I((3, 4), 0, 4), normalized=False,
       ignored_tokens=[0], input_length=Arr((5, 3, 4), "int64"),
       label_length=Arr((4, 2, 3), "int64"), grad=False, tag="lengths"),
    _f("gaussian_nll_loss", F(M), F(M), F(M, 0.1, 1.0)),
    _f("gaussian_nll_loss", F(M), F(M), F(M, 0.1, 1.0), full=True, reduction="sum", tag="full"),
    _f("poisson_nll_loss", F(M), F(M, 0.0, 3.0)),
    _f("poisson_nll_loss", F(M, 0.1, 2.0), F(M, 1.5, 4.0), log_input=False, full=True,
       tag="full"),
    _f("soft_margin_loss", F(V), SIGNS),
    _f("multi_label_soft_margin_loss", F(M), F(M, 0.0, 1.0)),
    _f("multi_label_soft_margin_loss", F(M), F(M, 0.0, 1.0), weight=F((4,), 0.5, 1.5),
       reduction="none", tag="weight"),
    _f("multi_margin_loss", F(M), I((3,), 0, 4)),
    _f("multi_margin_loss", F(M), I((3,), 0, 4), p=2, margin=0.5, weight=F((4,), 0.5, 1.5),
       tag="weight"),
    _f("nll_loss", F(M, -3.0, 0.0), I((3,), 0, 4)),
    _f("nll_loss", F(M, -3.0, 0.0), Arr((1, -100, 3), "int64"), weight=F((4,), 0.5, 1.5),
       tag="weight_ignore"),
    _f("nll_loss", F((2, 4, 3, 2), -3.0, 0.0), I((2, 3, 2), 0, 4), reduction="none", tag="4d"),
    _f("softmax_with_cross_entropy", F(M), I((3, 1), 0, 4)),
    _f("softmax_with_cross_entropy", F(M), F(M, 0.0, 1.0), soft_label=True,
       return_softmax=True, tag="soft"),
    _f("softmax_with_cross_entropy", F(S), I((2, 1, 4), 0, 3), axis=1, tag="axis1"),
    _f("cross_entropy", F(S), F(S, 0.0, 1.0), soft_label=True, tag="soft"),
    # norms
    _f("group_norm", F(IMG), 2, weight=F((4,)), bias=F((4,))),
    _f("group_norm", F((2, 3, 3, 4)), 2, data_format="NHWC", tag="nhwc"),
    _f("instance_norm", F(IMG), weight=F((4,)), bias=F((4,))),
    _f("instance_norm", F((2, 3, 7)), tag="1d"),
    _f("local_response_norm", F(IMG), 3), _f("local_response_norm", F(IMG), 4, 1e-2, 0.5, 2.0,
                                             tag="even"),
    # pooling (the JAX package's mask is not differentiable through: the
    # pools' gradients are test_torch_vision.py's)
    _f("max_pool2d", F(IMG), 2, 2, padding=1, return_mask=True, tag="mask", grad=False),
    _f("max_pool1d", F((2, 3, 7)), 3, 2, return_mask=True, tag="mask", grad=False),
    _f("max_pool3d", F((1, 2, 4, 4, 4)), 2, return_mask=True, tag="mask", grad=False),
    _f("adaptive_max_pool1d", F((2, 3, 7)), 3), _f("adaptive_max_pool2d", F(IMG), [4, 3]),
    _f("adaptive_max_pool3d", F((1, 2, 4, 5, 6)), 2),
    _f("lp_pool2d", F(IMG), 2, 2), _f("lp_pool2d", F(IMG, 0.1, 2.0), 3.0, 3, 1, 1, tag="p3"),
    _f("fractional_max_pool2d", F((2, 2, 7, 7)), 3, random_u=0.3, return_mask=True),
    _f("fractional_max_pool2d", F((2, 2, 9, 8)), [4, 3], kernel_size=2, random_u=0.6,
       tag="kernel"),
    _f("fractional_max_pool3d", F((1, 2, 5, 6, 7)), 3, random_u=0.4, return_mask=True),
    # attention
    _f("flash_attention", F((2, 5, 2, 8)), F((2, 5, 2, 8)), F((2, 5, 2, 8))),
    _f("flash_attention", F((2, 5, 2, 8)), F((2, 7, 2, 8)), F((2, 7, 2, 8)), causal=True,
       tag="causal"),
    _f("sparse_attention", F((1, 2, 4, 8)), F((1, 2, 4, 8)), F((1, 2, 4, 8)),
       Arr((((0, 2, 3, 5, 7), (0, 1, 3, 4, 6)),), "int32"),
       Arr((((0, 1, 1, 0, 2, 1, 3), (0, 0, 1, 2, 1, 2, 3)),), "int32")),
    _f("sparse_attention", F((1, 2, 4, 8)), F((1, 2, 4, 8)), F((1, 2, 4, 8)),
       Arr((((0, 2, 3, 5, 7), (0, 1, 3, 4, 6)),), "int32"),
       Arr((((0, 1, 1, 0, 2, 1, 3), (0, 0, 1, 2, 1, 2, 3)),), "int32"),
       key_padding_mask=Arr(((1, 1, 0, 1),), "float32"), attn_mask=Arr(
           ((1, 1, 1, 1), (1, 1, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)), "float32"), tag="masks"),
    _f("flash_attention_with_sparse_mask", F((1, 4, 2, 8)), F((1, 4, 2, 8)), F((1, 4, 2, 8)),
       I((1, 2, 4), 1, 5, "int32")),
    _f("flash_attention_with_sparse_mask", F((1, 4, 2, 8)), F((1, 4, 2, 8)), F((1, 4, 2, 8)),
       I((1, 2, 4), 2, 5, "int32"), is_causal=True, tag="causal"),
]
