"""Loss layers (counterpart of paddle_tpu/nn/layers/loss.py): each
holds its options (and HSigmoidLoss its tree's weights) and calls its
functional."""
from __future__ import annotations

from .. import functional as F
from ..functional.loss import cross_entropy
from ..layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False, axis=-1,
                 use_softmax=True, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):  # noqa: A002
        return cross_entropy(input, label, weight=self.weight, ignore_index=self.ignore_index,
                             reduction=self.reduction, soft_label=self.soft_label, axis=self.axis,
                             use_softmax=self.use_softmax, label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.nll_loss(input, label, self.weight, self.ignore_index, self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None, name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, self.weight, self.reduction,
                                                  self.pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction = reduction
        self.log_target = log_target

    def forward(self, input, label):  # noqa: A002
        return F.kl_div(input, label, self.reduction, self.log_target)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths, norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths, self.blank,
                          self.reduction, norm_by_times)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):  # noqa: A002
        return F.margin_ranking_loss(input, other, label, self.margin, self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False, reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class SigmoidFocalLoss(Layer):
    def __init__(self, alpha=0.25, gamma=2.0, normalizer=None, reduction="sum", name=None):
        super().__init__()
        self.alpha, self.gamma, self.normalizer, self.reduction = alpha, gamma, normalizer, reduction

    def forward(self, logit, label):
        return F.sigmoid_focal_loss(logit, label, self.normalizer, self.alpha, self.gamma,
                                    self.reduction)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean", name=None):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):  # noqa: A002
        return F.gaussian_nll_loss(input, label, variance, self.full, self.epsilon,
                                   self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8, reduction="mean", name=None):
        super().__init__()
        self.log_input, self.full, self.epsilon, self.reduction = log_input, full, epsilon, reduction

    def forward(self, input, label):  # noqa: A002
        return F.poisson_nll_loss(input, label, self.log_input, self.full, self.epsilon,
                                  self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):  # noqa: A002
        return F.hinge_embedding_loss(input, label, self.margin, self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin, self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):  # noqa: A002
        return F.multi_label_soft_margin_loss(input, label, self.weight, self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean", name=None):
        super().__init__()
        self.p, self.margin, self.weight, self.reduction = p, margin, weight, reduction

    def forward(self, input, label):  # noqa: A002
        return F.multi_margin_loss(input, label, self.p, self.margin, self.weight, self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False, reduction="mean",
                 name=None):
        super().__init__()
        self.distance_function, self.margin, self.swap, self.reduction = (
            distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_with_distance_loss(input, positive, negative,
                                                   self.distance_function, self.margin,
                                                   self.swap, self.reduction)


class HSigmoidLoss(Layer):
    """The hierarchical sigmoid over a tree whose weights the layer holds:
    weight [C, D] and bias [C, 1], C = num_classes - 1 for the default
    tree (num_classes for a custom one)."""

    def __init__(self, feature_size, num_classes, weight_attr=None, bias_attr=None,
                 is_custom=False, is_sparse=False, name=None):
        super().__init__()
        if not is_custom and num_classes < 2:
            raise ValueError("num_classes must be >= 2 for the default tree")
        c = num_classes if is_custom else num_classes - 1
        self._num_classes = num_classes
        self.weight = self.create_parameter([c, feature_size], attr=weight_attr)
        self.bias = self.create_parameter([c, 1], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):  # noqa: A002
        bias = None if self.bias is None else self.bias.reshape(-1)
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight, bias,
                               path_table=path_table, path_code=path_code)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean", name=None):
        super().__init__()
        self.blank, self.fastemit_lambda, self.reduction = blank, fastemit_lambda, reduction

    def forward(self, input, label, input_lengths, label_lengths):  # noqa: A002
        return F.rnnt_loss(input, label, input_lengths, label_lengths, self.blank,
                           self.fastemit_lambda, self.reduction)
