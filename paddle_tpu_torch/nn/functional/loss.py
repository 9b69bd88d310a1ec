"""cross_entropy (counterpart of paddle_tpu/nn/functional/loss.py:29-86)."""
from __future__ import annotations

import torch

from ...amp import amp_cast_inputs


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",  # noqa: A002
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
    """paddle's cross_entropy: hard labels ([N] or [N, 1] ids, with
    `ignore_index`, class `weight` and `label_smoothing`) or soft labels
    (a distribution over `axis`); log_softmax of the input, or its log
    clipped to [1e-15, 1] with use_softmax=False. A "mean" over hard labels
    is sum(per) / max(sum of the kept labels' weights (or their count),
    1e-12); over soft labels the plain mean. The black-listed op
    "cross_entropy": f32 under AMP O1."""
    x, lbl, weight = amp_cast_inputs("cross_entropy", [input, label, weight])
    logp = torch.log_softmax(x, dim=axis) if use_softmax else torch.log(x.clamp(1e-15, 1.0))
    nclass = x.shape[axis]
    if soft_label:
        soft = lbl
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / nclass
        per = -(soft * logp).sum(dim=axis)
        if reduction == "mean":
            return per.mean()
    else:
        ids = lbl.squeeze(axis) if lbl.dim() == x.dim() else lbl
        ids = ids.long()
        mask = ids != ignore_index
        safe = torch.where(mask, ids, 0)
        picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0.0:
            per = -(1 - label_smoothing) * picked - label_smoothing * logp.mean(dim=axis)
        else:
            per = -picked
        if weight is not None:
            wsel = weight[safe]
            per = per * wsel
            denom_terms = torch.where(mask, wsel, 0.0)
        else:
            denom_terms = mask.to(per.dtype)
        per = torch.where(mask, per, 0.0)
        if reduction == "mean":
            return per.sum() / denom_terms.sum().clamp_min(1e-12)
    if reduction == "sum":
        return per.sum()
    return per
