"""cross_entropy, binary_cross_entropy_with_logits and ctc_loss
(counterpart of paddle_tpu/nn/functional/loss.py:29-86, 183, 288-347)."""
from __future__ import annotations

import torch
from torch.nn import functional as TF

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


def _reduce(per, reduction):
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean", pos_weight=None,
                                     name=None):
    """-(pos_weight * y * log_sigmoid(z) + (1 - y) * log_sigmoid(-z)),
    times `weight`, then reduced: the JAX package's log-sigmoid form."""
    log_sig = TF.logsigmoid(logit)
    log_sig_neg = TF.logsigmoid(-logit)
    pos = label * log_sig if pos_weight is None else pos_weight * label * log_sig
    per = -(pos + (1 - label) * log_sig_neg)
    if weight is not None:
        per = per * weight
    return _reduce(per, reduction)


NEG = -1e30  # the log-probability of an unreachable CTC state (finite, as the JAX package keeps it)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0, reduction="mean",
             norm_by_times=False):
    """CTC by the alpha recursion in log space over [T, N, C] inputs.

    As the JAX package: log_softmax is applied again first (a no-op on
    log-probs; it makes the input gradient the gradient with respect to
    logits), unreachable states hold NEG = -1e30, so an infeasible
    alignment costs 1e30 (torch's ctc_loss gives inf), and "mean" is the
    mean of each loss over its label length. Each step takes
    torch.logsumexp over a state's three predecessors, which keeps the
    gradient finite where every predecessor is NEG; the JAX package's
    log(sum of exps) there has an infinite derivative that its `where`
    turns into NaN. norm_by_times=True (paddle scales the gradient by the
    input lengths) raises: the JAX package ignores it."""
    if norm_by_times:
        raise NotImplementedError("ctc_loss norm_by_times=True is not ported (the JAX package "
                                  "ignores it)")
    lp = torch.log_softmax(log_probs, dim=-1)
    T, N, _ = lp.shape
    labels = labels.long()
    L = 2 * labels.shape[1] + 1
    dev = lp.device
    ext = torch.full((N, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    emit = lp.gather(2, ext.unsqueeze(0).expand(T, N, L))  # [T, N, L]
    neg = lp.new_full((N, L), NEG)
    alpha = torch.cat([emit[0, :, :2], neg[:, 2:]], dim=1)
    # a skip from s - 2 exists where ext[s] differs from ext[s - 2] (s >= 2)
    no_skip = torch.ones(N, L, dtype=torch.bool, device=dev)
    no_skip[:, 2:] = ext[:, 2:] == ext[:, :-2]
    alphas = [alpha]
    for t in range(1, T):
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg[:, :2], alpha[:, :-2]], dim=1).masked_fill(no_skip, NEG)
        alpha = torch.logsumexp(torch.stack([alpha, a1, a2]), dim=0) + emit[t]
        alphas.append(alpha)
    final = torch.stack(alphas)[input_lengths.long() - 1, torch.arange(N, device=dev)]  # [N, L]
    end1 = 2 * label_lengths.long()
    ends = torch.stack([end1, (end1 - 1) % L], dim=1)
    fa, fb = final.gather(1, ends).unbind(1)
    loss = -torch.logaddexp(fa, fb)
    if reduction == "mean":
        return (loss / label_lengths.to(loss.dtype)).mean()
    return _reduce(loss, reduction)
