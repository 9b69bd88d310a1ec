"""The losses (counterpart of paddle_tpu/nn/functional/loss.py): each
the JAX package's formula in torch ops, "mean" and "sum" reductions over
every element unless a loss says otherwise.

class_center_sample and margin_cross_entropy are the single-rank forms
(the class dimension is not sharded; `group` is ignored).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs
from ...framework import random as _random
from ...ops._common import _t


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",  # noqa: A002
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
    """paddle's cross_entropy: hard labels ([N] or [N, 1] ids, with
    `ignore_index`, class `weight` and `label_smoothing`) or soft labels
    (a distribution over `axis`); log_softmax of the input, or its log
    clipped to [1e-15, 1] with use_softmax=False. A "mean" over hard labels
    is sum(per) / max(sum of the kept labels' weights (or their count),
    1e-12); over soft labels the plain mean. Hard labels must have the
    input's shape without `axis` (or with a size-1 axis there), dimensions
    of size 1 broadcasting, else ValueError, as the JAX package's gather
    raises. The black-listed op "cross_entropy": f32 under AMP O1."""
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
        ids = _label_ids(ids, x.shape, axis)
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


def _label_ids(ids, shape, axis):
    """int64 ids broadcast to `shape` without `axis`; ValueError when they
    do not fit it."""
    want = list(shape)
    del want[axis]
    try:
        fits = ids.dim() == len(want) and list(torch.broadcast_shapes(ids.shape, want)) == want
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"label of shape {list(ids.shape)} does not fit an input of shape "
                         f"{list(shape)} along axis {axis}")
    return ids.long().expand(want)


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


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    """The per-example cross_entropy (no reduction) with a size-1 `axis`
    kept, as paddle returns it; with return_softmax, also softmax(logits)."""
    loss = cross_entropy(logits, label, soft_label=soft_label, ignore_index=ignore_index,
                         reduction="none", axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax

        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):  # noqa: A002
    """-input[label] over [N, C] (or [N, C, d...] with labels [N, d...]),
    class-weighted; "mean" divides by the kept labels' total weight."""
    v, ids = _t(input), _t(label).long()
    w = None if weight is None else _t(weight)
    if v.dim() > 2:
        c = v.shape[1]
        out = _nll_2d(v.movedim(1, -1).reshape(-1, c), ids.reshape(-1), w, ignore_index, reduction)
        return out.reshape(ids.shape) if reduction == "none" else out
    return _nll_2d(v, ids, w, ignore_index, reduction)


def _nll_2d(v, ids, w, ignore_index, reduction):
    mask = ids != ignore_index
    safe = torch.where(mask, ids, 0)
    per = -(v.gather(1, safe[:, None])[:, 0] if v.dim() > 1 else v.gather(0, safe))
    if w is not None:
        wsel = w[safe]
        per = per * wsel
    per = torch.where(mask, per, 0.0)
    if reduction == "mean":
        denom = torch.where(mask, wsel if w is not None else torch.ones_like(per), 0.0).sum()
        return per.sum() / denom.clamp_min(1e-12)
    return _reduce(per, reduction)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce((_t(input) - _t(label)).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce((_t(input) - _t(label)).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):  # noqa: A002
    """paddle's smooth L1: the Huber loss of delta, divided by delta, times
    delta (paddle multiplies by delta)."""
    d = _t(input) - _t(label)
    ad = d.abs()
    val = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
    return _reduce(val * delta, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean"):  # noqa: A002
    d = _t(input) - _t(label)
    ad = d.abs()
    return _reduce(torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta)), reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):  # noqa: A002
    """-(y log p + (1 - y) log(1 - p)) with p clipped to [1e-12, 1 - 1e-12]."""
    p = _t(input).clamp(1e-12, 1.0 - 1e-12)
    y = _t(label)
    per = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if weight is not None:
        per = per * _t(weight)
    return _reduce(per, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):  # noqa: A002
    """KL(label || exp(input)) elementwise: label * (log(max(label, 1e-12))
    - input), or exp(label) * (label - input) with log_target;
    "batchmean" divides the sum by the batch size."""
    logp, q = _t(input), _t(label)
    if log_target:
        per = torch.exp(q) * (q - logp)
    else:
        per = q * (torch.log(q.clamp_min(1e-12)) - logp)
    if reduction == "batchmean":
        return per.sum() / logp.shape[0]
    return _reduce(per, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):  # noqa: A002
    per = torch.clamp_min(-_t(label) * (_t(input) - _t(other)) + margin, 0.0)
    return _reduce(per, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean", name=None):  # noqa: A002
    x, y = _t(input), _t(label)
    return _reduce(torch.where(y == 1, x, torch.clamp_min(margin - x, 0.0)), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean", name=None):
    a, b, y = _t(input1), _t(input2), _t(label)
    cos = (a * b).sum(-1) / torch.clamp_min(a.norm(dim=-1) * b.norm(dim=-1), 1e-12)
    return _reduce(torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin, 0.0)), reduction)


def _pdist_rows(a, b, p):
    return ((a - b).abs() ** p).sum(dim=-1) ** (1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0, epsilon=1e-6,  # noqa: A002
                        swap=False, reduction="mean", name=None):
    a, pos, neg = _t(input), _t(positive), _t(negative)
    dp, dn = _pdist_rows(a, pos, p), _pdist_rows(a, neg, p)
    if swap:
        dn = torch.minimum(dn, _pdist_rows(pos, neg, p))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    p, y = _t(input), _t(label)
    return -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon)


def square_error_cost(input, label):  # noqa: A002
    return (_t(input) - _t(label)).square()


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0, reduction="sum",
                       name=None):
    z, y = _t(logit), _t(label)
    p = torch.sigmoid(z)
    ce = -(y * TF.logsigmoid(z) + (1 - y) * TF.logsigmoid(-z))
    pt = p * y + (1 - p) * (1 - y)
    a = alpha * y + (1 - alpha) * (1 - y)
    per = a * (1 - pt) ** gamma * ce
    if normalizer is not None:
        per = per / _t(normalizer)
    return _reduce(per, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """mean over the batch of 1 - 2 |p.l| / (|p| + |l| + eps), labels as
    [..., 1] ids (one-hot over input's last axis) or as a distribution."""
    p, lbl = _t(input), _t(label)
    if lbl.shape[-1] == 1:
        lf = (lbl[..., 0].unsqueeze(-1) == torch.arange(p.shape[-1], device=p.device)).to(p.dtype)
    else:
        lf = lbl.to(p.dtype)
    dims = tuple(range(1, p.dim()))
    inter = (p * lf).sum(dim=dims)
    union = p.sum(dim=dims) + lf.sum(dim=dims)
    return (1 - 2 * inter / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    a, p, lbl = _t(anchor), _t(positive), _t(labels)
    reg = l2_reg * ((a * a).sum() + (p * p).sum()) / a.shape[0] * 0.25
    same = (lbl[:, None] == lbl[None, :]).to(a.dtype)
    tgt = same / same.sum(dim=1, keepdim=True)
    ce = -(tgt * torch.log_softmax(a @ p.t(), dim=1)).sum(dim=1)
    return ce.mean() + reg


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0,
                         group=None, return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax cross-entropy: the target's cosine
    cos(theta) becomes cos(margin1 * theta + margin2) - margin3, every logit
    is scaled by `scale`; the per-example loss is [N, 1]."""
    lg, lb = _t(logits), _t(label)
    onehot = (lb.long().unsqueeze(-1) == torch.arange(lg.shape[1], device=lg.device)).to(lg.dtype)
    theta = torch.arccos(lg.clamp(-1.0, 1.0))
    modified = torch.cos(margin1 * theta + margin2) - margin3
    logp = torch.log_softmax(torch.where(onehot > 0, modified, lg) * scale, dim=-1)
    loss = _reduce(-(onehot * logp).sum(dim=-1, keepdim=True), reduction)
    return (loss, torch.exp(logp)) if return_softmax else loss


def class_center_sample(label, num_classes, num_samples, group=None):
    """Partial-FC sampling: every positive class, then negatives drawn
    uniformly (framework generator) up to num_samples; returns the labels
    remapped into the sampled index space and the sampled class ids
    (positives first, ascending)."""
    lbl = _t(label)
    lb = lbl.cpu().numpy()
    pos = np.unique(lb)
    if pos.size >= num_samples:
        sampled = pos
    else:
        neg_pool = np.setdiff1d(np.arange(num_classes), pos, assume_unique=True)
        perm = torch.randperm(neg_pool.size, generator=_random.generator("cpu")).numpy()
        sampled = np.concatenate([pos, neg_pool[perm[:num_samples - pos.size]]])
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(sampled.size)
    return (torch.from_numpy(remap[lb]).to(lbl.device),
            torch.from_numpy(sampled.astype(np.int64)).to(lbl.device))


def _softplus_bce(logit, code):
    """BCE of a logit against a 0/1 code: max(z, 0) - z c + log1p(exp(-|z|))."""
    return torch.clamp_min(logit, 0) - logit * code + torch.log1p(torch.exp(-logit.abs()))


def hsigmoid_loss(input, label, num_classes, weight, bias=None, path_table=None, path_code=None,
                  is_sparse=False, name=None):
    """Hierarchical sigmoid: the summed BCE along the label's path, [N, 1].
    The default tree is the complete binary tree of paddle's SimpleCode
    (code = label + num_classes; node (code >> (bit + 1)) - 1, branch bit
    (code >> bit) & 1); a custom one comes as path_table / path_code rows
    (-1 ends a path)."""
    x, lb, w = _t(input), _t(label).long(), _t(weight)
    b = None if bias is None else _t(bias)
    if path_table is not None or path_code is not None:
        tbl = _t(path_table)[lb].long()
        code = _t(path_code)[lb].to(x.dtype)
        valid = tbl >= 0
        node = tbl.clamp_min(0)
    else:
        max_len = int(np.floor(np.log2(max(2 * num_classes - 1, 2))))
        c = lb + num_classes
        length = torch.floor(torch.log2(c.float() + 0.5)).long()
        bits = torch.arange(max_len, device=x.device)
        valid = bits[None, :] < length[:, None]
        node = ((c[:, None] >> (bits[None, :] + 1)) - 1).clamp_min(0)
        code = ((c[:, None] >> bits[None, :]) & 1).to(x.dtype)
    logit = torch.einsum("nld,nd->nl", w[node], x)
    if b is not None:
        logit = logit + b[node]
    return torch.where(valid, _softplus_bce(logit, code), 0.0).sum(-1, keepdim=True)


class _FastEmit(torch.autograd.Function):
    """The loss unchanged; its gradient at the label (emit) entries of the
    logits scaled by 1 + lambda (the warp-transducer fork's FastEmit)."""

    @staticmethod
    def forward(ctx, logits, labels, lam):
        ctx.save_for_backward(labels)
        ctx.lam = lam
        return logits.clone()

    @staticmethod
    def backward(ctx, g):
        (labels,) = ctx.saved_tensors
        b, _, u1, v = g.shape
        onehot = (labels.clamp_min(0).long().unsqueeze(-1)
                  == torch.arange(v, device=g.device)).to(g.dtype)  # [B, U, V]
        scale = torch.cat([1.0 + ctx.lam * onehot, torch.ones(b, 1, v, dtype=g.dtype,
                                                              device=g.device)], dim=1)
        return g * scale[:, None], None, None


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0, fastemit_lambda=0.0,
              reduction="mean", name=None):
    """RNN-T: -log p(label | input) by the forward recursion over (T, U+1)
    in f32 log space, logits [B, T, U+1, V]; with fastemit_lambda the
    label arcs' gradients scale by 1 + lambda (the loss does not change)."""
    logits, lb = _t(input), _t(label).long()
    tl, ul = _t(input_lengths).long(), _t(label_lengths).long()
    if fastemit_lambda:
        logits = _FastEmit.apply(logits, lb, float(fastemit_lambda))
    B, T, U1, _ = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    blank_lp = logp[..., blank]  # [B, T, U+1]
    emit_lp = logp[:, :, :U1 - 1, :].gather(
        -1, lb.clamp_min(0)[:, None, :, None].expand(B, T, U1 - 1, 1))[..., 0]  # [B, T, U]
    neg = torch.tensor(-1e30, device=logp.device)
    uidx = torch.arange(U1, device=logp.device)[None, :]
    init_fb = torch.full((B, U1), -1e30, device=logp.device)
    init_fb[:, 0] = 0.0
    alpha = init_fb
    ll = torch.full((B,), -1e30, device=logp.device)
    for t in range(T):
        from_blank = init_fb if t == 0 else alpha + blank_lp[:, t - 1, :]
        cols = [from_blank[:, 0]]
        for u in range(1, U1):
            cols.append(torch.logaddexp(from_blank[:, u], cols[-1] + emit_lp[:, t, u - 1]))
        alpha_t = torch.where(uidx <= ul[:, None], torch.stack(cols, dim=1), neg)
        alpha = torch.where((t < tl)[:, None], alpha_t, alpha)
        end = alpha.gather(1, ul[:, None])[:, 0] + blank_lp[:, t].gather(1, ul[:, None])[:, 0]
        ll = torch.where(t == tl - 1, end, ll)
    loss = -ll
    return _reduce(loss, reduction)


def edit_distance(input, label, normalized=True, ignored_tokens=None, input_length=None,  # noqa: A002
                  label_length=None, name=None):
    """Levenshtein distances of the rows (a host loop): ([N, 1] f32,
    [1] int64 the number of rows); normalized divides by the label's length."""
    a, b = _t(input).cpu().numpy(), _t(label).cpu().numpy()
    il = None if input_length is None else _t(input_length).cpu().numpy()
    ll = None if label_length is None else _t(label_length).cpu().numpy()
    ign = set(ignored_tokens or ())
    out = np.zeros((a.shape[0], 1), np.float32)
    for i in range(a.shape[0]):
        s1 = [t for t in (a[i][:int(il[i])] if il is not None else a[i]).tolist() if t not in ign]
        s2 = [t for t in (b[i][:int(ll[i])] if ll is not None else b[i]).tolist() if t not in ign]
        dp = list(range(len(s2) + 1))
        for x_ in range(1, len(s1) + 1):
            prev, dp[0] = dp[:], x_
            for y_ in range(1, len(s2) + 1):
                dp[y_] = min(prev[y_] + 1, dp[y_ - 1] + 1,
                             prev[y_ - 1] + (s1[x_ - 1] != s2[y_ - 1]))
        out[i, 0] = dp[-1] / max(len(s2), 1) if normalized else dp[-1]
    dev = _t(input).device
    return torch.from_numpy(out).to(dev), torch.tensor([a.shape[0]], dtype=torch.int64, device=dev)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6, reduction="mean",  # noqa: A002
                      name=None):
    x, y, var = _t(input), _t(label), _t(variance).clamp_min(epsilon)
    per = 0.5 * (torch.log(var) + (x - y) ** 2 / var)
    if full:
        per = per + 0.5 * math.log(2 * math.pi)
    return _reduce(per, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8, reduction="mean",  # noqa: A002
                     name=None):
    x, y = _t(input), _t(label)
    per = torch.exp(x) - y * x if log_input else x - y * torch.log(x + epsilon)
    if full:
        stirling = y * torch.log(y) - y + 0.5 * torch.log(2 * math.pi * y)
        per = per + torch.where(y > 1, stirling, 0.0)
    return _reduce(per, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    x = _t(input)
    z = -_t(label).to(x.dtype) * x
    return _reduce(torch.log1p(torch.exp(-z.abs())) + torch.clamp_min(z, 0.0), reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean", name=None):  # noqa: A002
    x, y = _t(input), _t(label)
    per = -(y * TF.logsigmoid(x) + (1 - y) * TF.logsigmoid(-x))
    if weight is not None:
        per = per * _t(weight)
    return _reduce(per.mean(dim=-1), reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None, reduction="mean",  # noqa: A002
                      name=None):
    """sum over j != y of max(0, margin - x_y + x_j)^p / C."""
    x, y = _t(input), _t(label).long()
    c = x.shape[1]
    m = torch.clamp_min(margin - x.gather(1, y[:, None]) + x, 0.0) ** p
    m = m * (y[:, None] != torch.arange(c, device=x.device)).to(x.dtype)
    if weight is not None:
        m = m * _t(weight)[y][:, None]
    return _reduce(m.sum(dim=1) / c, reduction)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """||x - y + epsilon||_p along the last axis."""
    d = _t(x) - _t(y) + epsilon
    if p == float("inf"):
        return d.abs().amax(dim=-1, keepdim=keepdim)
    if p == float("-inf"):
        return d.abs().amin(dim=-1, keepdim=keepdim)
    if p == 0:
        return (d != 0).to(d.dtype).sum(dim=-1, keepdim=keepdim)
    return (d.abs() ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


def triplet_margin_with_distance_loss(input, positive, negative, distance_function=None,  # noqa: A002
                                      margin=1.0, swap=False, reduction="mean", name=None):
    dist = distance_function or (lambda a, b: pairwise_distance(a, b, p=2.0))
    a, pos, neg = _t(input), _t(positive), _t(negative)
    dp, dn = _t(dist(a, pos)), _t(dist(a, neg))
    if swap:
        dn = torch.minimum(dn, _t(dist(pos, neg)))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)

# each public op is one recorded op of a static capture (core/record.py)
from ...core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
