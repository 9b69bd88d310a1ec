"""Metrics (counterpart of paddle_tpu/metric/__init__.py): `accuracy`,
`Metric`, `Accuracy`, `Precision`, `Recall`, `Auc`.

`accuracy` and `Accuracy.compute` run on the inputs' device (a stable
descending argsort: ties go to the lower class id, as jnp.argsort of the
negation); `update` and `accumulate` count on the host, one read a batch,
as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops._common import _t


def _topk_ids(pred: torch.Tensor, k: int) -> torch.Tensor:
    return torch.argsort(-pred, dim=-1, stable=True)[..., :k]


def accuracy(input, label, k=1, correct=None, total=None):  # noqa: A002
    """The share of rows whose label is among the k highest scores (0-d f32)."""
    pred, lbl = _t(input).detach(), _t(label)
    hit = (_topk_ids(pred, k) == lbl.reshape(-1, 1)).any(-1)
    return hit.to(torch.float32).mean()


def _host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError


class Accuracy(Metric):
    def __init__(self, topk=(1,), name="acc"):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        """[N, max(topk)] float32: 1 where the i-th best class is the label."""
        pred, label = _t(pred).detach(), _t(label)
        if label.ndim == pred.ndim:
            label = label.squeeze(-1)
        top = _topk_ids(pred, max(self.topk))
        return (top == label.unsqueeze(-1)).to(torch.float32)

    def update(self, correct):
        c = _host(correct)
        n = c.shape[0] if c.ndim else 1
        for i, k in enumerate(self.topk):
            self.total[i] += c[..., :k].any(-1).sum()
            self.count[i] += n
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = (self.total / np.maximum(self.count, 1)).tolist()
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        return [f"{self._name}_top{k}" for k in self.topk] if len(self.topk) > 1 else [self._name]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_host(preds) > 0.5).astype(int).reshape(-1)
        lab = _host(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_host(preds) > 0.5).astype(int).reshape(-1)
        lab = _host(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _host(preds)
        if p.ndim == 2:
            p = p[:, -1]
        lab = _host(labels).reshape(-1)
        bins = np.round(p * self.num_thresholds).astype(int)
        np.add.at(self._stat_pos, bins[lab != 0], 1)
        np.add.at(self._stat_neg, bins[lab == 0], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name
