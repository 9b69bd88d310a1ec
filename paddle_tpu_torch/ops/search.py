"""Search and sort (counterpart of paddle_tpu/ops/search.py).

paddle's forms: `sort` returns the values, `argmax`/`argsort` int64,
`mode` the smallest most frequent value with the index of its last
occurrence, `median` the mean of the two middle values (mode="min": the
lower one), `histogram` ignores values outside [min, max] (int64 counts
unless weighted or a density). `top_p_sampling` draws from the framework
generator (or a generator of its own for an explicit seed).
"""
from __future__ import annotations

import builtins

import torch

from ..framework import dtype as _dtype
from ..framework import random as _random
from ._common import Tensor, _t, amp1, inexact


def _arg(fn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        v = _t(x)
        d = _dtype.convert_dtype(dtype)
        if axis is None:
            out = fn(v.reshape(-1))
            return (out.reshape((1,) * v.ndim) if keepdim else out).to(d)
        return fn(v, dim=axis, keepdim=keepdim).to(d)

    return op


argmax = _arg(torch.argmax)
argmin = _arg(torch.argmin)
argmax.__name__ = argmax.__qualname__ = "argmax"
argmin.__name__ = argmin.__qualname__ = "argmin"


def argsort(x, axis=-1, descending=False, stable=True, name=None):
    return torch.argsort(_t(x), dim=axis, descending=descending, stable=stable)


def sort(x, axis=-1, descending=False, stable=True, name=None):
    return torch.sort(amp1("sort", _t(x)), dim=axis, descending=descending, stable=stable).values


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    x = amp1("topk", _t(x))
    k = int(k.item()) if isinstance(k, Tensor) else int(k)
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return vals, idx


def kthvalue(x, k, axis=-1, keepdim=False):
    vals, idx = torch.kthvalue(amp1("kthvalue", _t(x)), k, dim=axis, keepdim=keepdim)
    return vals, idx


def mode(x, axis=-1, keepdim=False):
    v = amp1("mode_values", _t(x))
    sm = torch.movedim(torch.sort(v, dim=axis).values, axis, -1)
    eq = (sm[..., 1:] == sm[..., :-1]).to(torch.int64)
    runs = torch.cat([torch.zeros(eq.shape[:-1] + (1,), dtype=torch.int64, device=v.device),
                      torch.cumsum(eq, -1) * eq], -1)
    best = torch.argmax(runs, -1, keepdim=True)
    vals = torch.take_along_dim(sm, best, dim=-1)[..., 0]
    target = vals.detach().unsqueeze(axis)
    n = v.shape[axis]
    pos = torch.arange(n, device=v.device).reshape([-1 if i == axis % v.ndim else 1
                                                    for i in range(v.ndim)])
    last = torch.amax(torch.where(v == target, pos, torch.full_like(pos, -1)), dim=axis,
                      keepdim=keepdim)
    return (vals.unsqueeze(axis) if keepdim else vals), last


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    s, v = _t(sorted_sequence), _t(values)
    if s.ndim > 1:
        v = v.contiguous()
    return torch.searchsorted(s.contiguous(), v, out_int32=out_int32, right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def median(x, axis=None, keepdim=False, mode="avg"):
    v = amp1("median", _t(x))
    vv, ax = (v.reshape(-1), 0) if axis is None else (v, axis)
    s = torch.sort(vv, dim=ax).values
    n = s.shape[ax]
    lo = torch.select(s, ax, (n - 1) // 2)
    if mode == "avg":
        lo = inexact(lo)
        out = (lo + inexact(torch.select(s, ax, n // 2))) / 2 if n % 2 == 0 else lo
    else:
        out = lo
    if keepdim:
        out = out.reshape((1,) * v.ndim) if axis is None else out.unsqueeze(ax)
    return out


def nanmedian(x, axis=None, keepdim=False):
    v = inexact(amp1("nanmedian", _t(x)))
    if axis is None:
        out = torch.nanquantile(v.reshape(-1), 0.5)
        return out.reshape((1,) * v.ndim) if keepdim else out
    return torch.nanquantile(v, 0.5, dim=axis, keepdim=keepdim)


def _quantile(fn, v, q, axis, keepdim, interpolation="linear"):
    qv = _t(q, v.device).to(v.dtype) if isinstance(q, (list, tuple, Tensor)) else float(q)
    if axis is None:
        out = fn(v.reshape(-1), qv, interpolation=interpolation)
        if keepdim:
            out = out.reshape(out.shape + (1,) * v.ndim)
        return out
    if isinstance(axis, (list, tuple)):  # move the axes last and merge them
        ax = sorted(a % v.ndim for a in axis)
        rest = [i for i in range(v.ndim) if i not in ax]
        m = v.permute(rest + ax).reshape([v.shape[i] for i in rest] + [-1])
        out = fn(m, qv, dim=-1, interpolation=interpolation)
        if keepdim:
            for a in ax:
                out = out.unsqueeze(a + (out.ndim - len(rest)))
        return out
    return fn(v, qv, dim=axis, keepdim=keepdim, interpolation=interpolation)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    v = inexact(amp1("quantile", _t(x)))
    return _quantile(torch.quantile, v, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False):
    v = inexact(amp1("nanquantile", _t(x)))
    return _quantile(torch.nanquantile, v, q, axis, keepdim)


def _bin_index(v, lo, hi, bins):
    """numpy's bin of each value in [lo, hi] (the last bin closed), and
    whether it lies in the range."""
    inside = (v >= lo) & (v <= hi)
    idx = torch.floor((v - lo) / (hi - lo) * bins).to(torch.int64).clamp(0, bins - 1)
    return idx, inside


def histogram(x, bins=100, min=0, max=0, weight=None, density=False):  # noqa: A002
    v = _t(x)
    if min == 0 and max == 0:
        lo, hi = float(v.min()), float(v.max())
    else:
        lo, hi = float(min), float(max)
    if lo == hi:  # numpy widens an empty range by 0.5 on each side
        lo, hi = lo - 0.5, hi + 0.5
    vf = v.to(torch.float64).reshape(-1)
    idx, inside = _bin_index(vf, lo, hi, bins)
    w = _t(weight).reshape(-1) if weight is not None else None
    wts = inside.to(torch.float64) if w is None else torch.where(inside, w.to(torch.float64), 0.0)
    h = torch.zeros(bins, dtype=torch.float64, device=v.device).index_add_(0, idx, wts)
    if density:
        return (h / (h.sum() * (hi - lo) / bins)).to(inexact(v).dtype if w is None else w.dtype)
    if w is not None:
        return h.to(w.dtype)
    return h.to(torch.int64)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None):
    v = _t(x)
    d = v.shape[-1]
    pts = v.reshape(-1, d).to(torch.float64)
    nb = [int(b) for b in bins] if isinstance(bins, (list, tuple)) else [int(bins)] * d
    flat = torch.zeros(pts.shape[0], dtype=torch.int64, device=v.device)
    ok = torch.ones(pts.shape[0], dtype=torch.bool, device=v.device)
    edges = []
    for j in range(d):
        if ranges is not None:
            lo, hi = float(ranges[2 * j]), float(ranges[2 * j + 1])
        else:
            lo, hi = float(pts[:, j].min()), float(pts[:, j].max())
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        idx, inside = _bin_index(pts[:, j], lo, hi, nb[j])
        flat = flat * nb[j] + idx
        ok &= inside
        edges.append(torch.linspace(lo, hi, nb[j] + 1, dtype=torch.float64,
                                    device=v.device).to(inexact(v).dtype))
    w = _t(weights).reshape(-1).to(torch.float64) if weights is not None else \
        torch.ones(pts.shape[0], dtype=torch.float64, device=v.device)
    total = 1
    for b in nb:
        total *= b
    h = torch.zeros(total, dtype=torch.float64, device=v.device).index_add_(
        0, flat, torch.where(ok, w, 0.0)).reshape(nb)
    if density:
        vol = 1.0
        for j, e in enumerate(edges):
            vol *= float(e[1] - e[0])
        h = h / (h.sum() * vol)
    elif weights is None:
        return h.to(torch.int64), edges
    return h.to(inexact(v).dtype), edges


def bincount(x, weights=None, minlength=0):
    x = _t(x)
    length = builtins.max(int(x.max()) + 1 if x.numel() else 0, minlength)
    if weights is None:
        return torch.bincount(x, minlength=length).to(torch.int64)
    w = _t(weights)
    return torch.bincount(x, weights=w, minlength=length).to(w.dtype)


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling: keep the smallest prefix of the descending-sorted
    probs whose sum reaches ps, renormalize, sample one id per row.
    Returns (sampled probs [N, 1], sampled ids [N, 1] int64)."""
    x, ps = _t(x), _t(ps)
    if seed in (None, -1):
        gen = _random.generator(x.device)
    else:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    sv, si = torch.sort(x, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sv, -1)
    keep = (cum - sv) < ps.reshape(-1, 1).to(sv.dtype)
    if threshold is not None:
        thr = threshold.to(sv.dtype) if isinstance(threshold, Tensor) else threshold
        keep = keep & (sv >= thr)
        keep[:, 0] = True
    probs = torch.where(keep, sv, torch.zeros_like(sv))
    probs = probs / probs.sum(-1, keepdim=True)
    pos = torch.multinomial(probs.float(), 1, generator=gen)
    ids = torch.gather(si, -1, pos)
    return torch.gather(x, -1, ids), ids.to(torch.int64)



__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and getattr(_v, "__module__", None) == __name__
           and callable(_v)]

# each public op is one recorded op of a static capture (core/record.py)
from ..core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
