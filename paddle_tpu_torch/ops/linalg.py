"""Linear algebra (counterpart of paddle_tpu/ops/linalg.py).

matmul, mm, bmm and einsum are white-listed under AMP (they run in the
low dtype under O1), norm and the rest follow their inputs. `eigh`
symmetrizes its input as the JAX package's (UPLO is accepted and
unused); `lstsq` is the SVD solution with numpy's residual, rank and
singular values (torch.linalg.lstsq's drivers differ between devices);
`lu` returns 1-based int32 pivots. The decompositions carry sign and
phase freedom: compare reconstructions, not factors.
"""
from __future__ import annotations

import torch

from ..framework import random as _random
from ._common import Tensor, _t, amp, amp1


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = amp("matmul", _t(x), _t(y))
    if transpose_x and a.ndim > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.ndim > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def mm(x, y):
    return matmul(x, y)


def bmm(x, y):
    return torch.matmul(*amp("bmm", _t(x), _t(y)))


def mv(x, vec):
    return torch.matmul(*amp("mv", _t(x), _t(vec)))


def _dims(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p=None, axis=None, keepdim=False, name=None):
    v = amp1("norm", _t(x))
    if p is None or p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(v)))
        ax = _dims(axis)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.matrix_norm(v, "fro", dim=ax, keepdim=keepdim)
        return torch.linalg.vector_norm(v, 2, dim=ax, keepdim=keepdim)
    if p == "nuc":
        return torch.linalg.matrix_norm(v, "nuc", dim=_dims(axis), keepdim=keepdim)
    if axis is None:
        return torch.linalg.vector_norm(v.reshape(-1), p)
    ax = _dims(axis)
    if isinstance(ax, tuple) and len(ax) == 2:
        return torch.linalg.matrix_norm(v, p, dim=ax, keepdim=keepdim)
    return torch.linalg.vector_norm(v, p, dim=ax, keepdim=keepdim)


def vector_norm(x, p=2.0, axis=None, keepdim=False):
    v = amp1("vector_norm", _t(x))
    if axis is None:
        return torch.linalg.vector_norm(v.reshape(-1), p, keepdim=keepdim)
    return torch.linalg.vector_norm(v, p, dim=_dims(axis), keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(amp1("matrix_norm", _t(x)), p, keepdim=keepdim)


def dist(x, y, p=2.0):
    a, b = amp("dist", _t(x), _t(y))
    d = (a - b).reshape(-1)
    if p == 0:
        return torch.sum(d != 0).to(a.dtype)
    if p == float("inf"):
        return torch.max(torch.abs(d))
    if p == float("-inf"):
        return torch.min(torch.abs(d))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def cdist(x, y, p=2.0):
    a, b = amp("cdist", _t(x), _t(y))
    d = a[..., :, None, :] - b[..., None, :, :]
    if p == float("inf"):
        return torch.amax(torch.abs(d), -1)
    return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(amp1("cholesky", _t(x)), upper=upper)


def cholesky_solve(x, y, upper=False):
    b, c = amp("cholesky_solve", _t(x), _t(y))
    return torch.cholesky_solve(b, c, upper=upper)


def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(amp1("qr", _t(x)), mode=mode)
    return (r,) if mode == "r" else (q, r)


def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(amp1("svd", _t(x)), full_matrices=full_matrices))


def svdvals(x):
    return torch.linalg.svdvals(amp1("svdvals", _t(x)))


def eig(x):
    w, v = torch.linalg.eig(_t(x).detach())
    return w, v


def eigvals(x):
    return torch.linalg.eigvals(_t(x).detach())


def _sym(v):
    return (v + v.transpose(-1, -2).conj()) / 2


def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(_sym(amp1("eigh", _t(x)))))


def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(_sym(amp1("eigvalsh", _t(x))))


def inv(x, name=None):
    return torch.linalg.inv(amp1("inv", _t(x)))


inverse = inv


def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(amp1("pinv", _t(x)), rtol=rcond, hermitian=hermitian)


def det(x):
    return torch.linalg.det(amp1("det", _t(x)))


def slogdet(x):
    return tuple(torch.linalg.slogdet(amp1("slogdet", _t(x))))


def solve(x, y, name=None):
    a, b = amp("solve", _t(x), _t(y))
    if b.ndim == a.ndim - 1:
        return torch.linalg.solve(a, b.unsqueeze(-1))[..., 0]
    return torch.linalg.solve(a, b)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a, b = amp("triangular_solve", _t(x), _t(y))
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper, unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None):
    """(solution, residuals, rank int64, singular values) as numpy's: the
    residuals are the squared column norms of b - a @ x when a has full
    column rank and more rows than columns, else empty."""
    a, b = amp("lstsq", _t(x), _t(y))
    m, n = a.shape[-2], a.shape[-1]
    sv = torch.linalg.svdvals(a)
    eps = torch.finfo(a.dtype).eps
    rtol = rcond if rcond is not None else eps * max(m, n)
    sol = torch.linalg.pinv(a, rtol=rtol) @ b
    rank = torch.sum(sv > rtol * sv[..., :1], -1).to(torch.int64)
    if m > n and bool((rank == n).all()):
        res = torch.sum(torch.square(b - a @ sol), -2)
    else:
        res = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return sol, res, rank, sv


def lu(x, pivot=True):
    lu_, piv = torch.linalg.lu_factor(amp1("lu", _t(x)), pivot=pivot)
    return lu_, piv.to(torch.int32)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(amp1("matrix_power", _t(x)), n)


def matrix_rank(x, tol=None, hermitian=False):
    v = _t(x)
    t = tol.item() if isinstance(tol, Tensor) else tol
    if t is None:
        return torch.linalg.matrix_rank(v).to(torch.int64)
    return torch.linalg.matrix_rank(v, rtol=t).to(torch.int64)


def cond(x, p=None):
    return torch.linalg.cond(amp1("cond", _t(x)), p)


def multi_dot(xs):
    return torch.linalg.multi_dot(list(amp("multi_dot", *[_t(x) for x in xs])))


def corrcoef(x, rowvar=True):
    v = amp1("corrcoef", _t(x))
    return torch.corrcoef(v if rowvar else v.t())


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    v = amp1("cov", _t(x))
    return torch.cov(v if rowvar else v.t(), correction=1 if ddof else 0,
                     fweights=_t(fweights) if fweights is not None else None,
                     aweights=_t(aweights) if aweights is not None else None)


def householder_product(x, tau):
    return torch.linalg.householder_product(*amp("householder_product", _t(x), _t(tau)))


def matrix_exp(x):
    return torch.linalg.matrix_exp(amp1("matrix_exp", _t(x)))


def pca_lowrank(x, q=None, center=True, niter=2):
    """The JAX package's: the leading q of a full SVD of the centered x."""
    v = amp1("pca_lowrank", _t(x))
    k = q if q is not None else min(6, *v.shape[-2:])
    vv = v - v.mean(-2, keepdim=True) if center else v
    u, s, vt = torch.linalg.svd(vv, full_matrices=False)
    return u[..., :k], s[..., :k], vt.transpose(-1, -2)[..., :k]


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD: a Gaussian sketch from the framework
    generator, `niter` power iterations, QR, then the SVD of the projection."""
    args = amp("svd_lowrank", _t(x), *([_t(M)] if M is not None else []))
    av = args[0] - args[1] if len(args) > 1 else args[0]
    m, n = av.shape[-2], av.shape[-1]
    k = min(q if q is not None else 6, m, n)
    gen = _random.generator(av.device)
    omega = torch.randn(av.shape[:-2] + (n, k), generator=gen, device=av.device,
                        dtype=torch.float32).to(av.dtype)
    y = av @ omega
    for _ in range(niter):
        y = av @ (av.transpose(-1, -2) @ y)
    qmat, _ = torch.linalg.qr(y)
    u, s, vh = torch.linalg.svd(qmat.transpose(-1, -2) @ av, full_matrices=False)
    return qmat @ u, s, vh.transpose(-1, -2)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(lu_data, 1-based pivots) -> (P, L unit-lower, U) with P @ L @ U = A."""
    lu_, piv = amp1("lu_unpack", _t(x)), _t(y)
    return tuple(torch.lu_unpack(lu_, piv.to(torch.int32)))


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and getattr(_v, "__module__", None) == __name__
           and callable(_v)]

# each public op is one recorded op of a static capture (core/record.py)
from ..core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
