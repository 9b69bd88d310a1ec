"""Optimizer base, SGD, Momentum, Adam and AdamW (counterpart of
paddle_tpu/optimizer/optimizer.py).

`step()` updates the parameters in place from their `.grad`. With
`FLAGS_fused_optimizer` on, Adam/AdamW go through the flat-bucket engine
(fused_engine.py), one fused AdamW kernel launch per bucket per step.
With it off they take the JAX package's per-tensor path in plain torch
(the JAX package leaves that path to XLA): parameters of one
(weight decay, lr scale) group that share a shape update as one stacked
tensor (`_apply_fused`), a lone parameter alone (`_apply_one`). SGD and
Momentum update tensor by tensor, in plain torch, as the JAX package
does. The update math and its rounding points are the JAX package's.

The learning rate is a number or an LRScheduler (lr.py); `step()` reads
the scheduler's `last_lr` and rounds it to f32, as the JAX package does.
`weight_decay` is a float, an L2Decay or an L1Decay (regularizer.py).
State moves between the two Adam paths (and between buckets when the set
of parameters with a gradient changes) through `_pending_state`, as in
the JAX package. Not ported yet: `state_dict`/`set_state_dict`, param
groups (a list of dicts raises) and per-param lr scales or regularizers,
the optimizers other than SGD, Momentum, Adam and AdamW.
"""
from __future__ import annotations

import numbers
from collections import defaultdict

import numpy as np
import torch

from ..framework import dtype as _dtype
from ..framework import flags as _flags
from ..framework import random as _random
from ..ops.fused_optimizer import _sr_bits_flat, _update_math
from ..regularizer import L1Decay
from .lr import LRScheduler


def _f32(x) -> float:
    """x rounded to float32, as a Python float (exact in f32)."""
    return float(np.float32(x))


def _wd_value(weight_decay) -> float:
    """The coefficient of a float, an L1Decay/L2Decay or None."""
    if weight_decay is None:
        return 0.0
    return float(getattr(weight_decay, "_coeff", weight_decay))


def _sr_round(x32: torch.Tensor, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """f32 -> `dtype` with stochastic rounding keyed by the element's index
    in `x32` (paddle_tpu/optimizer/optimizer.py:402-426)."""
    if dtype == torch.float32:
        return x32
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic rounding to {dtype} is not supported")
    idx = torch.arange(x32.numel(), dtype=torch.int64, device=x32.device)
    return _sr_bits_flat(x32.reshape(-1), idx, seed).reshape(x32.shape).to(torch.bfloat16)


def _m2_dtype_from(kw) -> torch.dtype:
    """moment2_dtype: float32 (default) or bfloat16."""
    v = kw.pop("moment2_dtype", None)
    if v in (None, "float32", torch.float32):
        return torch.float32
    if v in ("bfloat16", "bf16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"moment2_dtype must be float32 or bfloat16, got {v!r}")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph mode)")
        self._lr_scheduler = learning_rate if isinstance(learning_rate, LRScheduler) else None
        if self._lr_scheduler is None and not isinstance(learning_rate, numbers.Real):
            raise TypeError(f"learning_rate must be a number or an LRScheduler, got {learning_rate!r}")
        self._params = self._build_params(parameters)
        # the JAX package keeps it as an f32 scalar
        self._lr = _f32(self._lr_scheduler.last_lr if self._lr_scheduler else learning_rate)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators: dict = defaultdict(dict)  # name -> {id(param): tensor or f32}
        self._pending_state: dict = {}  # (name, id(param)) -> value awaiting a new home
        self._fused_buckets: dict = {}  # ids tuple -> stacked bucket (see Adam._apply_fused)
        self._flat_engine = None  # FLAGS_fused_optimizer engine (fused_engine.py)

    # ---- params ----
    def _build_params(self, parameters):
        """A list of params, or of (name, param) pairs (`named_parameters()`:
        torch tensors carry no paddle-style name, so this is how a name
        reaches `apply_decay_param_fun`)."""
        self._param_names = {}
        params = []
        for x in parameters:
            if isinstance(x, dict):
                raise NotImplementedError("param groups (a list of dicts) are not ported yet "
                                          "(ROADMAP Queue A item 2); pass the parameters")
            if isinstance(x, tuple):
                self._param_names[id(x[1])] = x[0]
                x = x[1]
            params.append(x)
        return params

    # ---- lr ----
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return self._lr_scheduler.last_lr
        return self._lr

    def set_lr(self, value: float) -> None:
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = _f32(value)

    def set_lr_scheduler(self, scheduler) -> None:
        self._lr_scheduler = scheduler

    def _sync_lr(self) -> None:
        if self._lr_scheduler is not None:
            self._lr = _f32(self._lr_scheduler.last_lr)

    def _lr_value(self, lr_scale) -> float:
        """The lr of an entry; every entry's scale is 1.0 (per-param lr
        scales and param groups are not ported)."""
        return self._lr

    # ---- accumulators ----
    def _add_accumulator(self, name, param, fill=0.0, dtype=None):
        key = id(param)
        store = self._accumulators[name]
        if key not in store:
            pending = self._pending_state.pop((name, key), None)
            if pending is not None:
                store[key] = pending
            else:
                d = dtype or (torch.float32 if param.dtype == torch.bfloat16 else param.dtype)
                store[key] = torch.full_like(param, fill, dtype=d)
        return store[key]

    def _pop_param_state(self, name, pid):
        """A param's state for a new bucket: pending first, then its
        per-param accumulator."""
        v = self._pending_state.pop((name, pid), None)
        return v if v is not None else self._accumulators.get(name, {}).pop(pid, None)

    # ---- the step ----
    @torch.no_grad()
    def step(self) -> None:
        self._sync_lr()
        self._step_impl()

    def _step_impl(self):
        entries = self._collect_entries()
        if entries and self._grad_clip is not None:
            pgs = self._grad_clip([(p, g) for p, g, _, _ in entries])
            entries = [(p, g2, wd, s) for (p, _, wd, s), (_, g2) in zip(entries, pgs)]
        self._apply_entries(entries)

    def _collect_entries(self):
        """[(param, grad, weight_decay, lr_scale)] for every param with a
        grad, grads UNCLIPPED (the JAX package's single-group case)."""
        return [(p, p.grad, self._weight_decay, 1.0) for p in self._params
                if p.requires_grad and p.grad is not None]

    def _apply_entries(self, entries):
        for p, g, wd, s in entries:
            self._apply_one(p, g, wd, s)

    def _apply_one(self, param, grad, weight_decay, lr_scale):
        raise NotImplementedError

    @staticmethod
    def _decayed_grad(param, grad, weight_decay):
        """The weight decay folded into the gradient (SGD and Momentum):
        grad + wd * param for a float or an L2Decay, grad + wd * sign(param)
        for an L1Decay, in the gradient's type."""
        wd = _wd_value(weight_decay)
        if not wd:
            return grad
        pv = param.to(grad.dtype)
        wd = _dtype.round_to(wd, grad.dtype)
        if isinstance(weight_decay, L1Decay):
            return grad + wd * torch.sign(pv)
        return grad + wd * pv

    def clear_grad(self, set_to_zero=False) -> None:
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    # ---- stacked buckets (the per-tensor path's fusion) ----
    def _defuse_bucket(self, st):
        """Dissolve one stacked bucket into per-param pending state."""
        for grp in st["groups"]:
            for i, pid in enumerate(grp["ids"]):
                for nm in ("moment1", "moment2"):
                    self._pending_state[(nm, pid)] = grp[nm][i]
                for nm in ("beta1_pow", "beta2_pow"):
                    self._pending_state[(nm, pid)] = st[nm]

    def _defuse_all(self):
        for st in list(self._fused_buckets.values()):
            self._defuse_bucket(st)
        self._fused_buckets.clear()
        if self._flat_engine is not None:
            self._flat_engine.defuse_all()


class SGD(Optimizer):
    """p -= lr * (grad + decay), in p's type."""

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)

    def _apply_one(self, p, g, wd, lr_scale):
        gv = self._decayed_grad(p, g, wd)
        lr = _dtype.round_to(self._lr_value(lr_scale), p.dtype)
        p.copy_(p - lr * gv.to(p.dtype))


class Momentum(Optimizer):
    """v = momentum * v + (grad + decay) in the velocity's type (f32 for an
    f32 or bf16 param); p -= lr * v, or with use_nesterov
    p -= lr * (grad + decay + momentum * v), in p's type."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None, use_nesterov=False,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _apply_one(self, p, g, wd, lr_scale):
        vel = self._add_accumulator("velocity", p)
        gv = self._decayed_grad(p, g, wd)
        v_new = _dtype.round_to(self._momentum, vel.dtype) * vel + gv.to(vel.dtype)
        if self._nesterov:
            upd = gv.to(p.dtype) + _dtype.round_to(self._momentum, p.dtype) * v_new.to(p.dtype)
        else:
            upd = v_new.to(p.dtype)
        vel.copy_(v_new)
        p.copy_(p - _dtype.round_to(self._lr_value(lr_scale), p.dtype) * upd)


class Adam(Optimizer):
    _wd_mode = "l2"  # Adam folds the decay into the gradient; AdamW decouples it

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, parameters=None,
                 weight_decay=None, grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None, **kw):
        self._m2_dtype = _m2_dtype_from(kw)
        kw.pop("use_multi_tensor", None)  # accepted and inert, as in the JAX package
        if kw:
            raise TypeError(f"{type(self).__name__}() got unexpected keyword argument(s) {sorted(kw)}")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._multi_precision = multi_precision

    def _m2_key(self) -> int:
        """Per-step uint32 seed of the stochastic rounding of a bf16 moment2."""
        return _random.next_uint32()

    def _effective_wd(self, p, wd):
        return wd

    def _use_flat_fusion(self) -> bool:
        """FLAGS_fused_optimizer, read every step so set_flags() takes effect live."""
        return bool(_flags.get_flag("FLAGS_fused_optimizer"))

    def _flat_engine_or_create(self):
        if self._flat_engine is None:
            from .fused_engine import FlatAdamWEngine

            self._flat_engine = FlatAdamWEngine(self)
        return self._flat_engine

    def _step_impl(self):
        if self._use_flat_fusion():
            self._flat_engine_or_create().step(self._grad_clip, self._collect_entries())
            return
        if self._flat_engine is not None and self._flat_engine.buckets:
            # the flag went off mid-training: flat state moves to per-param pending
            self._flat_engine.defuse_all()
        super()._step_impl()

    def _apply_entries(self, entries):
        """Params of one (wd, lr_scale) bucket that share a shape update as
        one stacked tensor; a bucket of one param takes _apply_one."""
        buckets, rest = self._fuse_partition(entries)
        for (wdv, s), plist in buckets.items():
            if len(plist) == 1:
                self._apply_one(plist[0][0], plist[0][1], wdv, s)
            else:
                self._apply_fused(plist, wdv, s)
        for p, g, wd, s in rest:
            self._apply_one(p, g, wd, s)

    def _fuse_partition(self, entries):
        buckets = defaultdict(list)
        rest = []
        for p, g, wd, s in entries:
            wd = self._effective_wd(p, wd)
            if p.dtype == torch.float32 and g.shape == p.shape:
                buckets[(_wd_value(wd), float(s))].append((p, g))
            else:
                rest.append((p, g, wd, s))
        return buckets, rest

    def _build_bucket(self, plist):
        ids = tuple(id(p) for p, _ in plist)
        new_ids = set(ids)
        for old_ids, old_st in list(self._fused_buckets.items()):
            if new_ids.intersection(old_ids):
                self._defuse_bucket(old_st)
                del self._fused_buckets[old_ids]
        by_shape = defaultdict(list)
        for p, _ in plist:
            by_shape[tuple(p.shape)].append(p)

        def gather(name, group):
            dt = self._m2_dtype if name == "moment2" else torch.float32
            parts = [self._pop_param_state(name, id(p)) for p in group]
            return torch.stack([torch.zeros(p.shape, dtype=dt, device=p.device) if x is None
                                else x.to(dt) for p, x in zip(group, parts)])

        def gather_scalar(name):
            vals = [self._pop_param_state(name, id(p)) for p, _ in plist]
            return next((v for v in vals if v is not None), np.float32(1.0))

        st = {
            "groups": [{"ids": tuple(id(p) for p in group),
                        "moment1": gather("moment1", group),
                        "moment2": gather("moment2", group)}
                       for group in by_shape.values()],
            "beta1_pow": gather_scalar("beta1_pow"),
            "beta2_pow": gather_scalar("beta2_pow"),
        }
        self._fused_buckets[ids] = st
        return st

    def _update(self, p, m, v, g, wdv, lr, b1p, b2p):
        """The shared element update (ops/fused_optimizer._update_math) at
        the bias corrections of the step after (beta1_pow, beta2_pow);
        returns (p', m', v' as f32, new beta1_pow, new beta2_pow)."""
        b1p_new = np.float32(b1p) * np.float32(self._beta1)
        b2p_new = np.float32(b2p) * np.float32(self._beta2)
        c1 = float(np.float32(1.0) - b1p_new)
        c2 = float(np.float32(1.0) - b2p_new)
        p2, m2, v2 = _update_math(p, m, v, g, lr, 1.0, c1, c2, beta1=self._beta1,
                                  beta2=self._beta2, eps=self._eps, wd=wdv,
                                  decoupled=self._wd_mode == "decoupled")
        return p2, m2, v2, b1p_new, b2p_new

    def _store_m2(self, v_new):
        return (v_new if self._m2_dtype == torch.float32
                else _sr_round(v_new, self._m2_dtype, self._m2_key()))

    def _apply_fused(self, plist, wdv, lr_scale):
        ids = tuple(id(p) for p, _ in plist)
        st = self._fused_buckets.get(ids) or self._build_bucket(plist)
        lr = self._lr_value(lr_scale)
        by_id = {id(p): (p, g) for p, g in plist}
        for grp in st["groups"]:
            pgs = [by_id[pid] for pid in grp["ids"]]
            G = torch.stack([g for _, g in pgs]).float()
            P = torch.stack([p for p, _ in pgs])
            P2, grp["moment1"], v_new, b1p_new, b2p_new = self._update(
                P, grp["moment1"], grp["moment2"].float(), G, wdv, lr, st["beta1_pow"],
                st["beta2_pow"])
            grp["moment2"] = self._store_m2(v_new)
            for i, (p, _) in enumerate(pgs):
                p.copy_(P2[i])
        st["beta1_pow"], st["beta2_pow"] = b1p_new, b2p_new

    def _apply_one(self, p, g, wd, lr_scale):
        m = self._add_accumulator("moment1", p)
        v = self._add_accumulator("moment2", p, dtype=self._m2_dtype)
        pows = self._accumulators
        b1p = pows["beta1_pow"].get(id(p))
        if b1p is None:
            b1p = self._pending_state.pop(("beta1_pow", id(p)), np.float32(1.0))
        b2p = pows["beta2_pow"].get(id(p))
        if b2p is None:
            b2p = self._pending_state.pop(("beta2_pow", id(p)), np.float32(1.0))
        new_p, m_new, v_new, b1p_new, b2p_new = self._update(
            p.to(m.dtype), m, v.float(), g.to(m.dtype), _wd_value(wd), self._lr_value(lr_scale),
            b1p, b2p)
        m.copy_(m_new)
        v.copy_(self._store_m2(v_new))
        pows["beta1_pow"][id(p)] = b1p_new
        pows["beta2_pow"][id(p)] = b2p_new
        p.copy_(new_p.to(p.dtype))


class AdamW(Adam):
    """Decoupled weight decay (python/paddle/optimizer/adamw.py).
    `apply_decay_param_fun(name)` sees each parameter's name (given as
    `parameters=model.named_parameters()`; "" for a parameter passed
    without one) and returns False to exempt it from decay."""

    _wd_mode = "decoupled"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, parameters=None,
                 weight_decay=0.01, lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters, weight_decay, grad_clip,
                         lazy_mode, multi_precision, name, **kw)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _effective_wd(self, p, wd):
        fn = self._apply_decay_param_fun
        if fn is not None and not fn(self._param_names.get(id(p), "")):
            return 0.0
        return wd
