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
does. The update math and its rounding points are the JAX package's; a
bf16 parameter (amp.decorate O2) updates in f32 and rounds back to bf16
every step, with no f32 master copy, as there.

`parameters` is a list of params (or of `named_parameters()` pairs), or
a list of param-group dicts: `params`, and optionally `learning_rate` (a
scale of the optimizer's lr), `weight_decay` and `grad_clip`, each
overriding the optimizer's for its group. A parameter's own
`optimize_attr["learning_rate"]` multiplies its group's scale and its
`regularizer` replaces the group's decay (nn.ParamAttr sets both); the
clip skips a parameter whose `need_clip` is False.

The learning rate is a number or an LRScheduler (lr.py); `step()` reads
the scheduler's `last_lr` and rounds it to f32, as the JAX package does.
`weight_decay` is a float, an L2Decay or an L1Decay (regularizer.py).

`state_dict()` is the JAX package's format, whatever path holds the
state: `<accumulator>_<i>` for the i-th parameter in group order
(`moment1_3`, `moment2_3`, `beta1_pow_3`, ...), `@step` and
`LR_Scheduler`. Its tensors are the live state (views into a flat or
stacked bucket), as torch's own optimizers hand theirs out.
`set_state_dict()` dissolves every bucket and parks the loaded values in
`_pending_state`, where the next step's buckets or accumulators pick them
up, so a checkpoint loads before the first step and moves between the
flat, stacked and per-tensor paths. Not ported: the optimizers other than
SGD, Momentum, Adam and AdamW.
"""
from __future__ import annotations

import numbers
import re
from collections import defaultdict

import numpy as np
import torch

from ..framework import dtype as _dtype
from ..framework import flags as _flags
from ..framework import io as _io
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
        self._param_groups = self._build_param_groups(parameters)
        self._params = [p for _, p in self._all_params()]
        # the JAX package keeps it as an f32 scalar
        self._lr = _f32(self._lr_scheduler.last_lr if self._lr_scheduler else learning_rate)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._step_count = 0  # "@step": steps taken (a skipped step does not count)
        self._accumulators: dict = defaultdict(dict)  # name -> {id(param): tensor or f32}
        self._pending_state: dict = {}  # (name, id(param)) -> value awaiting a new home
        self._fused_buckets: dict = {}  # ids tuple -> stacked bucket (see Adam._apply_fused)
        self._flat_engine = None  # FLAGS_fused_optimizer engine (fused_engine.py)

    # ---- params ----
    def _build_param_groups(self, parameters):
        """[{"params": [...], ...}]: one group for a list of params, or the
        given param-group dicts. A param may come as a (name, param) pair
        (`named_parameters()`: torch tensors carry no paddle-style name, so
        this is how a name reaches `apply_decay_param_fun`)."""
        self._param_names = {}

        def unname(x):
            if isinstance(x, tuple):
                self._param_names[id(x[1])] = x[0]
                return x[1]
            return x

        params = list(parameters)
        if params and isinstance(params[0], dict):
            groups = []
            for g in params:
                g = dict(g)
                g["params"] = [unname(x) for x in g["params"]]
                groups.append(g)
            return groups
        return [{"params": [unname(x) for x in params]}]

    def _all_params(self):
        """(group, param) in the order that numbers the state dict's keys."""
        for g in self._param_groups:
            for p in g["params"]:
                yield g, p

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
        """The lr of an entry: the f32 lr times its scale, rounded to f32
        (the JAX package's f32 scalar times a Python float)."""
        if lr_scale == 1.0:
            return self._lr
        return _f32(np.float32(self._lr) * np.float32(lr_scale))

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
        self._record_step(self._step_body)

    def _step_body(self) -> None:
        self._sync_lr()
        self._step_count += 1
        self._step_impl()

    def _record_step(self, body):
        """Run one step's `body` under the profiler span
        `Optimizer.step#<class>`, with the step counters and the
        step-boundary memory probe (paddle_tpu/optimizer/optimizer.py:
        105-130); with telemetry off, `body` alone."""
        from .. import telemetry as _tm

        if not _tm.enabled():
            return body()
        import time

        from ..profiler import perf_attribution as _pa
        from ..profiler.utils import RecordEvent, TracerEventType

        cls = type(self).__name__
        t0 = time.perf_counter()
        with RecordEvent(f"Optimizer.step#{cls}", TracerEventType.Optimization):
            out = body()
        _tm.counter(
            "paddle_tpu_optimizer_step_total", "optimizer steps", ("optimizer",)
        ).labels(optimizer=cls).inc()
        _tm.histogram(
            "paddle_tpu_optimizer_step_seconds",
            "host wall time of Optimizer.step", ("optimizer",),
        ).labels(optimizer=cls).observe(time.perf_counter() - t0)
        # the allocator's live bytes and peak: a few µs, no tensor walk
        _pa.sample_watermark(tag="optimizer_step")
        return out

    # ---- the state the training guardian snapshots ----
    def _state_slots(self):
        """[(holder, key, fill)] for every piece of optimizer state a step
        changes, where `holder[key]` is the live value (a tensor or a host
        f32/int): the per-param accumulators, the stacked and flat buckets'
        moments and beta powers, and `_step_count` (a Python int). `fill`
        is the value state created after a snapshot goes back to (None:
        it always predates one)."""
        out = []
        for name, store in self._accumulators.items():
            fill = 1.0 if name.endswith("_pow") else 0.0
            out.extend((store, pid, fill) for pid in store)
        for st in self._fused_buckets.values():
            for grp in st["groups"]:
                out.extend((grp, nm, 0.0) for nm in ("moment1", "moment2"))
            out.extend((st, nm, 1.0) for nm in ("beta1_pow", "beta2_pow"))
        if self._flat_engine is not None:
            out.extend(self._flat_engine.state_slots())
        out.append((self.__dict__, "_step_count", None))
        return out

    def _fused_state_entries(self):
        """[(tensor, fill)] for every bucket state tensor, stacked and flat
        (paddle_tpu/optimizer/optimizer.py:301-314): what a snapshot covers
        beside the per-param accumulators. The flat buckets are copies of
        nothing (the parameters are copied into a flat buffer each step),
        so a restored parameter is what the next step reads."""
        bucket_holders = [grp for st in self._fused_buckets.values() for grp in st["groups"]]
        if self._flat_engine is not None:
            bucket_holders += list(self._flat_engine.buckets.values())
        return [(h[nm], 0.0) for h in bucket_holders for nm in ("moment1", "moment2")]

    @torch.no_grad()
    def _skip_step(self) -> None:
        """A step skipped for a non-finite gradient (amp.GradScaler): what
        the JAX package's step leaves once it has blended every tensor back
        (paddle_tpu/amp/__init__.py:193-233). The lr is synced, state a step
        would create is created at its fill, and the stochastic-rounding
        seeds the step would draw are drawn, so the next step rounds with
        the JAX package's bits; no parameter or state value changes and
        `@step` stays."""
        self._sync_lr()
        for _ in range(self._materialize_state()):
            self._m2_key()

    def _materialize_state(self) -> int:
        """Create the state the next step would create, without updating
        anything; returns how many stochastic-rounding seeds that step draws.
        Adam/AdamW build their buckets and accumulators here; SGD draws
        nothing, and Momentum's velocity appears at its next finite step
        (zeros, as the skipped step would have left it)."""
        return 0

    def _step_impl(self):
        for entries in self._collect_entries():
            self._apply_entries(entries)

    def _collect_groups(self):
        """Per param group: (clip, [(param, grad, weight_decay, lr_scale)])
        with UNCLIPPED grads and each param's overrides resolved (its
        `optimize_attr` lr scale times the group's, its `regularizer` over
        the group's decay)."""
        out = []
        for group in self._param_groups:
            clip = group.get("grad_clip", self._grad_clip)
            wd = group.get("weight_decay", self._weight_decay)
            lr_scale = group.get("learning_rate", 1.0)
            entries = []
            for p in group["params"]:
                if not p.requires_grad or p.grad is None:
                    continue
                p_scale = lr_scale * getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
                p_wd = getattr(p, "regularizer", None)
                entries.append((p, p.grad, p_wd if p_wd is not None else wd, p_scale))
            if entries:
                out.append((clip, entries))
        return out

    def _collect_entries(self, apply_clip=True):
        """Per param group: [(param, grad, weight_decay, lr_scale)], the grads
        clipped by the group's clip unless apply_clip is False."""
        out = []
        for clip, entries in self._collect_groups():
            if clip is not None and apply_clip:
                pgs = clip([(p, g) for p, g, _, _ in entries])
                entries = [(p, g2, wd, s) for (p, _, wd, s), (_, g2) in zip(entries, pgs)]
            out.append(entries)
        return out

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

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        """Under a static program_guard: append backward and this
        optimizer's update to the program (static/optimizer_hooks.py, as
        paddle_tpu/optimizer/optimizer.py:224-232 sends it). Otherwise
        `loss.backward()` and a step."""
        from ..core import state as _state

        if _state.get_program_capture() is not None:
            from ..static.optimizer_hooks import static_minimize

            return static_minimize(self, loss, parameters)
        loss.backward()
        self.step()
        return None, None

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

    # ---- state dict ----
    def _accumulator_view(self):
        """name -> {id(param): value} over every place state lives: the
        per-param accumulators, the stacked and flat buckets (as per-param
        views) and state loaded but not yet placed."""
        view = {name: dict(store) for name, store in self._accumulators.items()}
        for st in self._fused_buckets.values():
            for grp in st["groups"]:
                for i, pid in enumerate(grp["ids"]):
                    view.setdefault("moment1", {})[pid] = grp["moment1"][i]
                    view.setdefault("moment2", {})[pid] = grp["moment2"][i]
                    view.setdefault("beta1_pow", {})[pid] = st["beta1_pow"]
                    view.setdefault("beta2_pow", {})[pid] = st["beta2_pow"]
        if self._flat_engine is not None:
            self._flat_engine.view_into(view)
        for (nm, pid), v in self._pending_state.items():
            view.setdefault(nm, {}).setdefault(pid, v)
        return view

    def state_dict(self) -> dict:
        """The JAX package's optimizer state dict
        (paddle_tpu/optimizer/optimizer.py:318-330): `<name>_<i>` by the
        param's place in group order, `LR_Scheduler`, `@step` (int64). The
        beta powers are 0-d f32 tensors; the moments the live tensors."""
        sd = {}
        for name, store in self._accumulator_view().items():
            for i, (_, p) in enumerate(self._all_params()):
                if id(p) in store:
                    v = store[id(p)]
                    sd[f"{name}_{i}"] = (v if isinstance(v, torch.Tensor)
                                         else torch.tensor(np.float32(v)))
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        sd["@step"] = torch.tensor(self._step_count, dtype=torch.int64)
        return sd

    def set_state_dict(self, sd) -> None:
        """Load `state_dict()` output (this package's or the JAX package's,
        through paddle.load or in memory). Every bucket is dissolved first;
        each loaded value replaces an existing accumulator or waits in
        `_pending_state` for the step that creates one, so loading before
        the first step works. Tensors are copied onto the param's device in
        their own dtype; beta powers become host f32 scalars."""
        self._defuse_all()
        for key, v in sd.items():
            m = re.fullmatch(r"(.+)_(\d+)", key)
            if not m:
                continue
            name, idx = m.group(1), int(m.group(2))
            if idx >= len(self._params):
                continue
            p = self._params[idx]
            if name.endswith("_pow"):
                val = np.float32(float(v))
            else:
                t = v if isinstance(v, torch.Tensor) else _io.numpy_to_tensor(v)
                val = t.detach().to(device=p.device, copy=True)
            store = self._accumulators.get(name)
            if store is not None and id(p) in store:
                store[id(p)] = val
            else:
                self._pending_state[(name, id(p))] = val
        if "LR_Scheduler" in sd and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(sd["LR_Scheduler"])
            self._sync_lr()
        if "@step" in sd:
            self._step_count = int(sd["@step"])


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
            self._flat_engine_or_create().step(self._collect_groups())
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
            if not isinstance(wd, L1Decay) and p.dtype == torch.float32 and g.shape == p.shape:
                buckets[(_wd_value(wd), float(s))].append((p, g))
            else:
                rest.append((p, g, wd, s))
        return buckets, rest

    def _materialize_state(self) -> int:
        """Build the buckets and accumulators the next step would use (the
        JAX package's `_materialize_state`, and the accumulators its skipped
        step leaves at their fill); returns the stochastic-rounding seeds
        that step draws: one per flat bucket, per stacked shape group and per
        parameter updated alone, with a bf16 moment2."""
        if self._use_flat_fusion():
            n = self._flat_engine_or_create().materialize(self._collect_groups())
        else:
            n = 0
            for entries in self._collect_entries(apply_clip=False):
                buckets, rest = self._fuse_partition(entries)
                for plist in buckets.values():
                    if len(plist) > 1:
                        ids = tuple(id(p) for p, _ in plist)
                        st = self._fused_buckets.get(ids) or self._build_bucket(plist)
                        n += len(st["groups"])
                    else:
                        self._materialize_one(plist[0][0])
                        n += 1
                for p, _, _, _ in rest:
                    self._materialize_one(p)
                    n += 1
        return n if self._m2_dtype == torch.bfloat16 else 0

    def _materialize_one(self, p) -> None:
        """The accumulators `_apply_one` creates for `p`, at their fill."""
        self._add_accumulator("moment1", p)
        self._add_accumulator("moment2", p, dtype=self._m2_dtype)
        for nm in ("beta1_pow", "beta2_pow"):
            if id(p) not in self._accumulators[nm]:
                self._accumulators[nm][id(p)] = self._pending_state.pop((nm, id(p)),
                                                                        np.float32(1.0))

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
