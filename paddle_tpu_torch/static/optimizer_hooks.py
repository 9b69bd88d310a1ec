"""Static-mode optimizer support: minimize() under program_guard
(counterpart of paddle_tpu/static/optimizer_hooks.py).

In static mode `Optimizer.minimize` appends backward and one update per
parameter to the program instead of stepping: the update is a function
`(param, grad, lr, *accums) -> (new_param, *new_accums)`, its
accumulators tensors the Executor writes back after each run. The
arithmetic is the JAX package's static update (optimizer_hooks.py:22-54),
in f32 for f32 params, not the eager step's.

Under FLAGS_fused_optimizer an Adam/AdamW minimize appends one fused
update per parameter dtype (`_append_fused_adamw`): the whole call's
update is one launch of the fused AdamW kernel (B5) a step. As in the
JAX package its flat moment2 is float32 whatever `moment2_dtype` the
optimizer was given, and the Executor passes it seed 0 every step.
"""
from __future__ import annotations

from collections import defaultdict

import torch

from ..framework import dtype as _dtype
from ..ops.fused_optimizer import sqrt_rn
from .executor import _FusedAdamWUpdate, _OptUpdate, append_backward
from .program import default_main_program


def _lr(lr, p):
    return _dtype.round_to(lr, p.dtype)


def _sgd_update(p, g, lr):
    return (p - _lr(lr, p) * g.to(p.dtype),)


def _make_momentum_update(mu, nesterov=False):
    def upd(p, g, lr, vel):
        v = mu * vel + g.to(vel.dtype)
        if nesterov:
            step = g.to(p.dtype) + mu * v.to(p.dtype)
        else:
            step = v.to(p.dtype)
        return p - _lr(lr, p) * step, v

    return upd


def _make_adam_update(b1, b2, eps, with_decoupled_wd=0.0):
    def upd(p, g, lr, m, v, t):
        t = t + 1
        g32 = g.to(m.dtype)
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * g32 * g32
        mhat = m2 / (1 - b1 ** t)
        vhat = v2 / (1 - b2 ** t)
        step = _lr(lr, p) * (mhat / (sqrt_rn(vhat) + eps)).to(p.dtype)
        newp = p - step
        if with_decoupled_wd:
            newp = newp - _lr(lr, p) * with_decoupled_wd * p
        return newp, m2, v2, t

    return upd


def static_minimize(optimizer, loss, parameters=None):
    """Record backward + update instructions on the default main program.
    Returns (None, params_grads) like the reference's minimize."""
    from ..optimizer.optimizer import SGD, Adam, AdamW, Momentum, _wd_value

    prog = default_main_program()
    params = parameters if parameters is not None else [p for _, p in optimizer._all_params()]
    params = [p for p in params if p.requires_grad]
    pairs = append_backward(loss, parameter_list=params)
    prog.name_vars((optimizer._param_names[id(p)], p) for p in params
                   if id(p) in optimizer._param_names)

    def lr_getter():
        return optimizer.get_lr()

    clip = optimizer._grad_clip
    if type(optimizer) in (Adam, AdamW) and _use_fused_flag():
        _append_fused_adamw(prog, optimizer, pairs, lr_getter, clip)
        prog._compiled.clear()
        return None, pairs
    coupled_wd = 0.0
    if type(optimizer) is not AdamW:  # SGD/Momentum/Adam fold L2 into the grad
        coupled_wd = _wd_value(optimizer._weight_decay) or 0.0
    for p, g in pairs:
        pv = prog.var_of(p)
        gv = prog._id2var[id(g)]
        with torch.no_grad():
            if type(optimizer) is SGD:
                fn, accums = _sgd_update, []
            elif type(optimizer) is Momentum:
                fn = _make_momentum_update(optimizer._momentum, optimizer._nesterov)
                accums = [torch.zeros_like(p)]
            elif type(optimizer) in (Adam, AdamW):
                wd = 0.0
                if type(optimizer) is AdamW:
                    wd = _wd_value(optimizer._weight_decay) or 0.0
                fn = _make_adam_update(optimizer._beta1, optimizer._beta2, optimizer._eps, wd)
                fdtype = torch.float32 if p.dtype == torch.bfloat16 else p.dtype
                accums = [
                    torch.zeros(p.shape, dtype=fdtype, device=p.device),
                    torch.zeros(p.shape, dtype=fdtype, device=p.device),
                    torch.zeros((), dtype=torch.int32, device=p.device),
                ]
            else:
                raise NotImplementedError(
                    f"static minimize supports SGD/Momentum/Adam/AdamW, got "
                    f"{type(optimizer).__name__}")
        prog.opt_updates.append(_OptUpdate(pv, gv, fn, accums, lr_getter, clip=clip,
                                           wd=coupled_wd))
    prog._compiled.clear()
    return None, pairs


def _use_fused_flag():
    from ..framework import flags as _flags

    return bool(_flags.get_flag("FLAGS_fused_optimizer"))


def _append_fused_adamw(prog, optimizer, pairs, lr_getter, clip):
    """FLAGS_fused_optimizer static path: one _FusedAdamWUpdate per param
    storage dtype — the whole minimize() call's elementwise update runs as
    one flat-bucket kernel launch (executor _apply_fused_update)."""
    from ..ops.fused_optimizer import pad_to_tile
    from ..optimizer.optimizer import AdamW, _wd_value

    by_dtype = defaultdict(list)
    for p, g in pairs:
        by_dtype[p.dtype].append((p, g))
    wd = _wd_value(optimizer._weight_decay) or 0.0
    for dt, pgs in by_dtype.items():
        index, off = {}, 0
        pvs, gvs = [], []
        for p, g in pgs:
            pv = prog.var_of(p)
            pvs.append(pv)
            gvs.append(prog._id2var[id(g)])
            size = p.numel()
            index[pv] = (off, size, tuple(p.shape))
            off += size
        n_pad = pad_to_tile(off)
        dev = pgs[0][0].device
        accums = [
            torch.zeros((n_pad,), dtype=torch.float32, device=dev),  # moment1, flat
            torch.zeros((n_pad,), dtype=torch.float32, device=dev),  # moment2, flat
            torch.zeros((), dtype=torch.int32),  # t, on the host: no sync a step
        ]
        prog.opt_updates.append(_FusedAdamWUpdate(
            pvs, gvs, index, n_pad, accums, lr_getter, clip,
            optimizer._beta1, optimizer._beta2, optimizer._eps,
            wd=wd, decoupled=type(optimizer) is AdamW,
        ))
