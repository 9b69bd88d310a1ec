"""Automatic mixed precision (counterpart of paddle_tpu/amp/__init__.py).

`auto_cast(level="O1", dtype="bfloat16")`: under O1 the white-list ops run
in the low dtype, the black-list ops in float32, and every other op
follows its inputs; under O2 the black list runs in float32 and every
other op that casts runs low. The lists are the JAX package's
(paddle_tpu/amp/__init__.py:25-40).

This is not `torch.autocast`: torch's op lists differ between CPU and
CUDA and from the JAX package's. Each op of the port that the lists name
casts its own inputs through `amp_cast_inputs`, as the JAX package's
op-apply path does (paddle_tpu/core/apply.py:45-55); the cast sits inside
autograd, so gradients come back in each input's own dtype. The ops that
call it are linear, conv1d/2d/3d, rms_norm, layer_norm, batch_norm,
cross_entropy, scaled_dot_product_attention, fused_linear_cross_entropy
and fused_rms_norm. Elementwise ops (add, relu, silu, RoPE), the pools,
batch norm's statistics and the embedding lookup follow their inputs
under every level: O2 does not cast them here as it does in the JAX
package. After `decorate(level="O2")` every parameter is low already, so
they run low all the same.

`decorate(models, optimizers, level="O2", dtype)` casts the models'
floating parameters and buffers to `dtype` and nothing more: as in the
JAX package there is no f32 master copy; the optimizers update a low
parameter in f32 and round back every step.

`GradScaler` is dynamic loss scaling (paddle_tpu/amp/__init__.py:130-281)
for float16 training: `scale(loss)`, `unscale_(opt)` (once per optimizer a
step), `step(opt)`, `update()`, `minimize`, `record_external_skip`,
`state_dict`/`load_state_dict`. The JAX package never reads `found_inf`
on the host: it runs the step and blends every tensor back. Here
`unscale_` reads it once a step (one host sync) and a step with a
non-finite gradient is skipped outright (`Optimizer._skip_step`): no
parameter, moment, beta power or `@step` changes, and the
stochastic-rounding seeds the JAX package's step draws are drawn, so the
runs stay bit-comparable. The scale, good and bad counts are host values.
"""
from __future__ import annotations

import functools
import threading
from typing import List, Optional

import numpy as np
import torch

from ..framework import dtype as _dtype

WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mm", "einsum",
    "scaled_dot_product_attention",
    # the fused LM head: its [N, V] intermediates must be low precision
    "fused_linear_cross_entropy",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square", "sqrt",
    "rsqrt", "softmax", "log_softmax", "cross_entropy", "layer_norm",
    "batch_norm", "group_norm", "rms_norm", "mean", "sum", "norm",
    "logsumexp", "cumsum", "softmax_with_cross_entropy",
}


class AmpState:
    def __init__(self, enable, dtype, level, custom_white_list=None, custom_black_list=None):
        self.enable = enable
        self.dtype = _dtype.convert_dtype(dtype)
        self.level = level.upper()
        self.white = set(WHITE_LIST) | set(custom_white_list or ())
        self.black = set(BLACK_LIST) | set(custom_black_list or ())


_local = threading.local()


def get_amp_state() -> Optional[AmpState]:
    return getattr(_local, "state", None)


def _set_amp_state(st: Optional[AmpState]) -> Optional[AmpState]:
    prev = get_amp_state()
    _local.state = st
    return prev


class auto_cast:
    """paddle.amp.auto_cast: a context manager and a decorator."""

    def __init__(self, enable=True, custom_white_list=None, custom_black_list=None, level="O1",
                 dtype="bfloat16", use_promote=True):
        if level.upper() not in ("O0", "O1", "O2"):
            raise ValueError(f"amp level must be O0/O1/O2, got {level}")
        self.state = AmpState(enable and level.upper() != "O0", dtype, level, custom_white_list,
                              custom_black_list)

    def __enter__(self):
        self._prev = _set_amp_state(self.state if self.state.enable else None)
        return self

    def __exit__(self, *exc):
        _set_amp_state(self._prev)
        return False

    def __call__(self, fn):
        st = self.state

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            prev = _set_amp_state(st if st.enable else None)
            try:
                return fn(*a, **kw)
            finally:
                _set_amp_state(prev)

        return wrapper


def amp_cast_inputs(name: str, values: List) -> List:
    """Cast an op's floating tensor inputs per the active AMP state: O1
    casts the white list to the low dtype and the black list to float32;
    O2 casts everything but the black list to the low dtype. Anything
    else (None, ints, integer tensors) passes through."""
    st = get_amp_state()
    if st is None:
        return list(values)
    if st.level == "O2":
        to = torch.float32 if name in st.black else st.dtype
    elif name in st.white:
        to = st.dtype
    elif name in st.black:
        to = torch.float32
    else:
        return list(values)
    return [v.to(to) if isinstance(v, torch.Tensor) and v.is_floating_point() and v.dtype != to
            else v for v in values]


def decorate(models, optimizers=None, level="O2", dtype="bfloat16", master_weight=None,
             save_dtype=None):
    """paddle.amp.decorate: under O2 the models' floating parameters and
    buffers become `dtype` (in place: the parameter objects, and with them
    the optimizers' references, stay). No master weights: `master_weight`
    and `save_dtype` are accepted and change nothing, as in the JAX
    package (paddle_tpu/amp/__init__.py:117-128)."""
    ms = [models] if not isinstance(models, (list, tuple)) else list(models)
    if level.upper() == "O2":
        dt = _dtype.convert_dtype(dtype)
        for m in ms:
            m.to(dtype=dt)
    if optimizers is None:
        return models
    return models, optimizers


def _f32(x) -> float:
    return float(np.float32(x))


class GradScaler:
    """Dynamic loss scaling (python/paddle/amp/grad_scaler.py), the JAX
    package's rules: a non-finite gradient skips the step; after
    `decr_every_n_nan_or_inf` bad steps in a row the scale is multiplied by
    `decr_ratio` (not below 1), after `incr_every_n_steps` good steps in a
    row by `incr_ratio`. The scale is an f32 value."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15, incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = _f32(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled: set = set()  # ids of the optimizers unscaled this step

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> torch.Tensor:
        return torch.tensor(self._scale, dtype=torch.float32)

    def scale(self, loss):
        """loss times the scale, in the loss's dtype."""
        if not self._enable:
            return loss
        return loss * _dtype.round_to(self._scale, loss.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        """Divide the optimizer's grads by the scale (in f32, stored back in
        each grad's dtype) and note whether any is non-finite: the one host
        read of a step. A second call before `step` does nothing."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        params = [p for _, p in optimizer._all_params() if p.grad is not None]
        if not params:
            return
        inv = _f32(np.float32(1.0) / np.float32(self._scale))
        found = None
        for p in params:
            g = p.grad.float() * inv
            bad = ~torch.isfinite(g).all()
            found = bad if found is None else found | bad
            p.grad.copy_(g)
        self._found_inf = bool(found)

    def step(self, optimizer) -> None:
        """unscale_ (if not done), then the optimizer's step, or its skip
        when a gradient is non-finite, then `update`."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if self._found_inf:
            optimizer._skip_step()
        else:
            optimizer.step()
        self._unscaled.discard(id(optimizer))
        self.update()

    def minimize(self, optimizer, scaled_loss) -> None:
        scaled_loss.backward()
        self.step(optimizer)

    def record_external_skip(self) -> None:
        """Count a step skipped outside the scaler as a bad step."""
        if not self._enable:
            return
        prev = self._found_inf
        self._found_inf = True
        self.update()
        self._found_inf = prev

    def update(self) -> None:
        if not (self._enable and self._dynamic):
            return
        found = self._found_inf
        good = 0 if found else self._good_steps + 1
        bad = self._bad_steps + 1 if found else 0
        scale = self._scale
        if bad >= self._decr_every:
            scale, bad = max(_f32(scale * self._decr_ratio), 1.0), 0
        if good >= self._incr_every:
            scale, good = _f32(scale * self._incr_ratio), 0
        self._scale, self._good_steps, self._bad_steps = scale, good, bad

    def state_dict(self) -> dict:
        """{"scale": f32, "good_steps": int32, "bad_steps": int32} 0-d
        tensors, the JAX package's keys and types."""
        return {"scale": torch.tensor(self._scale, dtype=torch.float32),
                "good_steps": torch.tensor(self._good_steps, dtype=torch.int32),
                "bad_steps": torch.tensor(self._bad_steps, dtype=torch.int32)}

    def load_state_dict(self, sd) -> None:
        if "scale" in sd:
            self._scale = _f32(float(sd["scale"]))
        if "good_steps" in sd:
            self._good_steps = int(sd["good_steps"])
        if "bad_steps" in sd:
            self._bad_steps = int(sd["bad_steps"])


def is_bfloat16_supported(device=None) -> bool:
    return True


def is_float16_supported(device=None) -> bool:
    """The flash kernels (B1-B3) take float16 q/k/v on the card."""
    return True


__all__ = ["auto_cast", "amp_cast_inputs", "get_amp_state", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported", "WHITE_LIST", "BLACK_LIST"]
