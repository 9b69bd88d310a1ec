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
package.
"""
from __future__ import annotations

import functools
import threading
from typing import List, Optional

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


__all__ = ["auto_cast", "amp_cast_inputs", "get_amp_state", "WHITE_LIST", "BLACK_LIST"]
