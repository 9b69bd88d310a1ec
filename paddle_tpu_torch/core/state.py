"""Grad mode and the static program-capture hook (counterpart of
paddle_tpu/core/state.py:23-85 and :133-142) on torch's own grad mode.

`no_grad` and `enable_grad` are context managers and decorators, and
`set_grad_enabled` a function and a context manager, as in paddle.

`get_program_capture`/`set_program_capture` name the Program that
`static.program_guard` is recording into on this thread (None outside a
guard); core/record.py reads it at every op. The JAX package's
`to_static` recorder (state.py:87-118) is not ported: the port's
`to_static` runs eagerly and records nothing.
"""
from __future__ import annotations

import threading

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


class _TLS(threading.local):
    def __init__(self):
        self.program_capture = None
        self.depth = 0  # > 0 inside a recorded op: its inner calls are not recorded


_tls = _TLS()
# how many threads capture now: the op wrappers' one read when nothing does
ACTIVE = [0]


def get_program_capture():
    return _tls.program_capture


def set_program_capture(prog):
    """Make `prog` (or None) the Program this thread records into; returns
    the previous one."""
    prev = _tls.program_capture
    _tls.program_capture = prog
    ACTIVE[0] += (prog is not None) - (prev is not None)
    return prev


__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "get_program_capture", "set_program_capture"]
