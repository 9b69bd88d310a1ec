"""Grad mode (counterpart of paddle_tpu/core/state.py:23-85) on torch's own.

`no_grad` and `enable_grad` are context managers and decorators, and
`set_grad_enabled` a function and a context manager, as in paddle. The
JAX package's `to_static` recorder (state.py:87-140) waits for the
static-graph slice: the port's `to_static` runs eagerly and records
nothing.
"""
from __future__ import annotations

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled"]
