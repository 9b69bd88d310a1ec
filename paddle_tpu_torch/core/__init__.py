"""Grad mode, the paddle Tensor surface on torch.Tensor, and the
backward-end hooks (counterpart of paddle_tpu/core/)."""
from . import autograd_engine, state, tensor

__all__ = ["autograd_engine", "state", "tensor"]
