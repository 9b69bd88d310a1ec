"""Ops with hand-written CUDA kernels: attention (flash forward and
backward, paged), the fused AdamW update; launch counts in launches.py.
The paddle op surface (plain torch ops): creation, math, manipulation,
logic, search, linalg, einsum and the `*_` inplace family; importing
this package attaches paddle's Tensor methods to torch.Tensor (_patch.py)."""
from . import (attention, creation, einsum, fused_optimizer, inplace, launches, linalg, logic,
               manipulation, math, search)
from ._patch import patch_tensor

patch_tensor()

__all__ = ["attention", "creation", "einsum", "fused_optimizer", "inplace", "launches", "linalg",
           "logic", "manipulation", "math", "search"]
