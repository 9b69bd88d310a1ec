"""Ops with hand-written CUDA kernels: attention (flash forward and
backward, paged), the fused AdamW update; launch counts in launches.py.
Tensor creation (to_tensor) in creation.py, flatten in manipulation.py."""
from . import attention, creation, fused_optimizer, launches, manipulation

__all__ = ["attention", "creation", "fused_optimizer", "launches", "manipulation"]
