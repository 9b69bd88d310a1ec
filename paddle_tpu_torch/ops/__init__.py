"""Ops with hand-written CUDA kernels: attention (flash forward and
backward, paged), the fused AdamW update; launch counts in launches.py."""
from . import attention, fused_optimizer, launches

__all__ = ["attention", "fused_optimizer", "launches"]
