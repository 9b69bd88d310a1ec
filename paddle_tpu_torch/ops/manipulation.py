"""flatten (counterpart of paddle_tpu/ops/manipulation.py:67). The rest of
the manipulation surface waits for the op-surface slice."""
from __future__ import annotations

import torch


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes start_axis..stop_axis (inclusive) merged into one."""
    return torch.flatten(x, start_axis, stop_axis)
