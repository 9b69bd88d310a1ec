"""Gradient clipping by global norm (counterpart of paddle_tpu/nn/clip.py:57).

`ClipGradByGlobalNorm(clip_norm)` scales every clipped gradient by
clip_norm / max(global_norm, clip_norm), the norm taken in f32 over the
grads of the parameters whose `need_clip` is not False. The optimizer's
per-tensor path calls it on (param, grad) pairs; the flat-bucket engine
takes only the scale (`global_scale`) and hands it to the fused AdamW
kernel as one operand, as the JAX engine does
(paddle_tpu/optimizer/fused_engine.py:253-261). The norm and the scale
stay on the device: no host sync.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def _clipped(p) -> bool:
    return getattr(p, "need_clip", True)


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm: float, group_name: str = "default_group",
                 auto_skip_clip: bool = False):
        self.clip_norm = clip_norm

    def global_scale(self, grads: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
        """clip_norm / max(||grads||, clip_norm) as an f32 device scalar;
        None for no grads."""
        if not grads:
            return None
        sq = sum(g.float().square().sum() for g in grads)
        return self.clip_norm / torch.clamp_min(torch.sqrt(sq), self.clip_norm)

    def __call__(self, params_grads: List[Tuple]) -> List[Tuple]:
        scale = self.global_scale([g for p, g in params_grads if g is not None and _clipped(p)])
        if scale is None:
            return params_grads
        return [(p, g if g is None or not _clipped(p) else g * scale.to(g.dtype))
                for p, g in params_grads]
