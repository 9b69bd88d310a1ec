"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py):
ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm and clip_grad_norm_.

`ClipGradByValue(max, min)` clamps each gradient, `ClipGradByNorm(c)`
scales each by min(c / max(||g||, 1e-12), 1); both skip the parameters
whose `need_clip` is False, and the optimizers apply them before the
update (the flat-bucket engine too).

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


class ClipGradByValue:
    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, g if g is None or not _clipped(p) else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None and _clipped(p):
                n = g.square().sum().sqrt()
                g = g * torch.clamp_max(self.clip_norm / torch.clamp_min(n, 1e-12), 1.0)
            out.append((p, g))
        return out


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale every .grad in place by min(max_norm / max(total, 1e-6), 1),
    total the norm_type norm of all of them (inf: the largest |g|); returns
    total (a zero when no parameter has a gradient)."""
    params = [p for p in (parameters if isinstance(parameters, (list, tuple)) else
                          list(parameters) if not isinstance(parameters, torch.Tensor)
                          else [parameters]) if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max() for p in params]).max()
    else:
        total = torch.stack([(p.grad.abs() ** norm_type).sum() for p in params]).sum() ** (
            1.0 / norm_type)
    scale = torch.clamp_max(max_norm / torch.clamp_min(total, 1e-6), 1.0)
    with torch.no_grad():
        for p in params:
            p.grad.mul_(scale.to(p.grad.dtype))
    return total
