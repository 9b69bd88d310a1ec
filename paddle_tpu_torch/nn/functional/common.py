"""linear, dropout and embedding (counterpart of
paddle_tpu/nn/functional/common.py:21-90)."""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs
from ...framework import random as _random


def linear(x, weight, bias=None, name=None):
    """x @ weight + bias with paddle's [in, out] weight (the Linear layer
    keeps torch's [out, in] and calls torch's linear itself). Under AMP
    the inputs cast as the white-listed op "linear" (bf16 under O1)."""
    x, weight, bias = amp_cast_inputs("linear", [x, weight, bias])
    return TF.linear(x, weight.t(), bias)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    """upscale_in_train element dropout, the mask drawn from the framework
    generator of x's device: kept values scaled by 1/(1-p), the rest zero.
    The identity in eval and at p == 0."""
    if axis is not None or mode != "upscale_in_train":
        raise NotImplementedError("dropout along an axis, or in another mode, is not ported")
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=_random.generator(x.device), device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of weight [V, H] at the ids x. Where an id equals padding_idx
    the output is zero, whatever that row of weight holds (torch's own
    padding_idx only stops the gradient): the JAX package masks the
    output, and a tied embedding's padding row does move in training."""
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out
