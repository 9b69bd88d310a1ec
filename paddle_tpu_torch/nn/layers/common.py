"""Linear (counterpart of paddle_tpu/nn/layers/common.py:16 and
nn/functional/common.py:21).

A torch `nn.Linear`, weight [out, in] (utils/convert.py transposes the
JAX package's [in, out] on the way across), whose forward casts its
inputs as the op "linear" under AMP: bf16 under O1.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as TF

from ...amp import amp_cast_inputs


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = amp_cast_inputs("linear", [x, self.weight, self.bias])
        return TF.linear(x, w, b)
