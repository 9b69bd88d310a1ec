"""Weight carry-over between the JAX package and the port.

paddle's Linear stores its weight [in, out] (paddle_tpu/nn/layers/common.py:16);
the port's Linear stores torch's [out, in]. Linear weights (Llama's,
ERNIE's (`classifier` included), and ResNet's and CRNN's `fc`, by the name of their layer) are
transposed on the way across; embeddings ([vocab, hidden] in both), conv
weights ([out, in/groups, *kernel] in both; transposed convs' [in,
out/groups, *kernel] in both), RNN cell weights ([gates * hidden, in] in
both), norm weights, biases and the batch norms' `_mean`/`_variance`
buffers are not. Parameter and buffer names are
the same in both packages.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..framework.io import numpy_to_tensor, tensor_to_numpy

_LINEAR_WEIGHT = re.compile(r"(^|\.)(q_proj|k_proj|v_proj|o_proj|out_proj|gate_proj|up_proj|down_proj"
                            r"|lm_head|linear1|linear2|dense|transform|fc|classifier)\.weight$")


def is_linear_weight(name: str) -> bool:
    return _LINEAR_WEIGHT.search(name) is not None


def state_from_paddle_tpu(np_state: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A paddle-layout state of numpy arrays (bf16 as ml_dtypes.bfloat16)
    -> a torch state_dict on the CPU."""
    out = {}
    for name, a in np_state.items():
        t = numpy_to_tensor(np.asarray(a))
        out[name] = t.t().contiguous() if is_linear_weight(name) else t
    return out


def state_to_paddle_tpu(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A torch state_dict -> paddle-layout numpy arrays."""
    out = {}
    for name, t in state.items():
        t = t.detach()
        out[name] = tensor_to_numpy(t.t().contiguous() if is_linear_weight(name) else t)
    return out
