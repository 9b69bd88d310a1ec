"""Weight carry-over between the JAX package and the port.

Both packages lay out every parameter and buffer alike, under the same
names: Linear weights [in, out], embeddings [vocab, hidden], conv
weights [out, in/groups, *kernel] (transposed convs' [in, out/groups,
*kernel]), RNN cell weights [gates * hidden, in], and the batch norms'
`_mean`/`_variance` buffers. So a state crosses unchanged: these two
functions are the one entry point for moving the JAX package's numpy
parameters into the port and back, and change only the array type
(bf16 as ml_dtypes.bfloat16 on the numpy side, where it is installed).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..framework.io import numpy_to_tensor, tensor_to_numpy


def state_from_paddle_tpu(np_state: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A paddle-layout state of numpy arrays -> a torch state_dict on the CPU."""
    return {name: numpy_to_tensor(np.asarray(a)) for name, a in np_state.items()}


def state_to_paddle_tpu(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A torch state_dict -> paddle-layout numpy arrays."""
    return {name: tensor_to_numpy(t.detach()) for name, t in state.items()}
