"""Port parity of the nn.functional remainder (paddle_tpu_torch/nn/
functional/*): every row of tests/torch_nn_table.py, the port on the CPU
against the JAX package on the same numpy inputs, f32 and (bf16 rows)
bfloat16, with gradients for the float rows."""
import pytest

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

from torch_nn_table import ROWS
from torch_op_parity import check_row

CASES = [(r, False) for r in ROWS] + [(r, True) for r in ROWS if r.bf16]


@pytest.mark.parametrize("row,bf16", CASES, ids=[r.id.split(".")[-1] + ("-bf16" if b else "")
                                                 for r, b in CASES])
def test_functional_matches_jax(row, bf16):
    check_row(row, bf16)
