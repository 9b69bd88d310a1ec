"""Port parity of the math and logic ops (paddle_tpu_torch/ops/math.py,
logic.py): every row of tests/torch_op_table.py whose op lives there, the
port on the CPU against the JAX package on the same numpy inputs, f32
and (bf16 rows) bfloat16, with gradients for the float rows."""
import pytest

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu_torch as ptt

from torch_op_parity import check_row
from torch_op_table import ROWS, resolve

_MODULES = ("paddle_tpu_torch.ops.math", "paddle_tpu_torch.ops.logic")
CASES = [(r, False) for r in ROWS if resolve(ptt, r.name).__module__ in _MODULES]
CASES += [(r, True) for r, _ in list(CASES) if r.bf16]


@pytest.mark.parametrize("row,bf16", CASES, ids=[r.id + ("-bf16" if b else "") for r, b in CASES])
def test_op_matches_jax(row, bf16):
    check_row(row, bf16)
