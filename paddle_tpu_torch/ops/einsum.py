"""einsum (counterpart of paddle_tpu/ops/einsum.py); white-listed under AMP."""
from __future__ import annotations

import torch

from ._common import _t, amp


def einsum(equation, *operands):
    return torch.einsum(equation, *amp("einsum", *[_t(o) for o in operands]))


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and getattr(_v, "__module__", None) == __name__
           and callable(_v)]

# each public op is one recorded op of a static capture (core/record.py)
from ..core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
