"""Comparison, logical and bitwise ops (counterpart of
paddle_tpu/ops/logic.py). None is differentiable; none casts under AMP."""
from __future__ import annotations

import torch

from ._common import _t, binary_promote


def _cmp(opname, fn):
    def op(x, y, name=None):
        return fn(*binary_promote(x, y))

    op.__name__ = op.__qualname__ = opname
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)

logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)

bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _cmp("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _cmp("bitwise_right_shift", torch.bitwise_right_shift)


def logical_not(x, name=None):
    return torch.logical_not(_t(x))


def bitwise_not(x, name=None):
    return torch.bitwise_not(_t(x))


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and getattr(_v, "__module__", None) == __name__
           and callable(_v)]

# each public op is one recorded op of a static capture (core/record.py)
from ..core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
