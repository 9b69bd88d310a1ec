"""Paddle dtype names mapped onto torch dtypes, and the default float type
(paddle.set_default_dtype, counterpart of paddle_tpu/framework/dtype.py:82)."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

_ALIASES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "half": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float": torch.float32,
    "float64": torch.float64,
    "double": torch.float64,
}

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)

_default_dtype = torch.float32


def convert_dtype(dtype) -> torch.dtype:
    """A paddle dtype name, numpy dtype or torch dtype -> torch dtype."""
    if dtype is None:
        raise ValueError("dtype must not be None")
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype.replace("paddle.", "")
        if name in _ALIASES:
            return _ALIASES[name]
        raise TypeError(f"unknown dtype name {dtype!r}")
    if dtype is bool:
        return torch.bool
    if dtype is int:
        return torch.int64
    if dtype is float:
        return _default_dtype
    name = np.dtype(dtype).name
    if name in _ALIASES:
        return _ALIASES[name]
    raise TypeError(f"unsupported dtype {dtype!r}")


def round_to(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float. A Python float in a
    torch op on a 16-bit tensor enters the arithmetic at f32 precision; in
    the JAX package it is a weak type and rounds to the tensor's dtype
    first. Passing round_to(value, t.dtype) gives the JAX package's value."""
    if dtype == torch.float32:
        return float(np.float32(value))
    if dtype == torch.float64:
        return float(value)
    return float(torch.tensor(value, dtype=dtype))


def set_default_dtype(d: Union[str, torch.dtype]) -> None:
    """The float type parameters are created in."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in _FLOATS:
        raise TypeError(
            f"set_default_dtype only supports float16/bfloat16/float32/float64, got {d}"
        )
    _default_dtype = d


def get_default_dtype() -> torch.dtype:
    return _default_dtype
