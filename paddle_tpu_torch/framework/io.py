"""paddle.save / paddle.load in the JAX package's pickle format
(paddle_tpu/framework/io.py:43-53): nested dicts and lists whose tensors
are stored as numpy arrays, so the two packages read each other's files.

bf16 has no numpy dtype of its own. The JAX package writes bf16 arrays as
numpy arrays of `ml_dtypes.bfloat16`: in the pickle, numpy's array
reconstruction with a dtype built from the global `ml_dtypes.bfloat16`
and the raw 16-bit payload. `save` writes exactly that form without
importing `ml_dtypes` (a stand-in pickles as that global by name), and
`load` reads it without `ml_dtypes` through an unpickler whose
`find_class` maps the global to a stand-in, so the payload becomes a
bf16 tensor bit for bit. With `ml_dtypes` installed, `load` takes the
ordinary route. No value changes dtype on the way.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

_TENSOR_TAG = "__paddle_tpu_tensor__"


def _ml_dtypes():
    """The ml_dtypes module, or None where it is not installed."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return ml_dtypes


def _bf16_numpy_type():
    mld = _ml_dtypes()
    if mld is None:
        raise RuntimeError("a bfloat16 numpy array needs ml_dtypes; paddle.save/paddle.load "
                           "of bfloat16 tensors work without it")
    return mld.bfloat16


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(_bf16_numpy_type())
    return t.numpy()


def numpy_to_tensor(a) -> torch.Tensor:
    if isinstance(a, _BF16Payload):
        return a.tensor()
    a = np.array(a, order="C")  # a C-ordered copy, 0-d kept 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# bf16 in the pickle without ml_dtypes
# ---------------------------------------------------------------------------

class _MLBFloat16:
    """Stands for the class `ml_dtypes.bfloat16`: pickles as that global."""


# numpy's array reconstructor, as its own pickles name it
# (numpy._core.multiarray._reconstruct, numpy.core... before numpy 2)
_RECONSTRUCT = np.ndarray((0,), np.uint8).__reduce__()[0]
# numpy's pickled dtype state of ml_dtypes.bfloat16 (version 3, little
# endian, no fields, itemsize 2, alignment 2, flags 64)
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _BF16Dtype:
    """Pickles as numpy's `dtype(ml_dtypes.bfloat16)`; on load without
    ml_dtypes, what that reconstruction gives."""

    def __reduce__(self):
        return np.dtype, (_MLBFloat16, False, True), _BF16_DTYPE_STATE

    def __setstate__(self, state):
        if tuple(state)[5:7] != (2, 2):
            raise pickle.UnpicklingError(f"not a bfloat16 dtype state: {state!r}")


class _BF16Payload:
    """A bf16 array's shape and raw little-endian 16-bit payload. Pickles as
    numpy pickles an ml_dtypes.bfloat16 array; load without ml_dtypes gives
    one back."""

    def __init__(self, shape=(), raw=b"", fortran=False):
        self.shape, self.raw, self.fortran = tuple(shape), raw, fortran

    @classmethod
    def of(cls, t: torch.Tensor) -> "_BF16Payload":
        bits = t.detach().cpu().contiguous().view(torch.int16).numpy()
        return cls(t.shape, bits.astype("<i2", copy=False).tobytes())

    def __reduce__(self):
        return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                (1, self.shape, _BF16Dtype(), self.fortran, self.raw))

    def tensor(self) -> torch.Tensor:
        bits = np.frombuffer(self.raw, dtype="<i2").astype(np.int16)
        order = "F" if self.fortran else "C"
        bits = bits.reshape(self.shape, order=order)
        return torch.from_numpy(np.ascontiguousarray(bits)).view(torch.bfloat16)


class _Pickler(pickle._Pickler):
    """The standard library's Python pickler, which writes the stand-in
    class as the global `ml_dtypes.bfloat16` (the C pickler would import
    ml_dtypes to check the name)."""

    def save_global(self, obj, name=None):
        if obj is not _MLBFloat16:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save("ml_dtypes")
            self.save("bfloat16")
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + b"ml_dtypes\nbfloat16\n")
        self.memoize(obj)


class _ArrayBuild:
    """What numpy's array reconstructor gives on load without ml_dtypes:
    its BUILD state becomes an ndarray, or a _BF16Payload for a bf16 one."""

    def __setstate__(self, state):
        version, shape, dtype, fortran, raw = state
        if isinstance(dtype, _BF16Dtype):
            self.value = _BF16Payload(shape, raw, bool(fortran))
        else:
            a = np.ndarray.__new__(np.ndarray, (0,), np.uint8)
            a.__setstate__(state)
            self.value = a


def _reconstruct(subtype, shape, dtype):
    return _ArrayBuild() if subtype is np.ndarray else _RECONSTRUCT(subtype, shape, dtype)


def _make_dtype(obj, align=False, copy=False):
    return _BF16Dtype() if obj is _MLBFloat16 else np.dtype(obj, align, copy)


class _Unpickler(pickle.Unpickler):
    """Maps `ml_dtypes.bfloat16`, numpy's dtype constructor and its array
    reconstructor to the stand-ins above (used where ml_dtypes is absent)."""

    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _MLBFloat16
        if (module, name) == ("numpy", "dtype"):
            return _make_dtype
        if name == "_reconstruct" and module in ("numpy.core.multiarray",
                                                 "numpy._core.multiarray"):
            return _reconstruct
        return super().find_class(module, name)


def _unwrap(obj):
    """_ArrayBuild -> its ndarray or _BF16Payload, through dicts and lists."""
    if isinstance(obj, _ArrayBuild):
        return obj.value
    if isinstance(obj, dict):
        return {k: _unwrap(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unwrap(v) for v in obj)
    return obj


# ---------------------------------------------------------------------------

def host_array(t: torch.Tensor):
    """A tensor as the pickle stores it: a numpy array, or for bf16 the
    payload that pickles as an ml_dtypes.bfloat16 array."""
    return _BF16Payload.of(t) if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return {_TENSOR_TAG: True, "data": host_array(obj), "stop_gradient": not obj.requires_grad,
                "name": None}
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _from_host(obj, return_numpy):
    if isinstance(obj, dict):
        if obj.get(_TENSOR_TAG):
            data = obj["data"]
            if not return_numpy:
                return numpy_to_tensor(data)
            if isinstance(data, _BF16Payload):
                raise RuntimeError("return_numpy=True of a bfloat16 array needs ml_dtypes; "
                                   "load it as a tensor instead")
            return data
        return {k: _from_host(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_host(v, return_numpy) for v in obj)
    if isinstance(obj, _BF16Payload):
        return obj.tensor()
    return obj


def save(obj, path: str, protocol: int = 4) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_to_host(obj))


def dumps(obj, protocol: int = 4) -> bytes:
    """`save` into bytes."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(_to_host(obj))
    return buf.getvalue()


def _load_file(f, return_numpy):
    if _ml_dtypes() is not None:
        data = pickle.load(f)
    else:
        data = _unwrap(_Unpickler(f).load())
    return _from_host(data, return_numpy)


def load(path: str, return_numpy: bool = False):
    """Tagged tensors come back as torch tensors (numpy with
    return_numpy); bare numpy arrays, as save_llm writes them, stay numpy.
    Only load files this program or the JAX package wrote: unpickling runs
    code."""
    with open(path, "rb") as f:
        return _load_file(f, return_numpy)


def loads(data: bytes, return_numpy: bool = False):
    """`load` from bytes that `dumps` (or the JAX package's pickle) wrote."""
    return _load_file(io.BytesIO(data), return_numpy)
