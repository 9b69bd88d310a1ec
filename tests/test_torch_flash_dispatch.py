"""Which flash kernel variant runs, and the ctypes bindings of the kernels'
C entry points. CPU only: nothing here builds or launches a kernel.

`ops.attention.kernel_variant` is the one place the choice is made, on
dtype and head dim alone: bf16 at head dim 64 or 128 takes the tensor-core
(wgmma) kernels of the flash forward, dq and dk/dv; everything else the
CUDA-core kernels."""
import ctypes
import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.ops import attention as ta
from paddle_tpu_torch.ops.kernels import build

_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")


@pytest.mark.parametrize("kernel", _KERNELS)
@pytest.mark.parametrize("dtype,head_dim", [
    (torch.bfloat16, 64), (torch.bfloat16, 128),                 # Llama-3 128, ERNIE-3.0 64
    (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 96), (torch.bfloat16, 256),
    (torch.float32, 64), (torch.float32, 128),                   # f32 never takes TF32
])
def test_kernel_variant_rule(kernel, dtype, head_dim):
    tc = dtype == torch.bfloat16 and head_dim in (64, 128)
    assert ta.kernel_variant(kernel, dtype, head_dim) == ("wgmma" if tc else "cuda_core")


def test_kernel_variant_takes_no_other_input():
    """The rule reads dtype and head dim only: no flag or environment."""
    assert ta.TC_KERNELS == ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
    assert ta.TC_HEAD_DIMS == (64, 128)
    assert set(ta._VARIANT_CODE) == {"cuda_core", "wgmma"}


_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "unsigned int": ctypes.c_uint,
            "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_entry_points():
    """{name: [ctypes type of each parameter]} from the extern "C" functions
    of the kernel sources."""
    found = {}
    for src in build.SOURCES.values():
        text = (Path(build.__file__).parent / src).read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for p in params.split(","):
                p = " ".join(p.replace("*", " * ").split()).replace("const ", "")
                base = p.rsplit(" ", 1)[0].replace(" *", "*")
                types.append(_C_TYPES[base])
            found[name] = types
    return found


@pytest.mark.parametrize("kernel", sorted(build._SIGNATURES))
def test_ctypes_signature_matches_c_entry_point(kernel):
    """Each bound function's argtypes are its C parameters, in order (a
    missing argument would shift every later one at the call)."""
    lib, sym, argtypes = build._SIGNATURES[kernel]
    assert lib in build.SOURCES
    assert _c_entry_points()[sym] == argtypes


def test_headers_are_in_the_library_hash():
    """An edit to a shared header must rebuild every library."""
    here = Path(build.__file__).parent
    assert set(build._HEADERS) == {p.name for p in here.glob("*.cuh")}


def test_paged_attn_entry_takes_the_split_plan():
    """The paged kernel's C entry point carries the merge's workspace after
    the output and the host's split plan (pages a split, q rows a CTA)
    before the scale: the wrapper passes them in that order."""
    text = (Path(build.__file__).parent / "paged_attn.cu").read_text()
    params = re.search(r'extern "C" int ptt_paged_attn\(([^)]*)\)', text).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[7:9] == ["out", "workspace"]
    assert names[-5:] == ["M", "split_pages", "rows_per_cta", "scale", "stream"]
    assert len(names) == len(build._SIGNATURES["paged_attn"][2])
