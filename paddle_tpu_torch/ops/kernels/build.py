"""Build and bind the hand-written CUDA kernels.

Each `.cu` source in this directory compiles with `nvcc` for `sm_90a` into
its own shared library with a plain C interface, loaded with ctypes. All
sources compile in parallel (one nvcc process each) at the first CUDA use
of any kernel, into `_build/` next to this file (or the directory
$PADDLE_TPU_KERNEL_BUILD_DIR names); a library's file name carries a hash
of its sources and flags, so an edited source rebuilds and an unchanged
one is reused. Importing this module builds nothing.

With a persistent compile cache (PADDLE_TPU_COMPILE_CACHE_DIR, or
compile_cache.configure), a missing library is looked up in the store
first, keyed by that hash and the topology meta (card, compute
capability, torch and CUDA versions, world size): a hit restores the
library's bytes into the build directory (ledger `restore`, origin
`kernel_build`) and runs no nvcc; a miss runs nvcc (`miss`, each
library's seconds the wall it added to the parallel build, so one
build's events sum to its wall) and persists the library (`persist`). A
rejected entry (CRC, no COMPLETE, another topology) is counted under its
reason and rebuilt. `BUILD_STATS` counts nvcc processes and restores.

    python -m paddle_tpu_torch.ops.kernels.build     # build now, print ptxas info
"""
from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(os.environ.get("PADDLE_TPU_KERNEL_BUILD_DIR") or (_HERE / "_build"))
# this process's builds: nvcc processes started, libraries restored from the
# compile cache, and the wall seconds of each
BUILD_STATS = {"nvcc_runs": 0, "nvcc_s": 0.0, "restored": 0, "restore_s": 0.0}

# library name -> source file in this directory
SOURCES = {"flash_fwd": "flash_fwd.cu", "paged_attn": "paged_attn.cu", "flash_bwd": "flash_bwd.cu",
           "fused_adamw": "fused_adamw.cu", "rms_norm": "rms_norm.cu"}
_HEADERS = ("common.cuh", "sm90.cuh", "sm90_wgmma.cuh")

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_longlong
_BWD = [_I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _U, _U, _F]  # dtype .. inv_keep
# kernel function -> (library, C entry point, argument types); see the
# extern "C" functions at the end of each source
_SIGNATURES = {
    "flash_fwd": ("flash_fwd", "ptt_flash_fwd",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _U, _U, _F, _I,
                   _P]),
    "paged_attn": ("paged_attn", "ptt_paged_attn", [_P] * 9 + [_I] * 11 + [_F, _P]),
    "flash_bwd_dq": ("flash_bwd", "ptt_flash_bwd_dq", [_P] * 7 + _BWD + [_I, _P]),
    "flash_bwd_dkdv": ("flash_bwd", "ptt_flash_bwd_dkdv", [_P] * 8 + _BWD + [_I, _P]),
    "fused_adamw": ("fused_adamw", "ptt_fused_adamw",
                    [_P, _P, _P, _P, _P, _L, _I, _I, _I, _U, _F, _F, _F, _F, _F, _F, _I, _P]),
    "rms_norm": ("rms_norm", "ptt_rms_norm", [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]),
}

_lock = threading.Lock()
_functions: Dict[str, ctypes._CFuncPtr] = {}
_libraries: List[ctypes.CDLL] = []  # kept alive while the functions are used
_variant_ids = itertools.count()


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        h.update((_HERE / f).read_bytes())
    return h.hexdigest()


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash(name)[:16]}.so"


def _fingerprint(name: str) -> str:
    """The compile cache's fingerprint of library `name` (its sources and flags)."""
    from ... import compile_cache as _cc

    return _cc.fingerprint_text(f"kernel-library-v1|{name}|{_source_hash(name)}")


def _restore(todo: Dict[str, Path]) -> Dict[str, Path]:
    """Restore what the compile cache holds of `todo` into the build
    directory; returns the libraries still to build."""
    from ... import compile_cache as _cc

    st = _cc.active_store()
    if st is None:
        return todo
    meta = _cc.topology_meta()
    left = {}
    for name, path in todo.items():
        t0 = time.perf_counter()
        fp = _fingerprint(name)
        got = st.get(_cc.entry_key(fp, meta), expect_meta=meta)
        if got is None:
            left[name] = path
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(got[0])
        os.replace(tmp, path)
        dt = time.perf_counter() - t0
        BUILD_STATS["restored"] += 1
        BUILD_STATS["restore_s"] += dt
        _cc.record("kernel_build", name, "restore", seconds=dt, fingerprint=fp,
                   signature=path.name)
    return left


def _persist(name: str, path: Path, seconds: float, nvcc_s: float) -> None:
    """Record one nvcc build in the ledger and store the library."""
    from ... import compile_cache as _cc

    fp = _fingerprint(name)
    _cc.record("kernel_build", name, "miss", seconds=seconds, fingerprint=fp,
               signature=path.name, extra={"nvcc_s": nvcc_s})
    st = _cc.active_store()
    if st is None:
        return
    t0 = time.perf_counter()
    meta = _cc.make_meta("kernel_build", name, fp, signature=path.name)
    if st.put(_cc.entry_key(fp, meta["topology"]), path.read_bytes(), meta):
        _cc.record("kernel_build", name, "persist", seconds=time.perf_counter() - t0,
                   fingerprint=fp)


def _nvcc(src: Path, out: Path, defines: Optional[Dict[str, int]] = None) -> subprocess.Popen:
    cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in (defines or {}).items()),
           "-I", str(_HERE), "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(force: bool = False) -> Dict[str, str]:
    """Compile every kernel library that is missing (all in parallel),
    after restoring what the compile cache holds (`force` rebuilds every
    library and restores nothing). Returns {name: nvcc output} for the
    libraries compiled by this call; raises with the compiler's output
    when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _library_path(n) for n in SOURCES}
    if not force:
        todo = _restore({n: p for n, p in todo.items() if not p.exists()})
    if not todo:
        return {}
    t_start = time.perf_counter()
    procs, ends = {}, {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (_nvcc(_HERE / SOURCES[name], tmp), tmp, path)
    BUILD_STATS["nvcc_runs"] += len(procs)
    logs, failed = {}, []

    def wait(name, proc):
        logs[name] = proc.communicate()[0]
        ends[name] = time.perf_counter()

    waiters = [threading.Thread(target=wait, args=(n, p)) for n, (p, _, _) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for name, (proc, tmp, path) in procs.items():
        (BUILD_DIR / f"{name}.log").write_text(logs[name])
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[n] for n in failed)
        )
    BUILD_STATS["nvcc_s"] += max(ends.values()) - t_start
    # each library's share of the build's wall: what its finish added
    prev = t_start
    for name in sorted(ends, key=ends.get):
        _persist(name, todo[name], ends[name] - prev, ends[name] - t_start)
        prev = ends[name]
    return logs


def function(name: str):
    """The ctypes function of kernel `name`, building every library first
    if one is missing."""
    fn = _functions.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _functions:
            build()
            libs = {n: ctypes.CDLL(str(_library_path(n))) for n in SOURCES}
            _libraries.extend(libs.values())
            for fname, (lib, _, _) in _SIGNATURES.items():
                _functions[fname] = bind(libs[lib], fname)
    return _functions[name]


def bind(lib: ctypes.CDLL, name: str):
    """Kernel `name`'s C entry point in `lib`, with its argument types."""
    _, sym, argtypes = _SIGNATURES[name]
    f = getattr(lib, sym)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def build_variants(name: str, variants: Dict[str, tuple]) -> Dict[str, tuple]:
    """Library `name` compiled once more for each design variant, all in
    parallel, into _build/variants/: `variants` maps a label to (source,
    {macro: value}), the source None for this directory's own or the path
    of another source with the same C interface (an earlier commit's).
    Returns {label: (ctypes.CDLL, nvcc output)}. For comparing designs on
    the card (cuda_kernel_variants.py); the package itself uses
    `function`."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (src, defines) in variants.items():
        # a file name of its own: dlopen of a path already loaded would
        # return the earlier library
        so = out_dir / f"{name}-{os.getpid()}-{next(_variant_ids)}.so"
        procs[label] = (_nvcc(Path(src) if src else _HERE / SOURCES[name], so, defines), so)
    out = {}
    for label, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} variant {label!r}:\n{log}")
        out[label] = (ctypes.CDLL(str(so)), log)
    _libraries.extend(lib for lib, _ in out.values())
    return out


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reports a refused launch."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


if __name__ == "__main__":
    t0 = time.perf_counter()
    for kernel, log in build(force=True).items():
        print(f"== {kernel}\n{log}")
    print(f"built in {time.perf_counter() - t0:.1f} s into {BUILD_DIR}")
