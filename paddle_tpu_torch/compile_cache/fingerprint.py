"""Stable fingerprints and topology metadata for the compile cache
(counterpart of paddle_tpu/compile_cache/fingerprint.py).

A cache key has two halves:

- the **fingerprint**: a sha256 over a canonical text of what is built.
  A kernel library hashes its sources, headers and nvcc flags
  (ops/kernels/build.py); the static Executor hashes the Program's
  structure and its feed/fetch signature. `fingerprint_text`,
  `aval_signature` and `entry_key` give the JAX package's strings for
  the same text, shapes and dtypes (a dtype spells `float32`, a tree
  spells jax's `PyTreeDef(...)`).
- the **topology meta**: what a built library depends on besides its
  sources: the card's name and compute capability, the torch and CUDA
  versions, the device count and the world size. A library built for one
  topology is never restored onto another: the meta is part of the
  entry's key and is checked again against the entry's recorded meta.
"""
from __future__ import annotations

import hashlib
import json
from typing import Optional

__all__ = [
    "fingerprint_text",
    "topology_meta",
    "topology_key",
    "entry_key",
    "aval_signature",
    "TOPOLOGY_KEYS",
]

# the keys a restore compares against the entry's recorded meta
TOPOLOGY_KEYS = ("torch_version", "cuda_version", "platform", "device_name",
                 "compute_capability", "device_count", "world_size", "mesh_shape")


def fingerprint_text(text: str) -> str:
    """sha256 (hex, truncated to 32 chars) of a canonical text."""
    return hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()[:32]


def topology_meta(mesh=None) -> dict:
    """The environment half of a cache key: everything that must match for
    a stored library to load and run correctly on this process's card."""
    import torch

    meta = {"torch_version": torch.__version__, "cuda_version": torch.version.cuda,
            "platform": "cpu", "device_name": None, "compute_capability": None,
            "device_count": 0, "world_size": 1, "mesh_shape": None}
    try:
        if torch.cuda.is_available():
            dev = torch.cuda.current_device()
            meta["platform"] = "cuda"
            meta["device_name"] = torch.cuda.get_device_name(dev)
            meta["compute_capability"] = "%d.%d" % torch.cuda.get_device_capability(dev)
            meta["device_count"] = torch.cuda.device_count()
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            meta["world_size"] = int(dist.get_world_size())
    except Exception:
        pass
    if mesh is not None:
        shape = getattr(mesh, "shape", None)
        try:
            meta["mesh_shape"] = {str(k): int(v) for k, v in dict(shape).items()}
        except Exception:
            meta["mesh_shape"] = str(shape)
    return meta


def topology_key(meta: Optional[dict] = None) -> str:
    """Short stable digest of a topology meta (part of an entry's key)."""
    meta = meta if meta is not None else topology_meta()
    return hashlib.sha256(json.dumps(meta, sort_keys=True).encode()).hexdigest()[:16]


def entry_key(fingerprint: str, meta: Optional[dict] = None) -> str:
    """Disk entry name: the fingerprint and the topology meta's digest."""
    return f"{fingerprint}-{topology_key(meta)}"


def _dtype_name(leaf) -> str:
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return type(leaf).__name__
    return str(dt).replace("torch.", "")


def _flatten(tree, leaves: list) -> str:
    """jax's PyTreeDef text of `tree` (lists, tuples, dicts with sorted keys,
    None as an empty node); appends the leaves in jax's order."""
    if tree is None:
        return "None"
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x, leaves) for x in tree]
        if isinstance(tree, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + (",)" if len(parts) == 1 else ")")
    if isinstance(tree, dict):
        parts = [f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)]
        return "{" + ", ".join(parts) + "}"
    leaves.append(tree)
    return "*"


def aval_signature(tree) -> str:
    """Canonical text for a tree of tensors (or arrays, or meta tensors):
    shape and dtype per leaf, structure included, in the JAX package's
    format."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    parts = [f"{tuple(getattr(x, 'shape', ()))}:{_dtype_name(x)}" for x in leaves]
    return f"PyTreeDef({treedef})|{';'.join(parts)}"
