"""Persistent compile store: the cache half (counterpart of
paddle_tpu/compile_cache/store.py).

What the port compiles ahead of a run is machine code for the card: the
hand-written kernel libraries (ops/kernels/build.py). An entry's payload
is one library's bytes, nothing pickled, under the JAX package's atomic,
CRC-verified layout:

    <root>/<fingerprint>-<topology_key>/
        payload.bin   the payload bytes
        meta.json     fingerprint, topology meta, origin, name, signature,
                      payload crc32 + byte count
        COMPLETE      commit marker (written LAST, fsync'd, then the
                      whole entry dir is atomically renamed into place)

Readers trust nothing: an entry without COMPLETE, with unparsable meta,
with a CRC mismatch, or recorded under a different topology is rejected,
counted in `paddle_tpu_compile_cache_errors_total{reason}` and treated as
a miss (the caller builds afresh), never a crash or a wrong library. A
`put` over a rejected entry replaces it, so the rebuild heals the store.
The read path carries the chaos site ``compile_cache.read``.

`gc(max_bytes)` evicts least-recently-used entries (a restore touches the
COMPLETE marker's mtime) until the store fits the budget. The process
registry (`shared_get`/`shared_put`) holds in-process results keyed the
same way.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import List, Optional, Tuple

from .. import telemetry as _tm
from . import fingerprint as _fp

__all__ = [
    "CompileCacheStore",
    "serialization_available",
    "configure",
    "active_store",
    "store_dir",
    "ENV_DIR",
]

ENV_DIR = "PADDLE_TPU_COMPILE_CACHE_DIR"
COMPLETE_MARKER = "COMPLETE"
PAYLOAD = "payload.bin"
META = "meta.json"


def serialization_available() -> bool:
    """Payloads are bytes: always available."""
    return True


def _err_counter(reason: str):
    return _tm.counter(
        "paddle_tpu_compile_cache_errors_total",
        "persistent compile-cache entries rejected on read (fell back to "
        "a fresh compile) or failed writes",
        ("reason",),
    ).labels(reason=reason)


_READ_REASONS = ("torn_entry", "bad_meta", "topology_mismatch",
                 "crc_mismatch", "read_failed")


def _count_error(reason: str) -> None:
    if _tm.enabled():
        try:
            _err_counter(reason).inc()
        except Exception:
            pass
    from ..telemetry import timeline as _tl

    # read-path rejections carry the chaos site label so an injected
    # compile_cache.read corruption is matched to the error it caused
    labels = ({"site": "compile_cache.read", "reason": reason}
              if reason in _READ_REASONS else {"reason": reason})
    _tl.emit("compile_cache", "store.error", severity="warn", labels=labels)


def _crc32_bytes(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class CompileCacheStore:
    """One on-disk compile cache rooted at `root` (created lazily)."""

    def __init__(self, root: str):
        self.root = str(root)

    # ---- layout helpers ----
    def _entry_dir(self, key: str) -> str:
        return os.path.join(self.root, key)

    def entry_keys(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(
            n for n in names
            if not n.startswith(".") and os.path.isdir(self._entry_dir(n))
        )

    # ---- write ----
    def put(self, key: str, payload: bytes, meta: dict) -> bool:
        """Commit one payload. Returns False (counted) on any failure:
        persistence is an optimization, never a hard dependency of a
        build. An entry already committed under `key` that verifies is
        kept; one that does not (torn, corrupt) is replaced."""
        final = self._entry_dir(key)
        if os.path.exists(os.path.join(final, COMPLETE_MARKER)):
            if self.verify_entry(key)[0]:
                return True  # another signature-identical build already won
            self.remove(key)
        elif os.path.isdir(final):
            self.remove(key)  # a torn entry: never renamed over
        tmp = os.path.join(self.root, f".tmp-{key}-{os.getpid()}")
        try:
            blob = bytes(payload)
            full_meta = dict(meta)
            full_meta.setdefault("created_at", time.time())
            full_meta["payload_bytes"] = len(blob)
            full_meta["payload_crc32"] = _crc32_bytes(blob)
            os.makedirs(tmp, exist_ok=True)
            _write_file(os.path.join(tmp, PAYLOAD), blob)
            _write_file(
                os.path.join(tmp, META),
                json.dumps(full_meta, sort_keys=True, indent=1).encode(),
            )
            # commit protocol: marker last, fsync entry + parent, atomic
            # rename: a torn write can only ever produce a marker-less
            # (ignored) or invisible entry, never a half-read one
            _write_file(os.path.join(tmp, COMPLETE_MARKER), b"")
            _fsync_dir(tmp)
            try:
                os.replace(tmp, final)
            except OSError:
                # a concurrent writer landed the same key first: keep theirs
                shutil.rmtree(tmp, ignore_errors=True)
                return os.path.exists(os.path.join(final, COMPLETE_MARKER))
            _fsync_dir(self.root)
            return True
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            _count_error("write_failed")
            return False

    # ---- read ----
    def _load_meta(self, key: str) -> Optional[dict]:
        try:
            with open(os.path.join(self._entry_dir(key), META)) as f:
                return json.load(f)
        except Exception:
            return None

    def get(self, key: str, expect_meta: Optional[dict] = None):
        """-> (payload bytes, meta) or None. Verifies the commit marker, the
        payload CRC, and (when `expect_meta` is given) the recorded
        topology. All failures are counted misses, never exceptions."""
        d = self._entry_dir(key)
        try:
            from ..distributed.resilience import fault_injection as _fi

            _fi.fault_point("compile_cache.read", key=key)
            if not os.path.exists(os.path.join(d, COMPLETE_MARKER)):
                if os.path.isdir(d):
                    _count_error("torn_entry")
                return None
            meta = self._load_meta(key)
            if meta is None:
                _count_error("bad_meta")
                return None
            if expect_meta is not None:
                for k in _fp.TOPOLOGY_KEYS:
                    if meta.get("topology", {}).get(k) != expect_meta.get(k):
                        _count_error("topology_mismatch")
                        return None
            with open(os.path.join(d, PAYLOAD), "rb") as f:
                blob = f.read()
            if len(blob) != meta.get("payload_bytes") or \
                    _crc32_bytes(blob) != meta.get("payload_crc32"):
                _count_error("crc_mismatch")
                return None
            # restore = a use: LRU timestamp for gc()
            try:
                os.utime(os.path.join(d, COMPLETE_MARKER))
            except OSError:
                pass
            return blob, meta
        except Exception:
            _count_error("read_failed")
            return None

    # ---- maintenance (python -m paddle_tpu_torch.compile_cache stats|verify|gc) ----
    def entry_bytes(self, key: str) -> int:
        total = 0
        d = self._entry_dir(key)
        for name in (PAYLOAD, META, COMPLETE_MARKER):
            try:
                total += os.path.getsize(os.path.join(d, name))
            except OSError:
                pass
        return total

    def verify_entry(self, key: str) -> Tuple[bool, str]:
        """(ok, reason) without deserializing (cheap CRC walk)."""
        d = self._entry_dir(key)
        if not os.path.exists(os.path.join(d, COMPLETE_MARKER)):
            return False, "missing_complete_marker"
        meta = self._load_meta(key)
        if meta is None:
            return False, "bad_meta"
        try:
            with open(os.path.join(d, PAYLOAD), "rb") as f:
                blob = f.read()
        except OSError:
            return False, "missing_payload"
        if len(blob) != meta.get("payload_bytes"):
            return False, "truncated_payload"
        if _crc32_bytes(blob) != meta.get("payload_crc32"):
            return False, "crc_mismatch"
        return True, "ok"

    def stats(self) -> dict:
        keys = self.entry_keys()
        by_origin: dict = {}
        total = 0
        corrupt = 0
        for k in keys:
            nb = self.entry_bytes(k)
            total += nb
            ok, _ = self.verify_entry(k)
            if not ok:
                corrupt += 1
                continue
            meta = self._load_meta(k) or {}
            o = by_origin.setdefault(
                str(meta.get("origin", "unknown")), {"entries": 0, "bytes": 0}
            )
            o["entries"] += 1
            o["bytes"] += nb
        return {
            "root": self.root,
            "entries": len(keys),
            "bytes": total,
            "corrupt": corrupt,
            "by_origin": by_origin,
            "serialization_available": serialization_available(),
        }

    def verify(self) -> dict:
        results = {}
        for k in self.entry_keys():
            ok, reason = self.verify_entry(k)
            results[k] = reason if not ok else "ok"
        bad = {k: r for k, r in results.items() if r != "ok"}
        return {"entries": len(results), "corrupt": len(bad),
                "failures": bad}

    def remove(self, key: str) -> None:
        shutil.rmtree(self._entry_dir(key), ignore_errors=True)

    def gc(self, max_bytes: int) -> dict:
        """Evict LRU entries (corrupt ones first) until total <= max_bytes."""
        keys = self.entry_keys()
        removed = []
        # corrupt entries are dead weight at any budget
        for k in list(keys):
            ok, reason = self.verify_entry(k)
            if not ok:
                self.remove(k)
                removed.append({"key": k, "reason": reason})
                keys.remove(k)

        def _mtime(k):
            try:
                return os.path.getmtime(
                    os.path.join(self._entry_dir(k), COMPLETE_MARKER))
            except OSError:
                return 0.0

        sized = sorted(((k, self.entry_bytes(k), _mtime(k)) for k in keys),
                       key=lambda t: t[2])
        total = sum(nb for _, nb, _ in sized)
        for k, nb, _ in sized:
            if total <= max_bytes:
                break
            self.remove(k)
            removed.append({"key": k, "reason": "lru"})
            total -= nb
        return {"removed": removed, "bytes": total,
                "max_bytes": int(max_bytes)}


# ---------------------------------------------------------------------------
# process-wide active store + in-process executable sharing
# ---------------------------------------------------------------------------

_active: dict = {"store": None, "configured": False}
_shared_lock = threading.Lock()
_MAX_SHARED = 256
_shared: "dict[str, object]" = {}


def configure(root: Optional[str]) -> Optional[CompileCacheStore]:
    """Point the process at a persistent cache directory (None disables).
    The env var PADDLE_TPU_COMPILE_CACHE_DIR configures it implicitly on
    first use, so a launched worker inherits it."""
    _active["configured"] = True
    _active["store"] = CompileCacheStore(root) if root else None
    return _active["store"]


def active_store() -> Optional[CompileCacheStore]:
    if not _active["configured"]:
        root = os.environ.get(ENV_DIR)
        _active["store"] = CompileCacheStore(root) if root else None
        _active["configured"] = True
    return _active["store"]


def store_dir() -> Optional[str]:
    st = active_store()
    return st.root if st is not None else None


def shared_get(key: str):
    """In-process registry: callers with identical signatures reuse one
    built object instead of each paying the build (counted
    `outcome=shared` by the caller)."""
    with _shared_lock:
        return _shared.get(key)


def shared_put(key: str, value) -> None:
    with _shared_lock:
        if key not in _shared and len(_shared) >= _MAX_SHARED:
            _shared.pop(next(iter(_shared)))  # FIFO bound; sharing is a hint
        _shared[key] = value


def clear_shared() -> None:
    with _shared_lock:
        _shared.clear()


def make_meta(origin: str, name: str, fingerprint: str,
              signature: Optional[str] = None, mesh=None,
              extra: Optional[dict] = None) -> dict:
    """Entry meta: the key inputs recorded verbatim so `get()` can
    re-verify and the CLI can report by origin."""
    meta = {
        "origin": str(origin),
        "name": str(name),
        "fingerprint": fingerprint,
        "signature": signature,
        "topology": _fp.topology_meta(mesh),
    }
    if extra:
        meta.update(extra)
    return meta
