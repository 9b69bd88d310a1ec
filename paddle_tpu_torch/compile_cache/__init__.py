"""Compile-lifecycle observability and the persistent compile cache
(counterpart of paddle_tpu/compile_cache).

Two halves:

- **Observability** (`ledger`): the kernel build (ops/kernels/build.py)
  and the static Executor's first run of a signature emit structured
  events (origin, fingerprint, signature, wall seconds, outcome) into a
  bounded store with `paddle_tpu_compile_*` telemetry, and the serving
  engine leaves the timeline marks from which `python -m
  paddle_tpu_torch.compile_cache report` decomposes the engine-load ->
  first-token wall.
- **Cache** (`store`): the kernel libraries, persisted keyed by (sources
  and flags, topology meta) in an atomic CRC-verified layout and restored
  instead of rebuilt by the next process. Point the process at a
  directory with `configure(path)` or `PADDLE_TPU_COMPILE_CACHE_DIR`.
  Without one, kernels build into the package's `_build/` as before.
"""
from . import fingerprint, ledger, report, store  # noqa: F401
from .fingerprint import (  # noqa: F401
    aval_signature,
    entry_key,
    fingerprint_text,
    topology_meta,
)
from .ledger import (  # noqa: F401
    events,
    record,
    reset,
    reset_timeline,
    summary,
)
from .report import cold_start_report, format_report  # noqa: F401
from .store import (  # noqa: F401
    CompileCacheStore,
    active_store,
    clear_shared,
    configure,
    make_meta,
    serialization_available,
    shared_get,
    shared_put,
    store_dir,
)

__all__ = [
    "fingerprint",
    "ledger",
    "report",
    "store",
    "aval_signature",
    "entry_key",
    "fingerprint_text",
    "topology_meta",
    "events",
    "record",
    "reset",
    "reset_timeline",
    "summary",
    "cold_start_report",
    "format_report",
    "CompileCacheStore",
    "active_store",
    "clear_shared",
    "configure",
    "make_meta",
    "serialization_available",
    "shared_get",
    "shared_put",
    "store_dir",
]
