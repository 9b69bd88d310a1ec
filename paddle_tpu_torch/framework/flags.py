"""Global flags registry (counterpart of paddle_tpu/framework/flags.py).

`set_flags`/`get_flags` as in paddle. A flag's default can be overridden
by an environment variable of the same name. Only the flags the port
reads are defined: here the framework's, beside the modules that read
them the rest (telemetry/metrics.py, request_trace.py and timeline.py,
distributed/resilience/retry.py). `watch_flag` lets a hot path cache a
flag as a plain bool (the telemetry gates do).
"""
from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_registry: dict = {}
_docs: dict = {}
_watchers: dict = {}  # flag name -> [callback(value)]


def watch_flag(name: str, fn) -> None:
    """Register `fn(value)`, fired outside the registry lock whenever
    set_flags changes `name`."""
    with _lock:
        _watchers.setdefault(name, []).append(fn)


def define_flag(name: str, default, doc: str = "") -> None:
    """Register a flag; a FLAGS_* environment variable overrides `default`."""
    with _lock:
        if name in _registry:
            return
        env = os.environ.get(name)
        value = default
        if env is not None:
            if isinstance(default, bool):
                value = env.lower() in ("1", "true", "yes", "on")
            elif isinstance(default, int):
                value = int(env)
            elif isinstance(default, float):
                value = float(env)
            else:
                value = env
        _registry[name] = value
        _docs[name] = doc


def set_flags(flags: dict) -> None:
    """paddle.set_flags: all or nothing, an unknown name raises before any
    flag changes (so no watcher is left unfired)."""
    with _lock:
        unknown = [k for k in flags if k not in _registry]
        if unknown:
            raise KeyError(f"unknown flag {unknown[0]!r}; define_flag it first")
        _registry.update(flags)
        fired = [(fn, v) for k, v in flags.items() for fn in _watchers.get(k, ())]
    for fn, v in fired:
        fn(v)


def get_flags(flags) -> dict:
    """paddle.get_flags: a name or a list of names -> {name: value}."""
    if isinstance(flags, str):
        flags = [flags]
    with _lock:
        return {k: _registry[k] for k in flags}


def get_flag(name: str):
    with _lock:
        return _registry[name]


define_flag(
    "FLAGS_fused_optimizer",
    False,
    "route Adam/AdamW through the flat-bucket engine (optimizer/fused_engine.py): "
    "params, moments and grads of one (dtype, weight decay, lr scale, clip) bucket "
    "update in one fused AdamW kernel launch per step",
)
define_flag("FLAGS_check_nan_inf", False,
            "check for nan/inf: TrainingGuardian.step's fused check over loss, grads and params "
            "(framework/guardian.py), and the static Executor's check of the state a run "
            "writes back (guardian.check_compiled_state)")
define_flag(
    "FLAGS_verify_program",
    True,
    "run the static.analysis verifier (SSA single-assignment, use-before-def, feed/param "
    "coverage, dangling fetch/grad/opt refs, op-output arity, donation hazards) before "
    "Executor._compile, so a malformed program fails with a diagnostic naming the op/var; "
    "costs O(#ops) Python per compile miss",
)
define_flag(
    "FLAGS_program_passes",
    True,
    "run the static.passes rewrite pipeline (dead-op elimination, scalar constant folding, "
    "redundant cast/reshape elimination, DRR fusion patterns: attention cluster -> flash, "
    "norm+matmul, bias+dropout+residual) over a CLONE of the recorded Program on every "
    "Executor compile miss; the caller's Program is never mutated. Disable to replay the "
    "capture exactly as recorded",
)
define_flag(
    "FLAGS_print_after_pass",
    "",
    "comma-separated pass names (or 'all') whose to_text() diff is printed to stderr after "
    "the pass rewrites a program; empty disables",
)
# Training guardian (framework/guardian.py): numerical anomaly policy,
# last-known-good rollback ring, cross-rank desync digest, crash flight
# recorder. The JAX package's defaults (paddle_tpu/framework/flags.py).
define_flag(
    "FLAGS_guardian_policy",
    "raise",
    "what TrainingGuardian.step does on a numerical anomaly: 'raise' (dump the flight "
    "recorder + GuardianAnomaly), 'skip_step' (drop the update, count the step as skipped in "
    "GradScaler accounting), or 'rollback' (restore the newest last-known-good snapshot and "
    "re-seed the generator)",
)
define_flag(
    "FLAGS_guardian_abs_ceiling",
    0.0,
    "abs-magnitude ceiling for the guardian's fused numerics check over loss/grads/params "
    "(0 disables the ceiling; non-finiteness is always checked when FLAGS_check_nan_inf is on)",
)
define_flag(
    "FLAGS_lkg_interval",
    100,
    "steps between last-known-good on-device snapshots of params + optimizer state (flat-bucket "
    "aware); the rollback policy restores the newest one",
)
define_flag("FLAGS_lkg_ring", 2, "how many last-known-good snapshots to keep")
define_flag(
    "FLAGS_desync_interval",
    0,
    "steps between cross-rank desync digest checks (parameter and bucket checksums + RNG state "
    "+ step counter compared over the group); 0 disables the periodic check, explicit "
    "check_desync() calls always run",
)
define_flag(
    "FLAGS_flight_recorder_len",
    256,
    "per-step records kept in the guardian flight recorder ring (dumped as JSON to the crash "
    "dir on a guardian abort)",
)
