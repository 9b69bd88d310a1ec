"""Training guardian: state-failure guards for the training loop
(counterpart of paddle_tpu/framework/guardian.py).

Reference parity: paddle/fluid/framework/details/nan_inf_utils* and
python/paddle/amp/debugging.py (TensorChecker) detect anomalies; the
reference leaves recovery to the user. This module guards the state:

1. **Numerical anomaly guard**: one fused check over loss, grads and
   params (finiteness and an optional abs-magnitude ceiling,
   `FLAGS_guardian_abs_ceiling`), one pass over each tensor, whose
   booleans and grad norm combine on the device, so a guarded step costs
   ONE device->host read, gated by
   `FLAGS_check_nan_inf`. The verdict drives a policy
   (`FLAGS_guardian_policy` or the instance's): `raise` dumps the flight
   recorder and raises, `skip_step` drops the update (counted in
   GradScaler's bookkeeping through `record_external_skip`), `rollback`
   restores the newest last-known-good snapshot. A skipped or rolled-back
   step never calls `optimizer.step()`, so no fused AdamW kernel runs for
   it.

2. **Last-known-good snapshots**: a ring (`FLAGS_lkg_ring`) of on-device
   copies of the parameters and the optimizer state, taken every
   `FLAGS_lkg_interval` clean steps. The optimizer names its state
   (`Optimizer._state_slots`): per-param accumulators, the stacked and
   flat buckets' moments (`_fused_state_entries`) and beta powers, and the
   host-side `_step_count`. `rollback()` writes every covered value back
   bit for bit (tensors in place, so the flat buckets and the
   parameters keep their identity), resets state born after the snapshot
   to its creation fill, restores the generators and folds the rollback
   count into them.

3. **Cross-rank desync detector**: a per-rank digest vector, one
   position-sensitive uint32 checksum per parameter and per optimizer
   state unit plus the RNG state and the step counter. `digest_arrays` is
   bit for bit the JAX package's `_digest_impl`. Comparing digests across
   ranks needs `distributed.collective` and the comm-watchdog ladder
   (ROADMAP Queue A item 5): a group of more than one rank raises
   NotImplementedError; a single rank has nothing to compare (None).

4. **Flight recorder**: a bounded ring of per-step records (loss, grad
   norm, lr, skip/rollback/anomaly events) dumped as JSON to a crash dir by
   any guardian abort.

FaultPlan chaos sites: `guardian.grad_nan` (poison one gradient value with
NaN inside `TrainingGuardian.step`, before the check) and
`guardian.bucket_bitflip` (the multi-rank drill, with the detector).
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import flags as _flags
from . import random as random_mod

POLICIES = ("raise", "skip_step", "rollback")

# anomaly bitmask returned by the fused check
ANOMALY_NONFINITE = 1
ANOMALY_MAGNITUDE = 2

_ROADMAP_DIST = "ROADMAP Queue A item 5"


class GuardianAnomaly(FloatingPointError):
    """Raised by the `raise` policy (and the compiled-state hook) after the
    flight recorder has been dumped."""

    def __init__(self, msg: str, kind: str = "nonfinite", dump_paths=()):
        super().__init__(msg)
        self.kind = kind
        self.dump_paths = list(dump_paths)


# ---------------------------------------------------------------------------
# fused numerics check
# ---------------------------------------------------------------------------


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _floating(values):
    out = []
    for v in values:
        t = _as_tensor(v).detach()
        if t.is_floating_point():
            # the JAX package checks every value in f32: an f64 beyond f32's
            # range reads as non-finite there, and so here
            out.append(t.float() if t.dtype == torch.float64 else t)
    return out


def _by_device_dtype(ts) -> list:
    groups: dict = {}
    for t in ts:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return list(groups.values())


def _max_abs(ts, dev) -> torch.Tensor:
    """[n] f32 on `dev`: each tensor's largest |x| (NaN where it holds a NaN)."""
    parts = [torch.stack(torch._foreach_norm(g, float("inf"))).float().to(dev)
             for g in _by_device_dtype(ts)]
    return torch.cat(parts) if parts else torch.zeros(0, device=dev)


def _l2_norms(ts, dev) -> torch.Tensor:
    """[n] f32 on `dev`: each tensor's L2 norm, accumulated in f32."""
    parts = [torch.stack(torch._foreach_norm(g, 2, dtype=torch.float32)).to(dev)
             for g in _by_device_dtype(ts)]
    return torch.cat(parts) if parts else torch.zeros(0, device=dev)


def check_arrays(grad_vals, other_vals=(), ceiling: float = 0.0):
    """The fused numerics check over raw tensors.

    Returns `(mask, grad_norm)` as host scalars: `mask` is a bitwise OR of
    ANOMALY_NONFINITE / ANOMALY_MAGNITUDE (0 = clean) and `grad_norm` the
    global L2 norm over `grad_vals`. Non-floating tensors are skipped.

    One pass over each tensor (multi-tensor `_foreach_norm`): the grads'
    L2 norms, which are finite exactly when every element is (a NaN or an
    inf carries through the sum of squares), and the other tensors' max
    |x|; with a magnitude ceiling the grads' max |x| too. The booleans and
    the norm combine on the device and the host reads two numbers once.
    Only an anomalous step looks again: a sum of squares can overflow to
    inf over finite grads, and a NaN hides a tensor's max |x| from the
    ceiling, which the JAX package compares element by element.
    """
    gs = _floating(grad_vals)
    os_ = _floating(other_vals)
    if not gs and not os_:
        return 0, 0.0
    dev = (gs or os_)[0].device
    ceil = float(np.float32(ceiling))
    norms = _l2_norms(gs, dev)
    others = _max_abs(os_, dev)
    nonfinite = ~(torch.isfinite(norms).all() & torch.isfinite(others).all())
    if ceil > 0.0:
        over = (others > ceil).any() | (_max_abs(gs, dev) > ceil).any()
    else:
        over = torch.zeros((), dtype=torch.bool, device=dev)
    gn = norms.square().sum().sqrt()
    flags = nonfinite.to(torch.float32) * ANOMALY_NONFINITE + over.to(torch.float32) * ANOMALY_MAGNITUDE
    host = torch.stack([flags, gn]).tolist()  # the step's one host read
    mask = int(host[0])
    if mask & ANOMALY_NONFINITE:
        # an anomalous step: decide element by element, as the JAX package
        if gs and bool(torch.isfinite(_max_abs(gs, dev)).all()) \
                and bool(torch.isfinite(others).all()):
            mask &= ~ANOMALY_NONFINITE  # the sum of squares overflowed
        if ceil > 0.0 and not mask & ANOMALY_MAGNITUDE and any(
                bool((torch.nan_to_num(t.float(), nan=0.0, posinf=float("inf"),
                                       neginf=float("-inf")).abs() > ceil).any())
                for t in gs + os_):
            mask |= ANOMALY_MAGNITUDE
    return mask, float(host[1])


def _anomaly_kind(mask: int) -> str:
    kinds = []
    if mask & ANOMALY_NONFINITE:
        kinds.append("nonfinite")
    if mask & ANOMALY_MAGNITUDE:
        kinds.append("magnitude")
    return "+".join(kinds) or "clean"


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

_recorders: "weakref.WeakSet" = weakref.WeakSet()
_noted_ckpt_dir: List[Optional[str]] = [None]


def note_checkpoint_dir(path: str) -> None:
    """Remember the latest checkpoint root so crash dumps land next to the
    checkpoint by default."""
    _noted_ckpt_dir[0] = os.path.join(str(path), "crash")


def default_crash_dir() -> str:
    env = os.environ.get("PADDLE_TPU_CRASH_DIR")
    if env:
        return env
    if _noted_ckpt_dir[0]:
        return _noted_ckpt_dir[0]
    return os.path.join(os.getcwd(), "paddle_tpu_crash")


class FlightRecorder:
    """Bounded ring of per-step records and events, dumped as JSON on a
    crash. Records are plain dicts; the ring length follows
    `FLAGS_flight_recorder_len` unless overridden."""

    def __init__(self, capacity: Optional[int] = None, name: str = "train",
                 crash_dir: Optional[str] = None):
        if capacity is None:
            capacity = int(_flags.get_flag("FLAGS_flight_recorder_len"))
        self.name = name
        self.crash_dir = crash_dir
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self._seq = 0
        _recorders.add(self)

    def record(self, kind: str, **fields) -> None:
        rec = {"t": time.time(), "kind": kind}
        rec.update(fields)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)

    def record_step(self, step: int, **fields) -> None:
        self.record("step", step=int(step), **fields)

    def record_event(self, event: str, **fields) -> None:
        self.record("event", event=event, **fields)

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str = "", crash_dir: Optional[str] = None) -> str:
        """Write the ring as one JSON file; returns the path."""
        d = crash_dir or self.crash_dir or default_crash_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"flight_{self.name}_{os.getpid()}_{int(time.time() * 1000)}.json")
        payload = {
            "version": 1,
            "reason": reason,
            "dumped_at": time.time(),
            "name": self.name,
            "pid": os.getpid(),
            "records": self.records(),
        }
        # the device memory high-water mark and the newest program records
        try:
            from ..profiler import perf_attribution as _pa

            payload["peak_hbm_bytes"] = _pa.watermark().get("peak_hbm_bytes")
            payload["perf_report"] = _pa.snapshot_for_crash()
        except Exception:
            pass  # attribution must never mask the dump
        # the metric registry, leniently: the dump must survive the NaN gauge
        # it exists to report
        try:
            from .. import telemetry as _tm

            if _tm.enabled():
                payload["telemetry"] = _tm.to_json_lines(strict=False).splitlines()
        except Exception:
            pass
        try:
            from ..telemetry import timeline as _tl

            if _tl.enabled():
                payload["timeline"] = _tl.tail(256)
                payload["timeline_dropped"] = _tl.dropped()
        except Exception:
            pass
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
            f.write("\n")
        return path


def dump_flight_recorders(reason: str = "", crash_dir: Optional[str] = None) -> list:
    """Dump every live flight recorder; returns the written paths."""
    paths = []
    for rec in list(_recorders):
        try:
            paths.append(rec.dump(reason=reason, crash_dir=crash_dir))
        except Exception:
            pass  # a failing dump must never mask the abort path
    return paths


def _collective_latency_totals() -> dict:
    """op -> (count, sum) cumulative totals from the telemetry registry."""
    from .. import telemetry as _tm

    if not _tm.enabled():
        return {}
    fam = _tm.default_registry().get("paddle_tpu_collective_latency_seconds")
    if fam is None:
        return {}
    totals: dict = {}
    for child in fam.children():
        op = dict(child.labels).get("op", "?")
        c, s = totals.get(op, (0, 0.0))
        totals[op] = (c + child.count, s + child.sum)
    return totals


# ---------------------------------------------------------------------------
# digests (cross-rank desync)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1
_CHUNK = 1 << 25  # elements per pass: int64 temporaries of 256 MB, not 8 B an element at once
_mix_cache: dict = {}


def _mix_base(device) -> torch.Tensor:
    """(i * 0x9E3779B1 + 1) mod 2^32 for i < _CHUNK, int64 (no overflow:
    i * K < 2^57)."""
    key = str(device)
    base = _mix_cache.get(key)
    if base is None:
        base = (torch.arange(_CHUNK, dtype=torch.int64, device=device) * _GOLDEN + 1) & _M32
        _mix_cache[key] = base
    return base


def _lanes(flat: torch.Tensor) -> torch.Tensor:
    """The uint32 lane of each element in int64, as `_digest_impl` forms it
    (paddle_tpu/framework/guardian.py:293-313): 16-bit floats zero-extended,
    f32 bits, f64 high word XOR low word (masked: torch's >> on int64 is
    arithmetic), anything else converted to uint32 with wraparound."""
    dt = flat.dtype
    if dt in (torch.bfloat16, torch.float16):
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    if dt == torch.float32:
        return flat.view(torch.int32).to(torch.int64) & _M32
    if dt == torch.float64:
        u = flat.view(torch.int64)
        return (u ^ ((u >> 32) & _M32)) & _M32
    return flat.to(torch.int64) & _M32


def _digest_one(t: torch.Tensor) -> torch.Tensor:
    """One order/position-sensitive uint32 checksum (as int64 on t's
    device): each lane XOR (index * 0x9E3779B1 + 1), summed mod 2^32."""
    flat = t.detach().reshape(-1)
    base = _mix_base(flat.device)
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    for start in range(0, flat.numel(), _CHUNK):
        part = flat[start:start + _CHUNK]
        mix = (base[:part.numel()] + ((start * _GOLDEN) & _M32)) & _M32
        total = (total + (_lanes(part) ^ mix).sum()) & _M32
    return total


def digest_arrays(arrays) -> np.ndarray:
    """Host uint32 digest vector, one entry per tensor, bit for bit the
    JAX package's `digest_arrays`; computed on each tensor's device and
    read back once."""
    if not arrays:
        return np.zeros((0,), np.uint32)
    ds = [_digest_one(_as_tensor(a)).cpu() for a in arrays]
    return torch.stack(ds).numpy().astype(np.uint32)


def _flip_one_bit(arr, seed: int, salt: int) -> torch.Tensor:
    """Deterministically flip one bit of a copy of `arr` (chaos drill only):
    the JAX package's byte and bit for the same seed and salt."""
    import random as _random

    t = _as_tensor(arr).detach()
    buf = t.cpu().contiguous().clone().reshape(-1).view(torch.uint8)
    rng = _random.Random(f"{seed}:bitflip:{salt}")
    byte = rng.randrange(buf.numel())
    bit = rng.randrange(8)
    buf[byte] ^= 1 << bit
    return buf.view(t.dtype).reshape(t.shape).to(t.device)


def _rng_word() -> np.uint32:
    """XOR of the generators' states as uint32 words (sorted by device)."""
    st = random_mod.get_rng_state()
    raw = b"".join(bytes(st[k].cpu().numpy().tobytes()) for k in sorted(st))
    raw += b"\0" * (-len(raw) % 4)
    if not raw:
        return np.uint32(0)
    return np.uint32(np.bitwise_xor.reduce(np.frombuffer(raw, np.uint32)))


class DesyncDetector:
    """Periodic cross-rank digest comparison over a collective group.

    The digest (`local_digest`) is the JAX package's. Its comparison over a
    group of more than one rank (MIN/MAX all-reduce, majority vote, the
    watchdog escalation) waits for the distributed runtime (ROADMAP Queue A
    item 5) and raises; a single rank returns None, as in the JAX package.
    """

    def __init__(self, optimizer, group=None, recorder: Optional[FlightRecorder] = None):
        self.optimizer = optimizer
        self.group = group
        self.recorder = recorder

    def digest_units(self) -> List[Tuple[str, torch.Tensor]]:
        """[(unit name, tensor)]: params, then the optimizer state."""
        opt = self.optimizer
        names = getattr(opt, "_param_names", {})
        units: List[Tuple[str, torch.Tensor]] = []
        pid2idx = {}
        for i, (_, p) in enumerate(opt._all_params()):
            pid2idx[id(p)] = i
            units.append((names.get(id(p)) or f"param:{i}", p))
        for name, store in sorted(opt._accumulators.items()):
            for pid, t in store.items():
                if isinstance(t, torch.Tensor):
                    units.append((f"accum:{name}:{pid2idx.get(pid, '?')}", t))
        for bi, st in enumerate(getattr(opt, "_fused_buckets", {}).values()):
            for gi, grp in enumerate(st["groups"]):
                for nm in ("moment1", "moment2"):
                    units.append((f"stacked_bucket:{bi}.{gi}:{nm}", grp[nm]))
        eng = getattr(opt, "_flat_engine", None)
        if eng is not None:
            units.extend(eng.digest_units())
        return units

    def local_digest(self) -> Tuple[List[str], np.ndarray]:
        units = self.digest_units()
        names = [n for n, _ in units]
        vec = digest_arrays([a for _, a in units])
        names += ["rng_state", "step_count"]
        extra = [_rng_word(), np.uint32(int(self.optimizer._step_count) & _M32)]
        return names, np.concatenate([vec, np.asarray(extra, np.uint32)])

    def check(self, escalate: bool = True) -> Optional[dict]:
        """One desync check: None when every rank agrees, which a single
        rank always does. A group of more than one rank raises until the
        distributed runtime is ported."""
        from .. import telemetry as _tm

        group = self.group
        n = getattr(group, "nranks", 1) if group is not None else 1
        if _tm.enabled():
            _tm.counter(
                "paddle_tpu_guardian_desync_checks_total",
                "cross-rank desync digest comparisons",
            ).inc()
        if n <= 1:
            return None
        raise NotImplementedError(
            f"DesyncDetector over {n} ranks needs distributed.collective and the comm-watchdog "
            f"escalation ladder ({_ROADMAP_DIST}); local_digest() is available")


# ---------------------------------------------------------------------------
# training guardian
# ---------------------------------------------------------------------------


def _under_trace(tensors) -> bool:
    """True inside a static capture's dry run or a torch trace: the values
    are placeholders, never checked."""
    from ..core import state

    if state.get_program_capture() is not None or torch.compiler.is_compiling():
        return True
    py = torch._C.DispatchKey.Python
    return any(t is not None and isinstance(t, torch.Tensor)
               and (t.is_meta or torch._C._dispatch_keys(t).has(py)) for t in tensors)


class TrainingGuardian:
    """Wraps the optimizer step with the anomaly guard, the last-known-good
    ring, the desync detector and the flight recorder.

    Usage (drop-in for `optimizer.step()` / `scaler.step(optimizer)`)::

        guardian = TrainingGuardian(opt, scaler=scaler, policy="rollback")
        for batch in loader:
            loss = model(batch)
            (scaler.scale(loss) if scaler else loss).backward()
            verdict = guardian.step(loss)   # 'ok' | 'skipped' | 'rolled_back'
            opt.clear_grad()

    The numerics check runs only when FLAGS_check_nan_inf is on; with it off
    the guardian still keeps the flight recorder and the LKG ring warm.
    Inside a static capture's dry run the guardian runs a plain step (one
    warning); the Executor's compiled-state hook checks the replays.
    """

    def __init__(self, optimizer, scaler=None, policy: Optional[str] = None,
                 ceiling: Optional[float] = None, lkg_interval: Optional[int] = None,
                 lkg_ring: Optional[int] = None, desync_interval: Optional[int] = None,
                 group=None, crash_dir: Optional[str] = None,
                 recorder: Optional[FlightRecorder] = None, name: str = "train",
                 grad_reducer=None):
        if policy is not None and policy not in POLICIES:
            raise ValueError(f"guardian policy must be one of {POLICIES}, got {policy!r}")
        self.optimizer = optimizer
        self.scaler = scaler
        # an async bucketed gradient reducer (distributed, item 5): flushed
        # before the grads are read
        self.grad_reducer = grad_reducer
        self._policy = policy
        self._ceiling = ceiling
        self._lkg_interval = lkg_interval
        self._desync_interval = desync_interval
        ring = lkg_ring if lkg_ring is not None else int(_flags.get_flag("FLAGS_lkg_ring"))
        self._snapshots: deque = deque(maxlen=max(int(ring), 1))
        self.recorder = recorder or FlightRecorder(name=name, crash_dir=crash_dir)
        if crash_dir is not None:
            self.recorder.crash_dir = crash_dir
        self.detector = DesyncDetector(optimizer, group=group, recorder=self.recorder)
        self.steps_total = 0
        self.skipped_steps = 0
        self.rollbacks = 0
        self._rollback_count = 0
        self._warned_tracing = False
        self._injected_site = None
        self._coll_totals = _collective_latency_totals()

    # ---- config (flag-backed, overridable per instance) ----
    @property
    def policy(self) -> str:
        p = self._policy or str(_flags.get_flag("FLAGS_guardian_policy"))
        if p not in POLICIES:
            raise ValueError(f"FLAGS_guardian_policy must be one of {POLICIES}, got {p!r}")
        return p

    @property
    def ceiling(self) -> float:
        if self._ceiling is not None:
            return float(self._ceiling)
        return float(_flags.get_flag("FLAGS_guardian_abs_ceiling"))

    @property
    def lkg_interval(self) -> int:
        if self._lkg_interval is not None:
            return int(self._lkg_interval)
        return int(_flags.get_flag("FLAGS_lkg_interval"))

    @property
    def desync_interval(self) -> int:
        if self._desync_interval is not None:
            return int(self._desync_interval)
        return int(_flags.get_flag("FLAGS_desync_interval"))

    # ---- the guarded step ----
    def step(self, loss=None) -> str:
        opt = self.optimizer
        self.steps_total += 1
        if self.grad_reducer is not None:
            self.grad_reducer.flush()
        grads = [p.grad for _, p in opt._all_params() if p.grad is not None]
        if _under_trace([loss] + grads):
            if not self._warned_tracing:
                self._warned_tracing = True
                import warnings

                warnings.warn(
                    "TrainingGuardian.step is running under a static capture or a trace: "
                    "anomaly policies need real values and are off for the captured step; "
                    "the Executor's compiled-state check applies to its runs", stacklevel=2)
            self._plain_step()
            return "ok"
        scaler_on = self.scaler is not None and self.scaler.is_enable()
        if scaler_on:
            # unscale first so the check (and any skip decision) sees the
            # true gradients; scaler.step won't unscale again
            self.scaler.unscale_(opt)
        self._maybe_inject_grad_nan(grads)
        loss_raw = self._loss_raw(loss)
        mask, grad_norm = 0, None
        if _flags.get_flag("FLAGS_check_nan_inf"):
            t0 = time.perf_counter()
            mask, grad_norm = self._check(loss_raw, grads)
            self._observe_check(time.perf_counter() - t0)
        if mask:
            return self._handle_anomaly(mask, loss_raw, grad_norm)
        self._plain_step()
        self._after_clean_step(loss_raw, grad_norm)
        return "ok"

    def _plain_step(self):
        if self.scaler is not None and self.scaler.is_enable():
            self.scaler.step(self.optimizer)
        else:
            self.optimizer.step()

    def _loss_raw(self, loss):
        """The unscaled loss: the caller backward()s through the
        GradScaler-scaled loss, and the check and the recorder see the
        unscaled grads, so the loss is divided by the scale too."""
        if not isinstance(loss, torch.Tensor):
            return None
        v = loss.detach()
        if self.scaler is not None and self.scaler.is_enable():
            v = v / torch.tensor(self.scaler._scale, dtype=torch.float32).to(v.device, v.dtype)
        return v

    def _check(self, loss_raw, grads):
        other = [p for _, p in self.optimizer._all_params()]
        if loss_raw is not None:
            other.append(loss_raw)
        return check_arrays(grads, other, self.ceiling)

    def _observe_check(self, dt):
        from .. import telemetry as _tm

        if _tm.enabled():
            _tm.histogram(
                "paddle_tpu_guardian_check_seconds",
                "host wall time of the fused numerics check (incl. the one scalar sync)",
            ).observe(dt)

    def _maybe_inject_grad_nan(self, grads):
        from ..distributed.resilience import fault_injection as _fi

        spec = _fi.corrupt_value("guardian.grad_nan")
        if spec is None or not grads:
            return
        # remembered until the anomaly check fires, so the anomaly event
        # carries the injection's site label (chaos coverage)
        self._injected_site = "guardian.grad_nan"
        with torch.no_grad():
            grads[0].view(-1)[0] = float("nan")

    # ---- anomaly handling ----
    def _handle_anomaly(self, mask: int, loss_raw, grad_norm) -> str:
        from .. import telemetry as _tm
        from ..telemetry import timeline as _tl

        kind = _anomaly_kind(mask)
        policy = self.policy
        step = int(self.optimizer._step_count)
        try:
            from ..profiler import perf_attribution as _pa

            wm = _pa.sample_watermark(tag=f"anomaly:{kind}", force=True)
        except Exception:
            wm = None
        if self.scaler is not None:
            # the skipped step never reaches scaler.step, which is what
            # clears the per-step unscale bookkeeping
            self.scaler._unscaled.discard(id(self.optimizer))
        if _tm.enabled():
            _tm.counter(
                "paddle_tpu_guardian_anomalies_total",
                "numerical anomalies caught by the guardian", ("kind", "policy"),
            ).labels(kind=kind, policy=policy).inc()
        self.recorder.record_event(
            "anomaly", anomaly=kind, policy=policy, step=step,
            loss=_loss_float(loss_raw), grad_norm=grad_norm,
            peak_hbm_bytes=(wm or {}).get("peak_hbm_bytes"),
            input_wait_s=_input_wait_delta(),
        )
        try:
            inj_site, self._injected_site = self._injected_site, None
            _tl.emit("guardian", "anomaly",
                     severity="fatal" if policy == "raise" else "error",
                     labels={"site": inj_site} if inj_site else None,
                     anomaly=kind, policy=policy, step=step,
                     loss=_loss_float(loss_raw), grad_norm=grad_norm)
        except Exception:
            pass
        if policy == "skip_step":
            self.skipped_steps += 1
            if _tm.enabled():
                _tm.counter(
                    "paddle_tpu_guardian_steps_skipped_total",
                    "optimizer steps dropped by the skip_step policy",
                ).inc()
            if self.scaler is not None and self.scaler.is_enable():
                self.scaler.record_external_skip()
            return "skipped"
        if policy == "rollback":
            if not self._snapshots:
                # nothing to restore yet: degrade to skip (recorded as such)
                self.recorder.record_event("rollback_unavailable", step=step)
                _tl.emit("guardian", "rollback_unavailable", severity="warn", step=step)
                self.skipped_steps += 1
                if self.scaler is not None and self.scaler.is_enable():
                    self.scaler.record_external_skip()
                return "skipped"
            self.rollback()
            return "rolled_back"
        paths = dump_flight_recorders(reason=f"anomaly:{kind}")
        raise GuardianAnomaly(
            f"training guardian: {kind} anomaly at step {step} "
            f"(policy=raise; flight recorder: {paths})",
            kind=kind, dump_paths=paths,
        )

    # ---- last-known-good ring ----
    def _slots(self):
        """[(holder, key, fill)]: the optimizer's state slots and the
        GradScaler's counters (host values)."""
        slots = list(self.optimizer._state_slots())
        if self.scaler is not None and self.scaler.is_enable():
            slots.extend((self.scaler.__dict__, k, None)
                         for k in ("_scale", "_good_steps", "_bad_steps"))
        return slots

    def snapshot(self) -> None:
        """Take one last-known-good snapshot: device copies of the
        parameters and of every optimizer state tensor, and the host values
        (beta powers, `_step_count`, the scaler's counters, the
        generators)."""
        from .. import telemetry as _tm

        opt = self.optimizer
        opt._materialize_state()
        if len(self._snapshots) == self._snapshots.maxlen:
            # free the oldest copy before taking the next: the ring never
            # holds one snapshot more than its length in device memory
            self._snapshots.popleft()
        with torch.no_grad():
            params = [(p, p.detach().clone()) for _, p in opt._all_params()]
            slots = [(h, k, h[k].detach().clone() if isinstance(h[k], torch.Tensor) else h[k])
                     for h, k, _ in self._slots()]
        self._snapshots.append({
            "step": int(opt._step_count),
            "params": params,
            "slots": slots,
            "rng": {k: v.clone() for k, v in random_mod.get_rng_state().items()},
            "wall": time.time(),
        })
        if _tm.enabled():
            _tm.counter("paddle_tpu_guardian_snapshots_total",
                        "last-known-good snapshots taken").inc()

    def snapshot_tensors(self, snap: Optional[dict] = None) -> List[torch.Tensor]:
        """The tensors a snapshot holds (parameters, then state), in the
        order `state_tensors()` lists the live ones: for digests."""
        snap = snap if snap is not None else self._snapshots[-1]
        return ([v for _, v in snap["params"]]
                + [v for _, _, v in snap["slots"] if isinstance(v, torch.Tensor)])

    def state_tensors(self) -> List[torch.Tensor]:
        """The live parameters and optimizer state tensors."""
        return ([p for _, p in self.optimizer._all_params()]
                + [h[k] for h, k, _ in self._slots() if isinstance(h[k], torch.Tensor)])

    def rollback(self) -> int:
        """Restore the newest last-known-good snapshot bit for bit.

        Tensors are written in place (the parameters, the flat buckets and
        every view of them keep their identity); host values are set back.
        State created after the snapshot resets to its fill, as GradScaler's
        skip leaves it. The generators restore to the snapshot's states
        with the rollback count folded in, so the retried steps draw fresh
        but reproducible dropout. Gradients are cleared: the anomalous
        grads must not be applied to the restored params.
        """
        from .. import telemetry as _tm
        from ..telemetry import timeline as _tl

        snap = self._snapshots[-1]
        covered = {(id(h), k): v for h, k, v in snap["slots"]}
        with torch.no_grad():
            for p, v in snap["params"]:
                p.copy_(v)
            for h, k, fill in self._slots():
                cur = h[k]
                v = covered.get((id(h), k), _MISSING)
                if v is _MISSING:
                    if fill is None:
                        continue
                    if isinstance(cur, torch.Tensor):
                        cur.fill_(fill)
                    else:
                        h[k] = type(cur)(fill) if isinstance(cur, (np.floating, float)) else fill
                elif isinstance(v, torch.Tensor):
                    if (isinstance(cur, torch.Tensor) and cur.shape == v.shape
                            and cur.dtype == v.dtype):
                        cur.copy_(v)
                    else:
                        h[k] = v.clone()
                else:
                    h[k] = v
        self._rollback_count += 1
        self.rollbacks += 1
        random_mod.set_rng_state({k: v.clone() for k, v in snap["rng"].items()})
        random_mod.fold_in(self._rollback_count)
        self.optimizer.clear_grad()
        self.recorder.record_event("rollback", restored_step=snap["step"],
                                   rollback=self._rollback_count)
        _tl.emit("guardian", "rollback", severity="warn",
                 restored_step=snap["step"], rollback=self._rollback_count)
        if _tm.enabled():
            _tm.counter("paddle_tpu_guardian_rollbacks_total",
                        "rollbacks to a last-known-good snapshot").inc()
        return snap["step"]

    @property
    def snapshots(self):
        return list(self._snapshots)

    # ---- post-step bookkeeping ----
    def _after_clean_step(self, loss_raw, grad_norm) -> None:
        opt = self.optimizer
        step = int(opt._step_count)
        try:
            from ..profiler import perf_attribution as _pa

            wm = _pa.watermark()
        except Exception:
            wm = {}
        self.recorder.record_step(
            step,
            loss=_loss_float(loss_raw),
            grad_norm=grad_norm,
            lr=float(opt.get_lr()),
            collectives=self._collective_deltas(),
            peak_hbm_bytes=wm.get("peak_hbm_bytes"),
            input_wait_s=_input_wait_delta(),
        )
        interval = self.lkg_interval
        if interval > 0 and step % interval == 0:
            self.snapshot()
        dint = self.desync_interval
        if dint > 0 and step % dint == 0:
            self.check_desync()

    def _collective_deltas(self) -> dict:
        now = _collective_latency_totals()
        prev, self._coll_totals = self._coll_totals, now
        out = {}
        for op, (c, s) in now.items():
            pc, ps = prev.get(op, (0, 0.0))
            if c > pc:
                out[op] = {"calls": c - pc, "mean_s": (s - ps) / (c - pc)}
        return out

    def check_desync(self, escalate: bool = True):
        return self.detector.check(escalate=escalate)


_MISSING = object()


def _loss_float(loss):
    try:
        if loss is None:
            return None
        if isinstance(loss, torch.Tensor):
            return float(loss.detach().float().reshape(-1)[0].item())
        return float(np.asarray(loss).reshape(-1)[0])
    except Exception:
        return None


# ---------------------------------------------------------------------------
# compiled-state hook (static Executor)
# ---------------------------------------------------------------------------


def check_compiled_state(tensors, origin: str) -> None:
    """Post-run numerics check over the state a static run wrote back
    (updated parameters and optimizer accumulators). Detection only: the
    run already wrote its state, so an anomaly records into every flight
    recorder, dumps, and raises GuardianAnomaly; a caller holding a
    TrainingGuardian can then rollback() to its last snapshot. The
    ceiling is FLAGS_guardian_abs_ceiling (the hook cannot know which
    guardian owns the step)."""
    vals = [t for t in tensors if isinstance(t, torch.Tensor) and not t.is_meta]
    if _under_trace(vals):
        return  # a trace: nothing concrete to check
    mask, _ = check_arrays([], vals, float(_flags.get_flag("FLAGS_guardian_abs_ceiling")))
    if not mask:
        return
    from .. import telemetry as _tm

    kind = _anomaly_kind(mask)
    try:
        from ..profiler import perf_attribution as _pa

        _pa.sample_watermark(tag=f"anomaly:{kind}", force=True)
    except Exception:
        pass
    if _tm.enabled():
        _tm.counter(
            "paddle_tpu_guardian_anomalies_total",
            "numerical anomalies caught by the guardian", ("kind", "policy"),
        ).labels(kind=kind, policy=f"compiled:{origin}").inc()
    for rec in list(_recorders):
        rec.record_event("compiled_state_anomaly", anomaly=kind, origin=origin)
    paths = dump_flight_recorders(reason=f"compiled_state:{origin}")
    raise GuardianAnomaly(
        f"training guardian: {kind} in state written back by {origin} "
        f"(flight recorder: {paths})", kind=kind, dump_paths=paths,
    )


def _input_wait_delta():
    """Per-step input-pipeline wait (`input_wait_s`): how long this step's
    data took to arrive, from the streaming tier's stats accumulator
    (io/streaming/stats.py). None when no input pipeline has reported a
    wait (loader-less loops record nothing rather than a misleading 0.0).
    Consuming the delta here also closes one (wall, wait) sample of the
    starved-vs-slow window that perf_report()['input_pipeline'] judges."""
    try:
        from ..io.streaming import stats as _instats

        return _instats.take_step_wait()
    except Exception:
        return None
