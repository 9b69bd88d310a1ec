"""Deterministic fault-injection framework (counterpart of
paddle_tpu/distributed/resilience/fault_injection.py).

Chaos testing for the distributed runtime: a `FaultPlan` names injection
points (`store.connect`, `ckpt.write_shard`, `collective.all_reduce`, ...)
and attaches actions — fail the next N calls, delay them, or corrupt the
bytes they just wrote. Production code calls `fault_point(site, **ctx)` at
each instrumented site; with no plan installed that is a single module-level
bool check, so the hooks are free in real runs.

Sites may be globs (`fnmatch`), so one spec covers a whole family — the
serving fleet's are the heaviest users: `fleet.replica_step.<idx>` (kill or
stall one replica), `fleet.route` / `fleet.tier_route` (routing decisions,
monolithic and tiered), and `fleet.kv_migrate.<src>.<dst>` (the
prefill→decode KV-page handoff; `fail` aborts it mid-flight, `corrupt`
flips payload bytes that the readback CRC must then catch —
`fleet.kv_migrate.*` chaoses every pair).

Plans are seedable (corruption flips deterministic byte positions) and
env-activatable: `PADDLE_TPU_FAULT_PLAN` holds either a JSON list of specs
or the compact form `site=action[*times][:arg][;site=...]`, e.g.

    PADDLE_TPU_FAULT_PLAN='store.connect=fail*2;ckpt.write_shard=corrupt'
    PADDLE_TPU_FAULT_PLAN='[{"site":"store.set","action":"delay","times":3,"arg":0.05}]'

so a launched worker subprocess inherits the chaos schedule without code
changes. Every triggered injection increments
`paddle_tpu_faults_injected_total{site,action}` in the telemetry registry.
"""
from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class FaultInjected(RuntimeError):
    """Raised by a `fail` action at an injection point."""

    def __init__(self, site: str, remaining: int):
        super().__init__(f"injected fault at {site!r} ({remaining} more scheduled)")
        self.site = site
        self.remaining = remaining


class FaultAction:
    FAIL = "fail"        # raise FaultInjected
    DELAY = "delay"      # sleep arg seconds
    CORRUPT = "corrupt"  # flip bytes in the file the caller just wrote

    ALL = (FAIL, DELAY, CORRUPT)


@dataclass
class FaultSpec:
    """One scheduled fault: `site` may be a glob (`store.*`)."""

    site: str
    action: str = FaultAction.FAIL
    times: Optional[int] = 1  # None = every matching call
    arg: float = 0.0  # delay seconds / corrupt byte count (0 = default 8)
    fired: int = 0  # mutated under the owning plan's lock

    def exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times

    def matches(self, site: str) -> bool:
        return not self.exhausted() and (
            self.site == site or fnmatch.fnmatchcase(site, self.site)
        )


class FaultPlan:
    """An ordered set of FaultSpecs plus per-site trigger counters."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None, seed: int = 0):
        self.specs: List[FaultSpec] = list(specs or [])
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.triggered: Dict[str, int] = {}

    def add(self, site: str, action: str = FaultAction.FAIL, times: Optional[int] = 1,
            arg: float = 0.0) -> "FaultPlan":
        if action not in FaultAction.ALL:
            raise ValueError(f"unknown fault action {action!r}; one of {FaultAction.ALL}")
        self.specs.append(FaultSpec(site, action, times, arg))
        return self

    def _claim(self, site: str, actions) -> Optional[FaultSpec]:
        """First non-exhausted spec matching `site` (and action filter), with
        its fired counter bumped — the claim is atomic so concurrent callers
        of the same site split the N scheduled faults between them."""
        with self._lock:
            for spec in self.specs:
                if spec.action in actions and spec.matches(site):
                    spec.fired += 1
                    self.triggered[site] = self.triggered.get(site, 0) + 1
                    return spec
        return None

    def describe(self) -> str:
        parts = []
        for s in self.specs:
            times = "inf" if s.times is None else str(s.times)
            parts.append(f"{s.site}={s.action}*{times}(fired={s.fired})")
        return "; ".join(parts) or "<empty plan>"


def plan_from_spec(spec: str, seed: int = 0) -> FaultPlan:
    """Parse `PADDLE_TPU_FAULT_PLAN` (JSON list or compact string form)."""
    spec = spec.strip()
    plan = FaultPlan(seed=seed)
    if not spec:
        return plan
    if spec.startswith("["):
        for item in json.loads(spec):
            plan.add(
                item["site"],
                item.get("action", FaultAction.FAIL),
                item.get("times", 1),
                float(item.get("arg", 0.0)),
            )
        return plan
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, rhs = part.partition("=")
        rhs = rhs or FaultAction.FAIL
        times: Optional[int] = 1
        arg = 0.0
        if "*" in rhs:  # site=action*times[:arg]
            action, _, rest = rhs.partition("*")
            times_s, _, arg_s = rest.partition(":")
            times = None if times_s in ("inf", "forever", "") else int(times_s)
        else:  # site=action[:arg]
            action, _, arg_s = rhs.partition(":")
        if arg_s:
            arg = float(arg_s)
        plan.add(site.strip(), action.strip(), times, arg)
    return plan


# ---------------------------------------------------------------------------
# active-plan registry
# ---------------------------------------------------------------------------

_active: Optional[FaultPlan] = None
_env_checked = False
_install_lock = threading.Lock()


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or with None, clear) the process-wide plan; returns the
    previous one."""
    global _active, _env_checked
    with _install_lock:
        prev, _active = _active, plan
        _env_checked = True  # explicit install wins over the env var
    return prev


def clear_plan() -> None:
    install_plan(None)


def current_plan() -> Optional[FaultPlan]:
    global _active, _env_checked
    if not _env_checked:
        with _install_lock:
            if not _env_checked:
                env = os.environ.get("PADDLE_TPU_FAULT_PLAN")
                if env:
                    seed = int(os.environ.get("PADDLE_TPU_FAULT_SEED", "0"))
                    _active = plan_from_spec(env, seed=seed)
                _env_checked = True
    return _active


def _record(site: str, action: str, plan: Optional[FaultPlan] = None) -> None:
    from ... import telemetry as _tm
    from ...telemetry import timeline as _tl

    if _tm.enabled():
        _tm.counter(
            "paddle_tpu_faults_injected_total",
            "faults triggered by the active FaultPlan", ("site", "action"),
        ).labels(site=site, action=action).inc()
    # the chaos-coverage anchor: every claim lands on the incident timeline
    # with its concrete site + seed, and the gate demands a later observed
    # event with the SAME site label (timeline.chaos_coverage) — a fault no
    # handler surfaced is an observability regression, not silence
    _tl.emit("resilience", "fault.injected", severity="error",
             labels={"site": site, "action": action},
             seed=plan.seed if plan is not None else None)


def fault_point(site: str, **ctx) -> None:
    """Injection point for fail/delay actions. Near-zero-cost when no plan is
    active; otherwise claims the first matching spec and acts on it."""
    plan = current_plan()
    if plan is None:
        return
    spec = plan._claim(site, (FaultAction.FAIL, FaultAction.DELAY))
    if spec is None:
        return
    _record(site, spec.action, plan)
    if spec.action == FaultAction.DELAY:
        time.sleep(spec.arg or 0.01)
        return
    remaining = 0 if spec.times is None else max(0, spec.times - spec.fired)
    raise FaultInjected(site, remaining)


def corrupt_value(site: str) -> Optional[FaultSpec]:
    """Injection point for corrupt actions on IN-MEMORY values — the
    on-device analog of `corrupt_file`. Claims a matching CORRUPT spec and
    returns it (None when nothing is scheduled); the CALLER applies its own
    site-specific corruption, e.g. the training guardian NaN-poisons a
    gradient (`guardian.grad_nan`) or flips one bit in a simulated rank's
    optimizer bucket (`guardian.bucket_bitflip`). The returned spec's `arg`
    and `fired` fields let the caller derive deterministic corruption
    parameters (target rank, bit position) from the plan seed."""
    plan = current_plan()
    if plan is None:
        return None
    spec = plan._claim(site, (FaultAction.CORRUPT,))
    if spec is not None:
        _record(site, FaultAction.CORRUPT, plan)
    return spec


def corrupt_file(site: str, path: str) -> bool:
    """Injection point for corrupt actions: flip deterministic byte positions
    in the file at `path` (seeded by the plan), AFTER the caller recorded its
    checksum — exactly the torn-write / bit-rot shape integrity verification
    must catch. Returns True when a corruption was applied."""
    plan = current_plan()
    if plan is None:
        return False
    spec = plan._claim(site, (FaultAction.CORRUPT,))
    if spec is None:
        return False
    _record(site, FaultAction.CORRUPT, plan)
    size = os.path.getsize(path)
    if size == 0:
        return True
    nbytes = int(spec.arg) or 8
    rng = random.Random(f"{plan.seed}:{site}:{spec.fired}")
    with open(path, "r+b") as f:
        for _ in range(min(nbytes, size)):
            pos = rng.randrange(size)
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))
    return True
