"""Replica fleet: SLO-aware routing, replica failure survival, zero-
downtime weight hot-swap and disaggregated prefill/decode tiers
(counterpart of paddle_tpu/inference/fleet.py; pure host logic over N
InferenceEngine + ContinuousBatchingScheduler replicas, every decision the
JAX package's).

- **Routing** (`fleet.route` FaultPlan site): session affinity first
  (`Request.session` routes home while that replica is healthy), then the
  fleet-global prefix owner, else least expected drain time (queue depth
  weighted by the replica's EWMA step latency). With no healthy replica a
  request is HELD at the fleet, never dropped.
- **Replica health** (`fleet.replica_step.<idx>` sites): a fault or real
  exception in a replica's step opens its circuit one notch (healthy ->
  draining), `breaker_threshold` consecutive failures open it (-> down);
  a step over `heartbeat_deadline_s` counts the same. A down replica is
  EVACUATED: every request resets through the scheduler's preemption-
  resume path and is re-dispatched to a healthy replica.
- **Hot swap**: `request_swap(mapping)` drains one replica at a time, calls
  its engine's `load_weights` (which rebinds that engine's parameter set
  only) and re-admits it, so a half-finished rollout serves two weight
  versions side by side (`paddle_tpu_fleet_weights_version`). A checkpoint
  path raises the engine's NotImplementedError until distributed.checkpoint
  is ported.
- **Tiers** (`tiers=(...)`): intake routes to "prefill" replicas; once a
  request's first token is out its KV pages MIGRATE to a "decode" replica
  through the host (kv_cache.export_pages / convert_payload /
  import_pages, re-encoded for an int8 decode pool, CRC-verified per
  page, `fleet.kv_migrate.<src>.<dst>` sites). A fault or CRC mismatch
  falls back to recompute-on-resume. The degradation ladder: decode tier
  dead -> "monolithic", prefill tier dead -> "streamed_prefill", both
  alive again (`revive`) -> re-split one replica at a time.

The replicas step one after another on one thread: on one card, a wider
fleet interleaves host work, it does not add devices.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import telemetry
from ..telemetry import metrics as _metrics
from ..telemetry import request_trace as _rt
from ..telemetry import timeline as _tl
from ..distributed.resilience import fault_injection as _fi
from . import kv_cache as _kvc
from .kv_cache import PoolExhausted, prefix_chain_keys
from .qos import QoSPolicy
from .scheduler import (
    ContinuousBatchingScheduler,
    Request,
    _req_counter,
    percentiles,
)

__all__ = ["ReplicaFleet", "ReplicaStatus", "NoHealthyReplica", "fleet_replay"]

# fleet modes (the degradation ladder): disaggregated = both tiers alive,
# KV migrates prefill -> decode; monolithic = decode tier dead (or the
# fleet is untiered), intake tier serves both phases; streamed_prefill =
# prefill tier dead, decode replicas take intake and stream prompts
FLEET_MODES = ("disaggregated", "monolithic", "streamed_prefill")

# a request whose migration fell back this many times stops being retried
# and simply finishes on its prefill replica (per-request monolithic
# degradation beats a recompute livelock under a perma-faulted site)
_MIGRATE_FALLBACK_CAP = 2


class ReplicaStatus:
    HEALTHY = "healthy"
    DRAINING = "draining"
    DOWN = "down"

    ALL = (HEALTHY, DRAINING, DOWN)


class NoHealthyReplica(RuntimeError):
    """Every replica is down and work is outstanding — the fleet cannot
    make progress (the caller's cue to escalate/restart, not spin)."""


def _replicas_gauge(state: str, tier: str = "none"):
    return _metrics.gauge(
        "paddle_tpu_fleet_replicas",
        "fleet replicas by health state and tier (tier=none on an "
        "untiered fleet)",
        label_names=("state", "tier"),
    ).labels(state=state, tier=tier)


def _held_gauge(tier: str = "none"):
    return _metrics.gauge(
        "paddle_tpu_fleet_held_requests",
        "requests held at the fleet for want of a healthy replica, by the "
        "intake tier that would take them (tier=none on an untiered fleet)",
        label_names=("tier",),
    ).labels(tier=tier)


def _mode_gauge(mode: str):
    return _metrics.gauge(
        "paddle_tpu_fleet_mode",
        "1 on the fleet's current degradation-ladder rung, 0 elsewhere",
        label_names=("mode",),
    ).labels(mode=mode)


def _migration_counter(event: str):
    return _metrics.counter(
        "paddle_tpu_fleet_kv_migrations_total",
        "prefill->decode KV page migrations by outcome (completed = pages "
        "CRC-verified on the decode replica, fallback_fault / fallback_crc "
        "= recovered via recompute-on-resume, deferred = no decode "
        "capacity, left decoding on the prefill replica, failed = "
        "unexpected error — the zero-gate invariant)",
        label_names=("event",),
    ).labels(event=event)


def _queue_gauge(replica: int, state: str):
    return _metrics.gauge(
        "paddle_tpu_fleet_replica_queue",
        "per-replica scheduler occupancy",
        label_names=("replica", "state"),
    ).labels(replica=str(replica), state=state)


def _routed_counter(reason: str):
    return _metrics.counter(
        "paddle_tpu_fleet_routed_total",
        "routing decisions by reason (affinity = session home, "
        "prefix = fleet-global prefix-owner hit, "
        "least_loaded = SLO-aware pick, evacuated = re-dispatch off a dead "
        "replica, migrated = drained off a swapping replica, held = no "
        "healthy replica, queued at the fleet, requeued = held request "
        "flushed to a recovered replica, migration_fallback = KV handoff "
        "failed, recompute-on-resume re-dispatch)",
        label_names=("reason",),
    ).labels(reason=reason)


def _swap_counter(event: str):
    return _metrics.counter(
        "paddle_tpu_fleet_swaps_total",
        "weight hot-swap lifecycle events",
        label_names=("event",),
    ).labels(event=event)


def _failure_counter(replica: int, reason: str):
    return _metrics.counter(
        "paddle_tpu_fleet_replica_failures_total",
        "replica step failures feeding the circuit breaker, by cause "
        "(step = chaos fault or real exception, heartbeat = step wall "
        "time over the deadline)",
        label_names=("replica", "reason"),
    ).labels(replica=str(replica), reason=reason)


def _evac_counter():
    return _metrics.counter(
        "paddle_tpu_fleet_evacuated_requests_total",
        "in-flight/queued requests re-dispatched off a dead replica "
        "(recompute-from-prompt on the new home)",
    )


_STEP_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


def _step_hist(replica: int):
    return _metrics.histogram(
        "paddle_tpu_fleet_step_seconds",
        "per-replica scheduler step latency (the fleet-level tail the "
        "router's EWMA scoring tracks)",
        label_names=("replica",),
        buckets=_STEP_BUCKETS,
    ).labels(replica=str(replica))


def _drain_hist():
    return _metrics.histogram(
        "paddle_tpu_fleet_swap_drain_seconds",
        "per-replica drain+swap duration during a weight rollout (the "
        "blip window)",
        buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
    )


class _Replica:
    """One engine + scheduler behind the router, plus its health record."""

    def __init__(self, idx: int, engine, sched: ContinuousBatchingScheduler,
                 tier: Optional[str] = None):
        self.idx = idx
        self.engine = engine
        self.sched = sched
        self.tier = tier  # "prefill" | "decode" | None (untiered)
        self.status = ReplicaStatus.HEALTHY
        self.consecutive_failures = 0
        self.ewma_step_s = 0.0
        self.draining_for_swap = False

    def depth(self) -> int:
        return len(self.sched.waiting) + len(self.sched.running)

    def busy(self) -> bool:
        return bool(self.sched.waiting or self.sched.running)


class ReplicaFleet:
    """Serving front over N replicas; duck-types the scheduler surface
    (`submit` / `step` / `idle` / `finished`), so the single-replica replay
    and predictor plumbing drive a fleet unchanged."""

    def __init__(
        self,
        engines: Sequence,
        *,
        eos_id: Optional[int] = None,
        max_running: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        breaker_threshold: int = 2,
        heartbeat_deadline_s: Optional[float] = None,
        session_cache_size: int = 4096,
        prefix_cache: bool = True,
        spec_decode=None,
        qos: Optional[QoSPolicy] = None,
        tiers: Optional[Sequence[str]] = None,
        prefix_owner_cache_size: int = 8192,
    ):
        if not engines:
            raise ValueError("ReplicaFleet needs at least one engine")
        self.clock = clock
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.heartbeat_deadline_s = heartbeat_deadline_s
        self.session_cache_size = max(1, int(session_cache_size))
        # ONE QoSPolicy instance is shared by every replica's
        # scheduler — token buckets, fair-share debt, and the brownout
        # ladder are fleet-wide (a tenant can't dodge its quota by
        # spraying replicas), and the held queue below shares its bounds
        self.qos = qos
        self.spec = spec_decode
        # tiers split the fleet into disaggregated prefill and
        # decode pools. Page migration reshards pool pytrees across
        # replicas, so the KV geometry must agree fleet-wide
        if tiers is not None:
            tiers = tuple(tiers)
            if len(tiers) != len(engines):
                raise ValueError(
                    f"tiers has {len(tiers)} entries for {len(engines)} engines")
            bad = [t for t in tiers if t not in ("prefill", "decode")]
            if bad:
                raise ValueError(f"unknown tier(s) {bad}; 'prefill' or 'decode'")
            if "prefill" not in tiers or "decode" not in tiers:
                raise ValueError(
                    "a tiered fleet needs at least one prefill AND one "
                    "decode replica (run untiered otherwise)")
            geo = [
                (e.block_size, e.num_layers, e.num_kv_heads, e.head_dim,
                 e.max_seq_len)
                for e in engines
            ]
            if len(set(geo)) != 1:
                raise ValueError(
                    "tiered replicas must share KV geometry (block_size, "
                    f"layers, kv_heads, head_dim, max_seq_len); got {geo}")
        self._tiers = tiers
        # every replica's scheduler gets the prefix cache (on by
        # default — session affinity already routes a conversation to the
        # replica holding its warm pages, so hits compound) and, opt-in,
        # speculative decoding. Tiered: decode replicas admit "streamed"
        # only (tier degradation intake never runs a bucketed prefill)
        # and own the spec-decode path; prefill replicas draft nothing —
        # their decode steps are a short bridge until migration
        self.replicas: List[_Replica] = [
            _Replica(
                i,
                eng,
                ContinuousBatchingScheduler(
                    eng, eos_id=eos_id, max_running=max_running, clock=clock,
                    prefix_cache=prefix_cache,
                    spec_decode=(
                        spec_decode if tiers is None or tiers[i] == "decode"
                        else None
                    ),
                    qos=qos,
                    admission_mode=(
                        "streamed" if tiers is not None and tiers[i] == "decode"
                        else "auto"
                    ),
                ),
                tier=tiers[i] if tiers is not None else None,
            )
            for i, eng in enumerate(engines)
        ]
        self.finished: List[Request] = []
        self.submitted_total = 0
        self.evacuated_total = 0
        self.failures_total = 0
        self.swaps_completed = 0
        # [(start, end)] fleet-clock windows of completed rollouts — the
        # replay slices pooled inter-token intervals on these to report the
        # swap-blip p99
        self.swap_windows: List[tuple] = []
        self._pending: List[Request] = []  # held: no healthy replica yet
        self._held_shed = 0  # sheds off the held list (bounded _pending)
        # affinity is a performance hint, so the home map is a bounded LRU:
        # an unbounded dict would grow by one entry per session ever seen,
        # exactly the steady state a long-lived fleet serves
        self._session_home: "OrderedDict[object, int]" = OrderedDict()
        self._swap: Optional[dict] = None
        self._swap_t0: Optional[float] = None
        # fleet-global prefix routing — chain digest -> replica
        # idx holding that chain's pages warm (bounded LRU, like the
        # session-home map and for the same reason)
        self.prefix_owner_cache_size = max(1, int(prefix_owner_cache_size))
        self._prefix_owner: "OrderedDict[bytes, int]" = OrderedDict()
        self.prefix_routed_total = 0
        # migration accounting: completed handoffs, clean fallbacks
        # (recompute-on-resume), CRC rejections (a subset of fallbacks),
        # capacity deferrals, and FAILURES — migrations that neither
        # completed nor fell back cleanly. failures stays 0 by
        # construction
        self.migrations_total = 0
        self.migration_fallbacks = 0
        self.migration_crc_rejects = 0
        self.migration_deferred = 0
        self.migration_failures = 0
        self.migrated_pages_total = 0
        self.migration_wall_s = 0.0
        self._migrate_fallback_counts: Dict[int, int] = {}  # rid -> fallbacks
        # degradation ladder state: current mode + the one-replica-at-a-time
        # re-split queue a monolithic -> disaggregated recovery drains
        self._mode = "disaggregated" if tiers is not None else "monolithic"
        self._resplit: Optional[List[int]] = None
        if telemetry.enabled():
            self._sync_gauges()

    # ---- scheduler-surface aggregates ----
    @property
    def preempted_total(self) -> int:
        return sum(r.sched.preempted_total for r in self.replicas)

    @property
    def shed_total(self) -> int:
        return self._held_shed + sum(r.sched.shed_total for r in self.replicas)

    def idle(self) -> bool:
        # an in-progress swap keeps the fleet non-idle so replay loops
        # drive the drain -> swap -> re-admit machine to completion even
        # after the traffic tail finished
        return (
            not self._pending
            and self._swap is None
            and all(
                r.status == ReplicaStatus.DOWN or r.sched.idle()
                for r in self.replicas
            )
        )

    def healthy(self) -> List[_Replica]:
        return [r for r in self.replicas if r.status == ReplicaStatus.HEALTHY]

    # ---- tiers & the degradation ladder ----
    @property
    def tiered(self) -> bool:
        return self._tiers is not None

    def tier_replicas(self, tier: str) -> List[_Replica]:
        return [r for r in self.replicas if r.tier == tier]

    def tier_health(self) -> Dict[str, Dict[str, int]]:
        """Per-tier status counts ({} on an untiered fleet) — the
        operator's degraded-vs-down signal: a dead decode tier with a live
        prefill tier is mode()=="monolithic", not an outage."""
        out: Dict[str, Dict[str, int]] = {}
        if not self.tiered:
            return out
        for t in ("prefill", "decode"):
            counts = {s: 0 for s in ReplicaStatus.ALL}
            for r in self.tier_replicas(t):
                counts[r.status] += 1
            out[t] = counts
        return out

    def mode(self) -> str:
        """Current degradation-ladder rung (one of FLEET_MODES). An
        untiered fleet is always "monolithic"."""
        return self._mode

    def _tier_alive(self, tier: str) -> bool:
        # DRAINING counts as alive (half-open circuits recover; killing a
        # tier's mode over a transient would thrash the ladder)
        return any(
            r.status != ReplicaStatus.DOWN for r in self.tier_replicas(tier)
        )

    def _update_mode(self) -> None:
        """Recompute the ladder rung from per-tier health; a monolithic ->
        disaggregated recovery arms the one-replica-at-a-time re-split."""
        if not self.tiered:
            return
        prev = self._mode
        if self._tier_alive("decode"):
            new = ("disaggregated" if self._tier_alive("prefill")
                   else "streamed_prefill")
        else:
            # decode tier fully down (prefill too = every replica down —
            # step() raises; keep reporting monolithic meanwhile)
            new = "monolithic"
        if new == prev:
            return
        self._mode = new
        if self.qos is not None:
            # half the chips now run both phases: floor the brownout
            # pressure reading (qos.BrownoutConfig.degraded_pressure_floor,
            # default 0.0 = no effect) so shedding leans pessimistic
            # BEFORE the thinner fleet's queues back up
            self.qos.set_degraded(new != "disaggregated")
        if new == "disaggregated":
            # recovery: prefill replicas may hold a decode-phase backlog
            # accumulated while the fleet ran monolithic — drain it to the
            # decode tier ONE replica at a time (the swap-rollout
            # discipline: no thundering herd into the recovering tier)
            self._resplit = [
                r.idx for r in self.tier_replicas("prefill")
                if r.status != ReplicaStatus.DOWN
            ]
        else:
            self._resplit = None
        _rt.record_event("fleet", "mode", t=self.clock(), mode=new, was=prev)
        # a ladder move is an incident-grade transition either way:
        # degradation explains a tail, recovery closes the incident
        _tl.emit("fleet", "mode",
                 severity="warn" if new != "disaggregated" else "info",
                 mode=new, was=prev)
        if telemetry.enabled():
            for m in FLEET_MODES:
                _mode_gauge(m).set(1 if m == self._mode else 0)

    def revive(self, idx: int) -> None:
        """Operator surface: bring a DOWN replica back (its process/chips
        recovered). Health state resets and the local prefix index is
        defensively invalidated — the fleet may have hot-swapped weights
        while this replica was dark, and stale-chain K/V must never serve
        a post-revival prefix hit. Mode recomputes (possibly arming the
        re-split ladder)."""
        rep = self.replicas[idx]
        if rep.status != ReplicaStatus.DOWN:
            return
        rep.status = ReplicaStatus.HEALTHY
        rep.consecutive_failures = 0
        rep.engine.pool.invalidate_prefix()
        _rt.record_event("fleet", "replica_revived", t=self.clock(),
                         replica=idx)
        _tl.emit("fleet", "replica.revived", replica=idx)
        self._update_mode()
        if telemetry.enabled():
            self._sync_gauges()

    def _intake_tier(self) -> Optional[str]:
        """The tier new/re-dispatched requests route to under the current
        mode; None on an untiered fleet (every replica is intake)."""
        if not self.tiered:
            return None
        return "decode" if self._mode == "streamed_prefill" else "prefill"

    def _intake_replicas(self) -> List[_Replica]:
        tier = self._intake_tier()
        if tier is None:
            return self.healthy()
        return [r for r in self.healthy() if r.tier == tier]

    def prewarm(self) -> dict:
        """Run every replica's shape buckets once before traffic
        (InferenceEngine.prewarm). Returns per-replica step counts.

        Tiered: each tier warms ITS bucket family. Decode replicas skip
        the prefill buckets entirely (streamed admission never runs one)
        and add the (B, Q) extend family when speculative decoding is on;
        prefill replicas keep the decode family too — streamed admission,
        the pre-migration decode bridge, and monolithic degradation all
        ride the decode step."""
        out = {}
        for r in self.replicas:
            if not hasattr(r.engine, "prewarm"):
                continue
            if r.tier == "decode":
                extend_q = ((self.spec.draft_len + 1,)
                            if self.spec is not None else ())
                out[r.idx] = r.engine.prewarm(include_prefill=False,
                                              extend_q=extend_q)
            else:
                out[r.idx] = r.engine.prewarm()
        return out

    # ---- routing ----
    def _score(self, rep: _Replica) -> float:
        """Expected time for a new request to start making progress:
        occupancy weighted by the replica's recent step latency. A pure
        queue-depth router sends traffic to a degraded-but-short replica;
        weighting by the EWMA keeps the p99 honest."""
        return (rep.depth() + 1) * max(rep.ewma_step_s, 1e-6)

    def _route(self, req: Request, *, reason_override: Optional[str] = None) -> Optional[_Replica]:
        # the chaos site models CLIENT-facing routing failures (submit()
        # raises to the caller, who still owns the request); internal
        # re-dispatch of evacuated/migrated/held requests must never fault
        # here — the request exists only in a local list at that point, so
        # a raise would silently lose it and void the zero-loss invariant
        if reason_override is None:
            _fi.fault_point("fleet.route", rid=req.rid)
            if self.tiered:
                # tier selection is its own failure domain: a chaos raise
                # here models a router that can't resolve the intake tier
                # (e.g. mode flapping mid-decision), distinct from the
                # generic route fault above
                _fi.fault_point("fleet.tier_route", rid=req.rid,
                                mode=self._mode)
        eligible = self._intake_replicas()
        if not eligible:
            if telemetry.enabled():
                _routed_counter("held").inc()
            return None
        rep = None
        reason = reason_override or "least_loaded"
        if req.session is not None and reason_override is None:
            home = self._session_home.get(req.session)
            if home is not None:
                cand = self.replicas[home]
                if cand.status == ReplicaStatus.HEALTHY and cand in eligible:
                    rep = cand
                    reason = "affinity"
        if rep is None and reason_override is None:
            owner = self._prefix_owner_for(req, eligible)
            if owner is not None:
                rep = owner
                reason = "prefix"
                self.prefix_routed_total += 1
        if rep is None:
            rep = min(eligible, key=lambda r: (self._score(r), r.idx))
        if req.session is not None:
            self._session_home[req.session] = rep.idx
            self._session_home.move_to_end(req.session)
            while len(self._session_home) > self.session_cache_size:
                self._session_home.popitem(last=False)
        if _rt.enabled() and _rt.sampled(req.rid):
            # lands in the request's own chrome lane: WHY it went where it
            # went (affinity home vs SLO-scored pick vs evacuation target)
            _rt.record_event("request", "route", t=self.clock(), rid=req.rid,
                             replica=rep.idx, reason=reason)
        if telemetry.enabled():
            _routed_counter(reason).inc()
        return rep

    def submit(self, req: Request) -> None:
        # TTL-sweep the held list on EVERY submit, not only in step(): a
        # fully-down fleet raises NoHealthyReplica out of step(), after
        # which callers stop stepping — without this sweep, expired work
        # would sit in _pending forever and the outcome="expired" counter
        # contract would silently stop holding on a dead fleet
        self._expire_pending(self.clock())
        try:
            rep = self._route(req)  # a chaos raise leaves the request unstamped
        except _fi.FaultInjected as e:
            # the injected routing failure SURFACES before it propagates:
            # the site-labeled observation the chaos-coverage gate matches
            # against (the caller still owns the request and may retry)
            _tl.emit("fleet", "route.fault", severity="error",
                     labels={"site": e.site}, rid=req.rid, mode=self._mode)
            raise
        if rep is None:
            # held at the fleet: the TTL clock starts NOW — acceptance —
            # since no scheduler will stamp it until it routes
            if req.submitted_time is None:
                req.submitted_time = self.clock()
            if req.trace is None:
                req.trace = _rt.start(req.rid, req.submitted_time,
                                      prompt_len=req.prompt_len,
                                      max_new=req.max_new_tokens)
            if req.trace is not None and req.trace.phase_name is None:
                # held time is queue time with a cause: no healthy replica
                req.trace.phase("queue", self.clock(), cause="held")
            # the held line shares the QoS waiting bound: a dead fleet
            # must shed the lowest eligible class explicitly, not grow
            # an unbounded list nobody is draining
            if self.qos is not None and self.qos.queue_full(len(self._pending)):
                victim = self.qos.queue_full_victim(self._pending, req)
                if victim is not req:
                    self._pending.remove(victim)
                    self._pending.append(req)
                self.qos.note_shed("queue_full")
                self._held_shed += 1
                self._finish_held(victim, self.clock(), "shed",
                                  reason="queue_full")
            else:
                self._pending.append(req)
        else:
            # the scheduler stamps submitted_time itself AFTER its own
            # validation, so a reject leaves the request entirely
            # untouched (TTL clock included) with the caller
            rep.sched.submit(req)
        # counted only once the request is safely queued: a route chaos
        # raise or a validation reject leaves it with the caller, and
        # counting it would inflate the zero-loss `lost` accounting when
        # the caller retries
        self.submitted_total += 1

    def _finish_held(self, req: Request, now: float, outcome: str,
                     reason: str = "") -> None:
        """Terminal disposition of a request that never left the fleet's
        held list (no pages, no scheduler): same trace-close + counter
        contract every scheduler-side terminal path honors."""
        req.outcome = outcome
        if outcome == "shed":
            req.shed_reason = reason
        req.finish_time = now
        self.finished.append(req)
        if req.trace is not None:
            extra = {"reason": reason} if reason else {}
            req.trace.close(now, outcome, generated=0,
                            preemptions=req.preemptions, **extra)
        if telemetry.enabled():
            _req_counter().labels(event=outcome, reason=reason).inc()
        if outcome != "completed":
            _tl.emit("scheduler", "request.finish", severity="warn",
                     rid=req.rid, outcome=outcome, reason=reason, held=True)

    def _expire_pending(self, now: float) -> None:
        """TTL sweep over requests HELD at the fleet — a deadline must
        bind even while no replica can take the work (run from submit()
        as well as step(), so a dead fleet still expires its holds)."""
        for req in list(self._pending):
            if (
                req.deadline_s is not None
                and req.submitted_time is not None
                and now - req.submitted_time > req.deadline_s
            ):
                self._pending.remove(req)
                self._finish_held(req, now, "expired")

    def cancel(self, rid: int) -> bool:
        """Client cancellation, fleet-wide: whichever replica (or the held
        queue) owns `rid` drops it and frees its pages. The terminal record
        is harvested into fleet.finished IMMEDIATELY — idle() ignores the
        schedulers' finished lists, so waiting for the next step() would
        strand a cancel that empties the fleet."""
        for i, req in enumerate(self._pending):
            if req.rid == rid:
                self._pending.pop(i)
                self._finish_held(req, self.clock(), "cancelled")
                return True
        for rep in self.replicas:
            if rep.sched.cancel(rid):
                self.finished.extend(rep.sched.finished)
                rep.sched.finished = []
                return True
        return False

    def _redispatch(self, req: Request, reason: str) -> None:
        rep = self._route(req, reason_override=reason)
        if rep is None:
            self._pending.append(req)
            return
        try:
            rep.sched.submit(req)
        except Exception:
            # a replica that can't legally take this request (heterogeneous
            # engine limits) must neither crash the tick nor silently drop
            # the REST of the evacuation/held list — park it; the next tick
            # retries (possibly onto a different replica) and its TTL can
            # still expire it, so nothing is ever lost unaccounted
            self._pending.append(req)

    def _flush_pending(self) -> None:
        if not self._pending or not self.healthy():
            return
        held, self._pending = self._pending, []
        for req in held:
            # internal path (no chaos site, no re-count): a request that
            # still can't route lands back in _pending, never on the floor
            self._redispatch(req, reason="requeued")

    # ---- fleet-global prefix routing ----
    def _prefix_owner_for(self, req: Request,
                          eligible: List[_Replica]) -> Optional[_Replica]:
        """Longest-match walk of the fleet-global digest→owner map: route
        a prefix-sharing request to the replica already HOLDING the chain
        (its local retained index turns the hit into skipped prefill).
        Owners that died or fell out of the intake set are skipped — the
        map is a routing hint, never a correctness surface (the replica's
        own index still validates the chain on arrival)."""
        if not self._prefix_owner:
            return None
        bs = self.replicas[0].engine.block_size
        # only pages a server could actually have committed: the last
        # token is never pre-committed (see scheduler._kv_committed), so
        # a whole-prompt key can exist only via a harvested completion
        keys = prefix_chain_keys(req.prompt, bs)
        for key in reversed(keys):
            idx = self._prefix_owner.get(key)
            if idx is None:
                continue
            cand = self.replicas[idx]
            if cand.status == ReplicaStatus.HEALTHY and cand in eligible:
                self._prefix_owner.move_to_end(key)
                return cand
        return None

    def _record_prefix_owner(self, rep: _Replica, req: Request) -> None:
        """Publish `rep` as the owner of every chain digest the request
        registered locally (bounded LRU — eviction only loses a routing
        hint)."""
        reg = getattr(req, "_registered_pages", 0)
        if reg <= 0:
            return
        bs = rep.engine.block_size
        tokens = (list(req.prompt) + list(req.generated))[: reg * bs]
        for key in prefix_chain_keys(tokens, bs):
            self._prefix_owner[key] = rep.idx
            self._prefix_owner.move_to_end(key)
        while len(self._prefix_owner) > self.prefix_owner_cache_size:
            self._prefix_owner.popitem(last=False)

    def invalidate_prefix(self) -> int:
        """Fleet-wide hot-swap broadcast: drop the router's digest→owner
        map AND every live replica's local prefix index in one call —
        after a weight swap begins, no request may be routed toward (or
        served from) a chain computed under the old parameters. Returns
        total local entries dropped."""
        self._prefix_owner.clear()
        dropped = 0
        for rep in self.replicas:
            if rep.status != ReplicaStatus.DOWN:
                dropped += rep.engine.pool.invalidate_prefix()
        return dropped

    # ---- KV migration (prefill → decode handoff) ----
    def _advance_resplit(self) -> None:
        """Recovery re-split, one replica at a time: the head of the
        queue drains its decode-phase backlog to the decode tier first;
        only when it is clean does the next prefill replica start
        migrating (the rollout discipline applied to pages)."""
        if self._resplit is None:
            return
        while self._resplit:
            head = self.replicas[self._resplit[0]]
            if head.status != ReplicaStatus.DOWN and any(
                req.cursor >= len(req.prompt) and not req.done
                for req in head.sched.running
            ):
                return  # head still holds decode-phase work — keep draining it
            self._resplit.pop(0)
        self._resplit = None

    def _decode_target(self, n_pages: int) -> Optional[_Replica]:
        """Least-loaded HEALTHY decode replica with a free slot and room
        for the migrating pages; None defers the migration (the request
        keeps decoding on its prefill replica — correct, just not
        disaggregated)."""
        cands = [
            r for r in self.tier_replicas("decode")
            if r.status == ReplicaStatus.HEALTHY
            and not r.draining_for_swap
            and len(r.sched.running) < r.sched.max_running
            and r.engine.pool.available() >= n_pages
        ]
        if not cands:
            return None
        return min(cands, key=lambda r: (self._score(r), r.idx))

    def _migrate_ready(self) -> None:
        """Move every prefill-complete request from the prefill tier to a
        decode replica. Runs only on the disaggregated rung; during a
        re-split only the rollout head migrates (one replica at a time)."""
        if not self.tiered or self._mode != "disaggregated":
            return
        sources = [
            r for r in self.tier_replicas("prefill")
            if r.status != ReplicaStatus.DOWN
        ]
        if self._resplit is not None:
            sources = [r for r in sources if r.idx == self._resplit[0]]
        for src in sources:
            for req in list(src.sched.running):
                # prefill-complete means the CURRENT prompt (which folds
                # recomputed tokens after a resume) is fully consumed
                if req.done or req.cursor < len(req.prompt):
                    continue
                if (self._migrate_fallback_counts.get(req.rid, 0)
                        >= _MIGRATE_FALLBACK_CAP):
                    # perma-faulted site: stop burning recomputes — this
                    # request finishes monolithically on its prefill
                    # replica (per-request degradation, not fleet-wide)
                    continue
                dst = self._decode_target(len(req.pages))
                if dst is None:
                    self.migration_deferred += 1
                    if telemetry.enabled():
                        _migration_counter("deferred").inc()
                    continue
                try:
                    self._migrate_request(src, dst, req)
                except _fi.FaultInjected as e:
                    # e.site is the concrete injected site — the coverage
                    # gate's match key for the in-flight handoff abort
                    _tl.emit("fleet", "migrate.fallback", severity="warn",
                             labels={"site": e.site}, rid=req.rid,
                             src=src.idx, dst=dst.idx, why="fault")
                    self._migration_fallback(src, req, "fault")
                except ValueError:
                    # lossy-direction conversion (int8 source → f32
                    # decode): the pages cannot move losslessly, so the
                    # request recomputes on the decode side instead
                    self._migration_fallback(src, req, "lossy")
                except Exception as e:
                    # the invariant the chaos tests pin: an UNEXPECTED
                    # migration error still never loses the request —
                    # it is accounted as a failure (chaos runs hold this
                    # at zero) and recovered through the same fallback
                    self.migration_failures += 1
                    if telemetry.enabled():
                        _migration_counter("failed").inc()
                    _tl.emit(
                        "fleet", "migrate.failed", severity="error",
                        labels={
                            "site": f"fleet.kv_migrate.{src.idx}.{dst.idx}"
                        },
                        rid=req.rid, error=type(e).__name__)
                    self._migration_fallback(src, req, "error")

    def _migrate_request(self, src: _Replica, dst: _Replica,
                         req: Request) -> None:
        """The handoff itself: export the request's pages from the source
        pool, convert to the destination's KV dtype (f32→int8 quantizes
        with the EXACT quantize-on-write math, so migrated pages are
        byte-identical to locally-written ones), CRC every page, import
        into freshly allocated destination pages, read back and re-verify
        — only then does ownership commit. Any fault/CRC mismatch before
        commit leaves the source untouched and falls back to
        recompute-on-resume; a torn page can never serve attention."""
        t0 = self.clock()
        site = f"fleet.kv_migrate.{src.idx}.{dst.idx}"
        _fi.fault_point(site, rid=req.rid, pages=len(req.pages))
        payload = _kvc.export_pages(src.engine.pool, req.pages)
        payload = _kvc.convert_payload(payload, dst.engine.pool.kv_dtype)
        crcs = _kvc.payload_page_crcs(payload)
        spec = _fi.corrupt_value(site)
        if spec is not None:
            # deterministic torn-transfer: flip one byte in flight; the
            # readback CRC below MUST catch it (the test pins that)
            _kvc.corrupt_payload(payload, seed=f"{spec.arg}:{spec.fired}")
        try:
            new_pages = dst.engine.pool.alloc(len(req.pages))
        except PoolExhausted:
            self.migration_deferred += 1
            if telemetry.enabled():
                _migration_counter("deferred").inc()
            return
        _kvc.import_pages(dst.engine.pool, new_pages, payload)
        readback = _kvc.export_pages(dst.engine.pool, new_pages)
        if _kvc.payload_page_crcs(readback) != crcs:
            dst.engine.pool.free(new_pages, retain=False)
            self.migration_crc_rejects += 1
            if telemetry.enabled():
                _migration_counter("fallback_crc").inc()
            _tl.emit("fleet", "migrate.crc_reject", severity="error",
                     labels={"site": site}, rid=req.rid, src=src.idx,
                     dst=dst.idx, pages=len(req.pages))
            self._migration_fallback(src, req, "crc")
            return
        # ---- commit: single ownership transfer, no partial state ----
        src.sched.running.remove(req)
        # the source RETAINS its copy under the prefix index: the chain
        # stays shareable for future prefix-routed intake on this replica
        # (dropping it would make every migration a fleet-wide cache miss)
        src.engine.pool.free(req.pages, retain=True)
        self._record_prefix_owner(src, req)
        req.pages = new_pages
        # destination registers its own chain incrementally from scratch
        req._registered_pages = 0
        req._chain_digest = b""
        dst.sched.adopt_running(req)
        self.migrations_total += 1
        self.migrated_pages_total += len(new_pages)
        self.migration_wall_s += self.clock() - t0
        if telemetry.enabled():
            _migration_counter("completed").inc()
            src.sched._sync_gauges()
        _tl.emit("fleet", "migrate.completed", labels={"site": site},
                 rid=req.rid, src=src.idx, dst=dst.idx, pages=len(new_pages))
        if _rt.enabled() and _rt.sampled(req.rid):
            _rt.record_event("request", "kv_migrate", t=self.clock(),
                             rid=req.rid, src=src.idx, dst=dst.idx,
                             pages=len(new_pages))

    def _migration_fallback(self, src: _Replica, req: Request,
                            why: str) -> None:
        """Recompute-on-resume: the migration never committed, so the
        request is still wholly owned by the source — strip its pages
        (retain=False: a possibly-torn chain must NOT enter the prefix
        index) and push it back through the normal re-dispatch path as a
        fresh prefill. Identical to pool-pressure preemption, which is
        what makes it byte-safe: decode restarts from the full recomputed
        context, so output ids cannot diverge."""
        if req in src.sched.running:
            src.sched.running.remove(req)
        if req.pages:
            src.engine.pool.free(req.pages, retain=False)
            req.pages = []
        src.sched._reset_for_resume(req)
        req.preemptions += 1
        self.migration_fallbacks += 1
        self._migrate_fallback_counts[req.rid] = (
            self._migrate_fallback_counts.get(req.rid, 0) + 1
        )
        if telemetry.enabled():
            if why != "crc":  # crc path already counted its own event
                _migration_counter("fallback_fault").inc()
            src.sched._sync_gauges()
        if req.trace is not None:
            req.trace.phase("preempt", self.clock(),
                            cause="migration_" + why)
        self._redispatch(req, reason="migration_fallback")

    # ---- health ----
    def _note_failure(self, rep: _Replica, reason: str) -> None:
        rep.consecutive_failures += 1
        self.failures_total += 1
        if telemetry.enabled():
            _failure_counter(rep.idx, reason).inc()
        # site matches the step chaos point, so an injected replica kill is
        # causally tied to the failure it produced (coverage match key)
        _tl.emit("fleet", "replica.failure", severity="error",
                 labels={"site": f"fleet.replica_step.{rep.idx}"},
                 replica=rep.idx, reason=reason,
                 consecutive=rep.consecutive_failures)
        if rep.consecutive_failures >= self.breaker_threshold:
            self._kill(rep)
        elif rep.status == ReplicaStatus.HEALTHY:
            # circuit half-open: stop admissions, keep stepping in-flight
            # work — one good step closes it again
            rep.status = ReplicaStatus.DRAINING

    def _kill(self, rep: _Replica) -> None:
        rep.status = ReplicaStatus.DOWN
        rep.draining_for_swap = False
        _rt.record_event("fleet", "replica_down", t=self.clock(),
                         replica=rep.idx,
                         failures=rep.consecutive_failures)
        _tl.emit("fleet", "replica.down", severity="error",
                 labels={"site": f"fleet.replica_step.{rep.idx}"},
                 replica=rep.idx, tier=rep.tier,
                 failures=rep.consecutive_failures)
        # break session affinity: homes on a dead replica re-route freely
        for s, idx in list(self._session_home.items()):
            if idx == rep.idx:
                del self._session_home[s]
        # prefix-ownership failover: a dead replica's chains are
        # unreachable — drop its entries so prefix-sharing intake stops
        # routing toward pages nobody can serve (survivors re-earn
        # ownership as they commit the chains themselves)
        for key, idx in list(self._prefix_owner.items()):
            if idx == rep.idx:
                del self._prefix_owner[key]
        # the ladder moves BEFORE evacuation re-dispatch: if this kill
        # took the last replica of a tier, the evacuated requests must
        # route under the NEW intake tier, not the one that just died
        self._update_mode()
        evacuated = rep.sched.evacuate()
        self.evacuated_total += len(evacuated)
        if telemetry.enabled() and evacuated:
            _evac_counter().inc(len(evacuated))
        if evacuated:
            _tl.emit("fleet", "evacuation", severity="warn",
                     replica=rep.idx, requests=len(evacuated))
        for req in evacuated:
            self._redispatch(req, reason="evacuated")
        # a dead replica can't finish its drain — hand the swap machine on
        sw = self._swap
        if sw is not None:
            if sw.get("active") == rep.idx:
                sw["active"] = None
            if rep.idx in sw["queue"]:
                sw["queue"].remove(rep.idx)

    # ---- weight hot-swap ----
    def request_swap(self, source, state_key: Optional[str] = "model") -> None:
        """Begin a zero-downtime rollout: every live replica, one at a
        time, is drained and re-weighted from `source`, a name->tensor
        mapping (applied via `load_weights`; a checkpoint path goes to
        `load_weights_from_checkpoint`, which raises until
        distributed.checkpoint is ported). Progress happens inside step();
        the fleet stays serving throughout."""
        if self._swap is not None:
            raise RuntimeError("a weight swap is already in progress")
        # fleet-wide invalidation broadcast FIRST: from this instant no
        # request may be prefix-routed toward a chain that will be
        # recomputed under new weights mid-rollout
        self.invalidate_prefix()
        self._swap = {
            "source": source,
            "state_key": state_key,
            "queue": [r.idx for r in self.replicas if r.status != ReplicaStatus.DOWN],
            "active": None,
            "t_active": None,
            "swapped": 0,
        }
        self._swap_t0 = self.clock()
        if telemetry.enabled():
            _swap_counter("requested").inc()
        # the rollout starts NOW, not at the next tick: the first target
        # drains (and, if already idle, swaps) synchronously so no request
        # routed after this call lands on about-to-be-swapped weights
        self._advance_swap(self.clock())

    def swap_in_progress(self) -> bool:
        return self._swap is not None

    def _perform_swap(self, rep: _Replica) -> None:
        src = self._swap["source"]
        if isinstance(src, str):
            rep.engine.load_weights_from_checkpoint(
                src, state_key=self._swap["state_key"]
            )
        else:
            rep.engine.load_weights(src)
        if telemetry.enabled():
            _metrics.gauge(
                "paddle_tpu_fleet_weights_version",
                "engine weights_version per replica (a half-finished "
                "rollout is visible as a version split)",
                label_names=("replica",),
            ).labels(replica=str(rep.idx)).set(rep.engine.weights_version)

    def _advance_swap(self, now: float) -> None:
        sw = self._swap
        if sw is None:
            return
        if sw["active"] is None:
            while sw["queue"]:
                idx = sw["queue"].pop(0)
                rep = self.replicas[idx]
                if rep.status == ReplicaStatus.DOWN:
                    continue
                rep.status = ReplicaStatus.DRAINING
                rep.draining_for_swap = True
                rep.sched.drain()
                # its waiting queue holds no pages — migrate it now so
                # those requests don't wait out the drain
                waiting, rep.sched.waiting = list(rep.sched.waiting), []
                for req in waiting:
                    self._redispatch(req, reason="migrated")
                sw["active"] = idx
                sw["t_active"] = now
                if telemetry.enabled():
                    _swap_counter("drain_started").inc()
                return
            # queue empty, nothing active: the rollout is over — but it
            # only COUNTS as completed if at least one replica was actually
            # re-weighted (every target dying mid-rollout must not report
            # a successful swap, nor record a blip window over nothing)
            self._swap = None
            if sw["swapped"]:
                self.swap_windows.append((self._swap_t0, now))
                self.swaps_completed += 1
                _rt.record_span("fleet", "swap_rollout", self._swap_t0, now,
                                swapped=sw["swapped"])
                _tl.emit("fleet", "swap.completed", swapped=sw["swapped"])
                if telemetry.enabled():
                    _swap_counter("completed").inc()
            else:
                _tl.emit("fleet", "swap.aborted", severity="warn")
                if telemetry.enabled():
                    _swap_counter("aborted").inc()
            return
        rep = self.replicas[sw["active"]]
        # keep the drain target's waiting queue empty EVERY tick, not just
        # at drain start: pool-pressure preemption during the drain
        # re-queues its victim LOCALLY, where blocked admission would
        # otherwise deadlock the swap (waiting never empties)
        if rep.sched.waiting:
            waiting, rep.sched.waiting = list(rep.sched.waiting), []
            for req in waiting:
                self._redispatch(req, reason="migrated")
        if not rep.sched.running and not rep.sched.waiting:
            try:
                self._perform_swap(rep)
            except Exception:
                # a failed load must not wedge the fleet: abort the rollout
                # cleanly — the target resumes serving its OLD weights (an
                # earlier-swapped replica keeps the new ones: the version
                # split is visible in the weights_version gauge) — and the
                # error surfaces to the operator
                rep.sched.resume_admission()
                rep.status = ReplicaStatus.HEALTHY
                rep.draining_for_swap = False
                self._swap = None
                _tl.emit("fleet", "swap.failed", severity="error",
                         replica=rep.idx)
                if telemetry.enabled():
                    _swap_counter("failed").inc()
                raise
            sw["swapped"] += 1
            rep.sched.resume_admission()
            rep.status = ReplicaStatus.HEALTHY
            rep.draining_for_swap = False
            rep.consecutive_failures = 0
            # the per-replica drain window: requests whose queue/preempt
            # time overlaps these spans get it attributed as swap_overlap
            _rt.record_span("fleet", "swap_drain", sw["t_active"], now,
                            replica=rep.idx)
            if telemetry.enabled():
                _swap_counter("replica_swapped").inc()
                _drain_hist().observe(max(0.0, now - sw["t_active"]))
            sw["active"] = None
            # pick the next target immediately: a one-replica fleet must
            # finish its swap on THIS step, not leak an extra idle tick
            self._advance_swap(now)

    # ---- the fleet tick ----
    def step(self) -> int:
        """One fleet tick: advance any rollout, flush held requests, step
        every live replica through its chaos site, harvest finished work.
        Returns tokens produced across the fleet."""
        now = self.clock()
        self._advance_swap(now)
        self._expire_pending(now)
        self._flush_pending()
        # fatal only when every replica is fully DOWN: a merely-DRAINING
        # (half-open) replica is alive and one good step re-opens it, so
        # raising there would crash a fleet mid-recovery
        if self._pending and all(
            r.status == ReplicaStatus.DOWN for r in self.replicas
        ):
            detail = ""
            if self.tiered:
                detail = " " + " ".join(
                    f"[{t}: " + " ".join(
                        f"{s}={n}" for s, n in counts.items() if n
                    ) + "]"
                    for t, counts in self.tier_health().items()
                )
            _tl.emit("fleet", "no_healthy_replica", severity="fatal",
                     held=len(self._pending))
            raise NoHealthyReplica(
                f"{len(self._pending)} request(s) held with every replica "
                f"down{detail}"
            )
        produced = 0
        for rep in self.replicas:
            if rep.status == ReplicaStatus.DOWN:
                continue
            if not rep.busy():
                # a half-open circuit with NOTHING in flight has no step
                # left to prove itself on — close it here, or the replica
                # is skipped forever (no traffic routes to a non-healthy
                # replica, so it would never become busy again)
                if rep.status == ReplicaStatus.DRAINING and not rep.draining_for_swap:
                    rep.consecutive_failures = 0
                    rep.status = ReplicaStatus.HEALTHY
                continue
            try:
                # the delay fault sleeps INSIDE this point — measuring from
                # before it is what lets a delay spec trip the heartbeat
                # breaker (a hung/slow step, not an exception)
                t0 = self.clock()
                _fi.fault_point(f"fleet.replica_step.{rep.idx}", replica=rep.idx)
                produced += rep.sched.step()
                dt = self.clock() - t0
            except Exception:
                self._note_failure(rep, reason="step")
                continue
            rep.ewma_step_s = (
                dt if rep.ewma_step_s == 0.0 else 0.8 * rep.ewma_step_s + 0.2 * dt
            )
            if telemetry.enabled():
                _step_hist(rep.idx).observe(dt)
            # heartbeat = the replica's OWN step wall time: charging a
            # shared tick clock would blame a stalled peer's 10 s on every
            # healthy replica stepped after it. A deadline miss is a breaker
            # failure even though the step "succeeded"; set the deadline
            # above the worst-case first step.
            if (
                self.heartbeat_deadline_s is not None
                and dt > self.heartbeat_deadline_s
            ):
                self._note_failure(rep, reason="heartbeat")
                continue
            rep.consecutive_failures = 0
            if rep.status == ReplicaStatus.DRAINING and not rep.draining_for_swap:
                rep.status = ReplicaStatus.HEALTHY  # circuit closes
        # the handoff runs AFTER the tier stepped (a request finishes its
        # prefill inside this very tick) and BEFORE harvest, so a
        # one-token request still migrates before its terminal record
        self._advance_resplit()
        self._migrate_ready()
        for rep in self.replicas:
            if rep.sched.finished:
                for req in rep.sched.finished:
                    self._migrate_fallback_counts.pop(req.rid, None)
                    # completion publishes chain ownership fleet-wide:
                    # only intake-eligible replicas can SERVE a prefix
                    # hit, so only they earn map entries
                    if rep in self._intake_replicas():
                        self._record_prefix_owner(rep, req)
                self.finished.extend(rep.sched.finished)
                rep.sched.finished = []
        if telemetry.enabled():
            self._sync_gauges()
        return produced

    def _sync_gauges(self) -> None:
        for rep in self.replicas:
            _queue_gauge(rep.idx, "running").set(len(rep.sched.running))
            _queue_gauge(rep.idx, "waiting").set(len(rep.sched.waiting))
        if self.tiered:
            # per-tier breakdown: a dead decode tier with a live prefill
            # tier must read as DEGRADED (mode gauge: monolithic), never
            # as a fleet-wide outage
            for t in ("prefill", "decode"):
                counts = {s: 0 for s in ReplicaStatus.ALL}
                for rep in self.tier_replicas(t):
                    counts[rep.status] += 1
                for s, n in counts.items():
                    _replicas_gauge(s, t).set(n)
            for m in FLEET_MODES:
                _mode_gauge(m).set(1 if m == self._mode else 0)
        else:
            counts = {s: 0 for s in ReplicaStatus.ALL}
            for rep in self.replicas:
                counts[rep.status] += 1
            for s, n in counts.items():
                _replicas_gauge(s).set(n)
        _held_gauge(self._intake_tier() or "none").set(len(self._pending))

    # ---- convenience: batch greedy generation through the fleet ----
    def generate(self, prompts, max_new_tokens=16) -> List[List[int]]:
        """Greedy-decode every prompt across the fleet; returns generated
        ids per prompt (full output even across preemption/evacuation)."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        reqs = [
            Request(rid=i, prompt=list(p), max_new_tokens=int(m))
            for i, (p, m) in enumerate(zip(prompts, max_new_tokens))
        ]
        for r in reqs:
            self.submit(r)
        while not self.idle():
            self.step()
        # this call's requests are read back directly — drop them from the
        # harvest list, or a long-lived fleet-backed predictor accumulates
        # every request (prompt + tokens) it ever served
        own = {id(r) for r in reqs}
        self.finished = [r for r in self.finished if id(r) not in own]
        self.submitted_total -= len(reqs)
        return [r.prompt[r.prompt_len:] + list(r.generated) for r in reqs]


def fleet_replay(
    fleet: ReplicaFleet,
    requests: Sequence[Request],
    *,
    events: Sequence[tuple] = (),
    clock: Optional[Callable[[], float]] = None,
    max_wall_s: float = 600.0,
) -> Dict:
    """scheduler.replay with mid-run chaos hooks: feed `requests` honoring
    their arrival_time offsets, and fire each `(completed_threshold, fn)`
    event once when that many requests have finished — the deterministic
    trigger chaos runs use to start a weight swap or install a
    replica-kill FaultPlan mid-traffic. Returns the replay stats plus
    fleet accounting (lost/duplicated counts, swap-window p99).

    `clock` defaults to the FLEET's clock: the replay's t0/arrival pacing,
    the schedulers' token timestamps, and the swap windows must share one
    time base or every latency stat is cross-clock garbage."""
    clock = clock or fleet.clock
    pending = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
    fired = [False] * len(events)

    def fire_due():
        for j, (threshold, fn) in enumerate(events):
            if not fired[j] and len(fleet.finished) >= threshold:
                fired[j] = True
                fn()

    t0 = clock()
    rt0 = time.monotonic()
    i = 0
    while i < len(pending) or not fleet.idle():
        now = clock() - t0
        # the watchdog runs on REAL wall time: a frozen/manual fleet clock
        # would otherwise turn the idle-wait into an unbreakable busy-loop
        if time.monotonic() - rt0 > max_wall_s:
            raise TimeoutError(f"fleet replay exceeded {max_wall_s}s wall budget")
        while i < len(pending) and pending[i].arrival_time <= now:
            fleet.submit(pending[i])
            i += 1
        fire_due()
        if fleet.idle():
            if i < len(pending):
                time.sleep(min(0.001, max(0.0, pending[i].arrival_time - now)))
            continue
        fleet.step()
        # re-check AFTER the step too: a threshold first reached by the
        # final (fleet-emptying) step must still fire — and if the fired
        # event starts a swap, idle() goes false and the loop drives it
        fire_due()
    wall = clock() - t0

    done = list(fleet.finished)
    rids = [r.rid for r in done]
    completed = [r for r in done if r.outcome == "completed"]
    ttfts = [
        r.first_token_time - (t0 + r.arrival_time)
        for r in completed
        if r.first_token_time is not None
    ]
    itls = [(iv, t) for r in completed
            for iv, t in zip(np.diff(r.token_times), r.token_times[1:])]
    swap_itls = [
        iv
        for iv, t in itls
        for (ws, we) in fleet.swap_windows
        if ws <= t <= we
    ]
    total_tokens = sum(
        (len(r.prompt) - r.prompt_len) + len(r.generated) for r in completed
    )
    out = {
        "n_requests": len(done),
        "completed": len(completed),
        "lost": fleet.submitted_total - len(set(rids)),
        "duplicated": len(rids) - len(set(rids)),
        "generated_tokens": int(total_tokens),
        "wall_s": round(wall, 4),
        "tokens_per_sec": round(total_tokens / wall, 2) if wall > 0 else None,
        "preempted": fleet.preempted_total,
        "evacuated": fleet.evacuated_total,
        "replica_failures": fleet.failures_total,
        "swaps_completed": fleet.swaps_completed,
        # disaggregation accounting (all zero on an untiered fleet)
        "migrations": fleet.migrations_total,
        "migration_fallbacks": fleet.migration_fallbacks,
        "migration_failures": fleet.migration_failures,
        "migration_deferred": fleet.migration_deferred,
        "crc_rejects": fleet.migration_crc_rejects,
        "prefix_routed": fleet.prefix_routed_total,
    }
    out.update(percentiles("ttft_ms", [t * 1000 for t in ttfts]))
    out.update(percentiles("tpot_ms", [iv * 1000 for iv, _ in itls]))
    out.update(percentiles("tpot_swap_ms", [iv * 1000 for iv in swap_itls]))
    return out
