"""Multi-tenant QoS & overload protection for the serving tier
(counterpart of paddle_tpu/inference/qos.py; pure host logic).

The scheduler/fleet admit whatever fits; this module decides WHAT should
fit when offered load exceeds capacity. Three mechanisms, all reversible:

- **Per-tenant token buckets + weighted-fair dequeue.** Every request
  carries a ``tenant`` and an integer ``priority`` (0 = highest class).
  A tenant's bucket refills at ``rate_tokens_per_s`` (token debt = prompt
  + generation budget, the work a request actually costs the pool); an
  empty bucket sheds the request with a ``retry_after_s`` hint instead of
  letting one tenant queue out everyone else. Dequeue order is strict
  priority, then deficit-round-robin over normalized token debt: the
  tenant that has consumed the least service per unit weight goes next,
  and a tenant idle for a while re-enters at the current debt floor so
  idle time never banks burst credit.

- **Bounded queues with explicit backpressure.** The waiting line takes a
  size bound (overflow sheds the lowest eligible class — the new request
  only wins a slot by strictly outranking a queued victim), a queue-wait
  bound, and deadline-aware admission: a request whose TTL is provably
  unreachable at the measured per-step latency (EWMA, the same estimate
  the fleet router drains by) is shed at submit, when retrying elsewhere
  is still cheap. Every shed is a counted, terminal, retryable outcome
  (``outcome="shed"``), never silent queue growth.

- **A reversible brownout ladder.** Driven by measured pressure (pool
  occupancy, queue depth, and externally-fed SLO burn), the ladder
  degrades chosen work one rung at a time and un-winds the same way:

  ====  ==================  ==============================================
  step  name                effect
  ====  ==================  ==============================================
  0     normal              nothing degraded
  1     spec_off            speculative decoding disabled (greedy verify
                            emits the same bytes, so outputs are
                            IDENTICAL — only the step count changes)
  2     max_new_capped      low-priority admissions get their generation
                            budget capped (an exact PREFIX of the
                            uncapped greedy chain)
  3     shed_low            new lowest-class submissions are shed
  ====  ==================  ==============================================

  Escalation is immediate (one rung per pressure reading at/above the
  enter threshold); recovery requires the pressure to sit at/below the
  exit threshold AND a cooldown to pass (hysteresis — a ladder that
  flaps between rungs every tick degrades everyone a little instead of
  someone predictably). Each transition is telemetry-counted and
  trace-annotated in the ``qos`` lane.

One ``QoSPolicy`` instance is shared across a fleet's replicas: buckets
and DRR debt are fleet-wide (a tenant cannot dodge its quota by spraying
replicas), and the brownout ladder is global — the hottest replica's
pressure escalates it, recovery waits for the cooldown.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "TenantConfig",
    "BrownoutConfig",
    "QoSConfig",
    "TokenBucket",
    "BrownoutController",
    "QoSPolicy",
    "jain_fairness",
    "tenant_report",
]

# shed reasons — the `reason` label values on
# paddle_tpu_serving_requests_total{event="shed"} (plus the two submit
# validation rejections, which count event="rejected")
SHED_REASONS = (
    "rate_limit",        # tenant token bucket empty
    "queue_full",        # waiting line at its size bound
    "queue_wait",        # sat queued past max_queue_wait_s
    "deadline_unmeetable",  # TTL provably unreachable at measured drain
    "brownout",          # ladder step 3: lowest class refused
)
REJECT_REASONS = ("context_overflow", "pool_capacity")

BROWNOUT_STEPS = ("normal", "spec_off", "max_new_capped", "shed_low")


@dataclass
class TenantConfig:
    """One tenant's share and quota. ``weight`` scales the fair-share
    dequeue (2.0 drains twice the token debt of 1.0 under contention);
    ``rate_tokens_per_s`` bounds sustained admission in token-debt units
    (prompt + max_new per request), ``burst_tokens`` the bucket depth
    (default: one second of rate, floored at one max-size request's
    worth is the caller's job to choose)."""

    weight: float = 1.0
    rate_tokens_per_s: Optional[float] = None
    burst_tokens: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("TenantConfig.weight must be > 0")
        if self.rate_tokens_per_s is not None and self.rate_tokens_per_s <= 0:
            raise ValueError("TenantConfig.rate_tokens_per_s must be > 0")


@dataclass
class BrownoutConfig:
    """Ladder thresholds. Hysteresis: ``enter_pressure`` must exceed
    ``exit_pressure`` or the ladder would flap on a flat signal."""

    enter_pressure: float = 0.85
    exit_pressure: float = 0.60
    cooldown_s: float = 0.5
    # step 2: generation budget cap applied to low-priority admissions
    capped_max_new: int = 8
    # priority >= this is the "low class" steps 2/3 act on
    low_priority: int = 2
    # pressure FLOOR applied while the fleet reports itself degraded (a
    # tiered fleet off its disaggregated rung is running double duty on
    # half the chips — the ladder should lean pessimistic before queues
    # actually back up). 0.0 = off (default: degradation alone never
    # escalates the ladder).
    degraded_pressure_floor: float = 0.0

    def __post_init__(self):
        if not (0.0 < self.exit_pressure < self.enter_pressure <= 1.0):
            raise ValueError(
                "BrownoutConfig requires 0 < exit_pressure < enter_pressure <= 1"
            )
        if self.capped_max_new < 1:
            raise ValueError("BrownoutConfig.capped_max_new must be >= 1")
        if not (0.0 <= self.degraded_pressure_floor <= 1.0):
            raise ValueError(
                "BrownoutConfig.degraded_pressure_floor must be in [0, 1]"
            )


@dataclass
class QoSConfig:
    """Policy knobs. Everything defaults OFF (unbounded, unlimited) so a
    scheduler constructed without explicit QoS behaves exactly as before."""

    tenants: Dict[str, TenantConfig] = field(default_factory=dict)
    default_tenant: TenantConfig = field(default_factory=TenantConfig)
    # waiting-line size bound (per scheduler) and held-line bound (fleet)
    max_waiting: Optional[int] = None
    max_queue_wait_s: Optional[float] = None
    # shed at submit when the TTL is provably unreachable at the measured
    # per-step latency
    deadline_shed: bool = True
    brownout: BrownoutConfig = field(default_factory=BrownoutConfig)

    def tenant(self, name: str) -> TenantConfig:
        return self.tenants.get(name, self.default_tenant)


class TokenBucket:
    """Deterministic token bucket (caller supplies ``now``; shares the
    scheduler's injectable clock so admission is replay-testable)."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t = float(now)

    def refill(self, now: float) -> None:
        if now > self._t:
            self.tokens = min(self.burst, self.tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: float, now: float) -> bool:
        self.refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: float) -> float:
        """Seconds until `n` tokens will be available (0 when they are)."""
        deficit = min(n, self.burst) - self.tokens
        return max(0.0, deficit / self.rate)


class BrownoutController:
    """The ladder state machine. ``update()`` moves at most one rung per
    pressure reading; escalation is immediate, recovery waits out the
    cooldown below the exit threshold (hysteresis)."""

    def __init__(self, cfg: Optional[BrownoutConfig] = None):
        self.cfg = cfg or BrownoutConfig()
        self.step = 0
        self.transitions = 0
        self._last_change: Optional[float] = None

    @property
    def step_name(self) -> str:
        return BROWNOUT_STEPS[self.step]

    def update(self, pressure: float, now: float) -> List[Tuple[str, int]]:
        """Returns the transition taken (at most one) as
        ``[(direction, new_step)]`` — empty when the rung holds."""
        cfg = self.cfg
        if pressure >= cfg.enter_pressure and self.step < len(BROWNOUT_STEPS) - 1:
            self.step += 1
            self.transitions += 1
            self._last_change = now
            return [("escalate", self.step)]
        if (
            pressure <= cfg.exit_pressure
            and self.step > 0
            and (self._last_change is None
                 or now - self._last_change >= cfg.cooldown_s)
        ):
            self.step -= 1
            self.transitions += 1
            self._last_change = now
            return [("recover", self.step)]
        return []

    # ---- effect queries (what the current rung degrades) ----
    def spec_allowed(self) -> bool:
        return self.step < 1

    def max_new_cap(self, priority: int) -> Optional[int]:
        if self.step >= 2 and priority >= self.cfg.low_priority:
            return self.cfg.capped_max_new
        return None

    def sheds(self, priority: int) -> bool:
        return self.step >= 3 and priority >= self.cfg.low_priority


class QoSPolicy:
    """Shared admission/fairness/brownout state. The scheduler owns the
    queues and the metrics; this object owns the DECISIONS — which
    request dequeues next, whether a submit is over quota, who the
    queue-full victim is, and what the current brownout rung degrades."""

    def __init__(self, config: Optional[QoSConfig] = None):
        self.config = config or QoSConfig()
        self.brownout = BrownoutController(self.config.brownout)
        self._buckets: Dict[str, TokenBucket] = {}
        # normalized token debt per tenant (service consumed / weight) —
        # the DRR virtual time fair dequeue runs on
        self._debt: Dict[str, float] = {}
        self.shed_counts: Dict[str, int] = {}
        # externally-fed SLO burn (fraction of requests blowing budget);
        # slo_breakdown() is too heavy to recompute per tick, so the
        # fleet/bench feed it at their own cadence
        self._slo_burn = 0.0
        # externally-fed fleet degradation flag (a tiered fleet off its
        # disaggregated rung sets this); floors pressure at
        # brownout.degraded_pressure_floor while held
        self.degraded = False
        self.last_pressure = 0.0

    # ---- token-debt accounting ----
    @staticmethod
    def cost(req) -> float:
        """A request's token debt: prompt positions it writes + tokens it
        may generate (prompt_len folds resumes in, so a preemption resume
        is never double-charged for its recompute)."""
        return float(req.prompt_len + req.max_new_tokens)

    def rate_gate(self, req, now: float) -> Tuple[bool, Optional[float]]:
        """(admit?, retry_after_s). Unlimited tenants always pass."""
        cfg = self.config.tenant(req.tenant)
        if cfg.rate_tokens_per_s is None:
            return True, None
        bucket = self._buckets.get(req.tenant)
        if bucket is None:
            burst = (cfg.burst_tokens if cfg.burst_tokens is not None
                     else cfg.rate_tokens_per_s)
            bucket = self._buckets[req.tenant] = TokenBucket(
                cfg.rate_tokens_per_s, burst, now
            )
        # Clamp to the burst: a single request larger than the bucket would
        # otherwise be permanently inadmissible.  The bucket bounds the
        # sustained rate; one oversized request just drains it to empty.
        n = min(self.cost(req), bucket.burst)
        if bucket.try_take(n, now):
            return True, None
        return False, round(bucket.retry_after(n), 6)

    # ---- weighted-fair dequeue (strict priority, then DRR) ----
    def select(self, waiting: Sequence) -> int:
        """Index of the request to dequeue next: best (lowest) priority
        class first; within it, the tenant with the least normalized
        token debt (FIFO within a tenant). Single-tenant equal-priority
        traffic reduces to index 0 — exactly the pre-QoS FIFO."""
        if len(waiting) <= 1:
            return 0
        best_prio = min(r.priority for r in waiting)
        heads: Dict[str, int] = {}
        for i, r in enumerate(waiting):
            if r.priority == best_prio and r.tenant not in heads:
                heads[r.tenant] = i
        if len(heads) == 1:
            return next(iter(heads.values()))
        # a tenant entering (or re-entering after idling) starts at the
        # debt floor of the tenants already being served: idle time must
        # not bank credit it can burst through later
        known = [self._debt[t] for t in heads if t in self._debt]
        floor = min(known) if known else 0.0
        for t in heads:
            self._debt[t] = max(self._debt.get(t, 0.0), floor)
        tenant = min(heads, key=lambda t: (self._debt[t], heads[t]))
        return heads[tenant]

    def charge(self, req) -> None:
        """Account a dequeue: debt grows by cost/weight, so a weight-2
        tenant drains twice the tokens before parity."""
        w = self.config.tenant(req.tenant).weight
        self._debt[req.tenant] = self._debt.get(req.tenant, 0.0) + self.cost(req) / w

    # ---- bounded queues ----
    def queue_full(self, depth: int) -> bool:
        return (self.config.max_waiting is not None
                and depth >= self.config.max_waiting)

    def queue_full_victim(self, waiting: Sequence, req):
        """Who loses the slot when the line is full: the lowest class
        among the queued requests and the newcomer. The newcomer only
        displaces a queued victim by STRICTLY outranking it (ties keep
        the queued request — it has waited longer); within the victim
        class the most recent submit sheds."""
        worst = None
        for r in waiting:
            if worst is None or (r.priority, r.submitted_time or 0.0) >= (
                worst.priority, worst.submitted_time or 0.0
            ):
                worst = r
        if worst is not None and worst.priority > req.priority:
            return worst
        return req

    def deadline_unmeetable(self, req, ewma_step_s: Optional[float],
                            emit_bound: int) -> bool:
        """True when the TTL provably cannot be met: even generating at
        the per-step emit upper bound (1 token/step plain, draft_len+1
        speculative) for every remaining step, max_new tokens take longer
        than the whole deadline. Conservative by construction — queue
        wait and prompt streaming are ignored, so a True here is a
        certainty, not a forecast."""
        if (not self.config.deadline_shed or req.deadline_s is None
                or ewma_step_s is None or ewma_step_s <= 0.0):
            return False
        min_steps = req.max_new_tokens / max(1, emit_bound)
        return min_steps * ewma_step_s > req.deadline_s

    # ---- pressure / brownout ----
    def note_slo_burn(self, frac: float) -> None:
        """Feed the SLO-burn pressure component (fraction of recent
        requests over budget, e.g. from slo_breakdown()['slo'])."""
        self._slo_burn = min(1.0, max(0.0, float(frac)))

    def set_degraded(self, flag: bool) -> None:
        """Fleet hook: a tiered fleet off its disaggregated rung (decode
        or prefill tier dead — half the chips doing both phases) marks
        the shared policy degraded; while held, pressure readings are
        floored at ``brownout.degraded_pressure_floor`` so the ladder
        escalates BEFORE the thinner fleet's queues actually back up.
        Cleared automatically when the fleet re-splits."""
        self.degraded = bool(flag)

    def pressure(self, pool_frac: float, queue_frac: float) -> float:
        """Composite pressure: the WORST of pool occupancy, queue depth
        (vs max_waiting), and fed SLO burn — any one resource saturating
        is overload, averaging would hide it. A degraded fleet floors
        the reading (see ``set_degraded``)."""
        p = max(
            min(1.0, max(0.0, pool_frac)),
            min(1.0, max(0.0, queue_frac)),
            self._slo_burn,
        )
        if self.degraded:
            p = max(p, self.config.brownout.degraded_pressure_floor)
        self.last_pressure = p
        return p

    def update_pressure(self, now: float, pool_frac: float,
                        queue_frac: float) -> List[Tuple[str, int]]:
        return self.brownout.update(self.pressure(pool_frac, queue_frac), now)

    def note_shed(self, reason: str) -> None:
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1


# ---------------------------------------------------------------------------
# fairness reporting
# ---------------------------------------------------------------------------

def jain_fairness(shares: Sequence[float]) -> Optional[float]:
    """Jain's index J = (Σx)² / (n·Σx²) over per-tenant weighted service;
    1.0 = perfectly fair, 1/n = one tenant took everything."""
    xs = [float(x) for x in shares if x is not None]
    if not xs:
        return None
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return None
    s = sum(xs)
    return round((s * s) / (len(xs) * sq), 4)


def tenant_report(finished: Sequence, config: Optional[QoSConfig] = None) -> Dict:
    """Per-tenant outcome/service breakdown over a drained replay, plus
    the Jain fairness index over weight-normalized generated tokens —
    the serving fairness number."""
    cfg = config or QoSConfig()
    per: Dict[str, Dict] = {}
    for r in finished:
        t = getattr(r, "tenant", "default")
        d = per.setdefault(t, {
            "requests": 0, "completed": 0, "shed": 0, "expired": 0,
            "cancelled": 0, "generated_tokens": 0, "tpots_ms": [],
        })
        d["requests"] += 1
        outcome = r.outcome or "completed"
        if outcome in d:
            d[outcome] += 1
        d["generated_tokens"] += (len(r.prompt) - r.prompt_len) + len(r.generated)
        tpot = r.tpot()
        if tpot is not None:
            d["tpots_ms"].append(tpot * 1000.0)
    shares = []
    for t, d in per.items():
        tpots = sorted(d.pop("tpots_ms"))
        d["p99_tpot_ms"] = (
            round(tpots[min(len(tpots) - 1, int(0.99 * len(tpots)))], 3)
            if tpots else None
        )
        d["weighted_share"] = round(
            d["generated_tokens"] / cfg.tenant(t).weight, 3
        )
        shares.append(d["weighted_share"])
    return {
        "tenants": per,
        "fairness_index": jain_fairness([s for s in shares if s > 0]),
    }
