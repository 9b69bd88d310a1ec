"""Continuous-batching request scheduler with SLO telemetry (counterpart
of paddle_tpu/inference/scheduler.py; pure host logic, every decision the
JAX package's).

Requests are admitted into the in-flight decode batch at token
granularity: with nothing running a prompt takes a bucketed prefill, with
decode in flight it streams through its own decode slot. Admission
consults the pool's prefix index first (a hit shares the resident full
pages and streams only the suffix). When the pool runs dry the lowest-
class, least-advanced request is preempted: its pages are freed and it
re-queues at the front with its generated prefix folded into the prompt
(recompute on resume). `spec_decode` turns decode into draft-then-verify
through one engine.extend() call; greedy verify emits exactly the tokens
plain decode would.

Fleet hooks: a per-request TTL (`Request.deadline_s`, outcome "expired"),
`cancel(rid)`, `drain()`/`resume_admission()`, `evacuate()` and
`adopt_running()` (the disaggregated fleet's KV handoff). QoS
(`qos=QoSPolicy(...)`, inference/qos.py): submit gates through per-tenant
token buckets, the bounded waiting line, the queue-wait bound, deadline
feasibility and brownout step 3; dequeue is strict priority then deficit
round-robin; a blocked high-priority head may preempt a strictly
lower-class request; the brownout ladder turns spec decoding off (rung 1)
and caps low-priority budgets (rung 2) in output-exact ways. Every shed is
terminal (`outcome="shed"`) with a reason and a `retry_after_s` hint.
TTFT/TPOT land in the `paddle_tpu_serving_*` histograms, request phases in
telemetry.request_trace, terminal outcomes on telemetry.timeline.
`admission_mode="streamed"` never runs a bucketed prefill (the tiered
fleet's decode replicas).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import telemetry
from ..telemetry import metrics as _metrics
from ..telemetry import request_trace as _rt
from ..telemetry import timeline as _tl
from .kv_cache import PoolExhausted, chain_extend, prefix_chain_keys
from .qos import BROWNOUT_STEPS, QoSPolicy

__all__ = [
    "Request",
    "ContinuousBatchingScheduler",
    "SpecDecodeConfig",
    "StaticBatchingScheduler",
    "replay",
    "percentiles",
]

_TTFT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0,
)


def _ttft_hist():
    return _metrics.histogram(
        "paddle_tpu_serving_ttft_seconds",
        "time-to-first-token: request arrival -> first prefill logit",
        buckets=_TTFT_BUCKETS,
    )


def _tpot_hist():
    return _metrics.histogram(
        "paddle_tpu_serving_tpot_seconds",
        "time-per-output-token: mean decode interval per request",
        buckets=_TTFT_BUCKETS,
    )


def _req_counter():
    return _metrics.counter(
        "paddle_tpu_serving_requests_total",
        "request lifecycle events; `reason` distinguishes shed/reject "
        "causes (empty on plain lifecycle transitions)",
        label_names=("event", "reason"),
    )


def _brownout_step_gauge():
    return _metrics.gauge(
        "paddle_tpu_qos_brownout_step",
        "current brownout ladder rung (0 = normal, 3 = shedding lowest class)",
    )


def _brownout_transitions(direction: str, to: str):
    return _metrics.counter(
        "paddle_tpu_qos_brownout_transitions_total",
        "brownout ladder transitions by direction and destination rung",
        label_names=("direction", "to"),
    ).labels(direction=direction, to=to)


def _queue_gauge(state: str):
    return _metrics.gauge(
        "paddle_tpu_serving_queue",
        "scheduler occupancy by state",
        label_names=("state",),
    ).labels(state=state)


def _spec_counter(event: str):
    return _metrics.counter(
        "paddle_tpu_spec_decode_tokens_total",
        "speculative-decode tokens by event (drafted = proposed by the "
        "n-gram self-draft, accepted = verified equal to the greedy chain)",
        label_names=("event",),
    ).labels(event=event)


@dataclass
class SpecDecodeConfig:
    """Speculative decoding knobs: `draft_len` tokens are proposed per
    decode step by an n-gram self-draft (the most recent earlier occurrence
    of the context's final `ngram` tokens proposes its continuation — the
    zero-extra-model proposer that exploits the repetition heavy serving
    traffic actually has) and verified in one engine.extend() call."""

    draft_len: int = 3
    ngram: int = 2

    def __post_init__(self):
        if self.draft_len < 1:
            raise ValueError("SpecDecodeConfig.draft_len must be >= 1")
        if self.ngram < 1:
            raise ValueError("SpecDecodeConfig.ngram must be >= 1")


@dataclass
class Request:
    """One generation request. `prompt` is token ids; the scheduler fills
    the runtime fields."""

    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    arrival_time: float = 0.0
    # per-request TTL in scheduler-clock seconds from submit(); an expired
    # request frees its pool pages IMMEDIATELY instead of pinning them for
    # a client that will never read the answer (outcome="expired")
    deadline_s: Optional[float] = None
    # fleet session-affinity key: follow-on requests of one conversation
    # carry the same session so the router sends them to the replica that
    # (may) hold their warm KV pages; None = no affinity
    session: Optional[object] = None
    # QoS identity: tenant keys the token bucket + fair-share debt;
    # priority is the preemption/shed class (0 = highest — a P0 may evict
    # a strictly larger-priority victim's pages, brownout acts on
    # priorities >= the configured low class)
    tenant: str = "default"
    priority: int = 1

    # runtime (scheduler-owned)
    generated: List[int] = field(default_factory=list)
    pages: List[int] = field(default_factory=list)
    preemptions: int = 0
    # terminal disposition: "completed" | "expired" | "cancelled" |
    # "shed" (None while in flight); the fleet also reads it for
    # zero-loss accounting. A shed request carries the retry hint.
    outcome: Optional[str] = None
    # a shed request carries WHY (one of qos.SHED_REASONS) and when to
    # retry — the client-facing half of the explicit-backpressure contract
    shed_reason: Optional[str] = None
    retry_after_s: Optional[float] = None
    # brownout step 2 bookkeeping: the pre-cap generation budget (None =
    # never capped) — recovery tests pin that a capped survivor's output
    # is an exact prefix of its uncapped greedy chain
    qos_orig_max_new: Optional[int] = None
    # absolute clock at submit() — arrival_time is a REPLAY-relative offset
    # and must never be differenced against absolute timestamps
    submitted_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    # token-streamed admission: prompt tokens already written to the cache
    # (cursor == len(prompt) once the request is generating)
    cursor: int = 0
    # recompute-on-resume: prompt tokens re-prefilled after a preemption
    # include the already-generated prefix; `_prompt_len` keeps the original
    _prompt_len: Optional[int] = None
    # prefix cache: prompt tokens served from shared pages instead of
    # recomputed (cumulative across resumes); speculative decoding: tokens
    # proposed by the draft / verified equal to the greedy chain
    cached_tokens: int = 0
    drafted: int = 0
    accepted: int = 0
    # committed full pages already published into the prefix index, and
    # the chain digest AFTER them (== the last registered page's key) so
    # each new page's key costs O(block_size), not O(context)
    _registered_pages: int = 0
    _chain_digest: bytes = b""
    # request-scoped trace handle (telemetry.request_trace) — None unless
    # FLAGS_request_trace sampled this request; travels WITH the request
    # across preemption/evacuation/re-dispatch so the phase chain stays
    # unbroken end to end
    trace: Optional[object] = field(default=None, repr=False, compare=False)

    @property
    def prompt_len(self) -> int:
        return self._prompt_len if self._prompt_len is not None else len(self.prompt)

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    def ttft(self) -> Optional[float]:
        """submit -> first token, scheduler-clock seconds (replay computes
        its arrival-inclusive TTFT itself — arrival_time is an offset on a
        different time base)."""
        if self.first_token_time is None or self.submitted_time is None:
            return None
        return self.first_token_time - self.submitted_time

    def tpot(self) -> Optional[float]:
        """Mean decode interval; None until a second token exists."""
        if len(self.token_times) < 2:
            return None
        return (self.token_times[-1] - self.token_times[0]) / (len(self.token_times) - 1)


class ContinuousBatchingScheduler:
    """Token-level admission into the in-flight decode batch.

    step() = [complete finished] -> [admit waiting while slots + pages
    allow] -> [grow running sequences' page allocation, preempting when the
    pool is dry] -> [one decode step for everyone running].
    """

    def __init__(self, engine, *, max_running: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 prefix_cache: bool = True,
                 spec_decode: Optional[SpecDecodeConfig] = None,
                 qos: Optional[QoSPolicy] = None,
                 admission_mode: str = "auto"):
        self.engine = engine
        self.max_running = int(max_running or engine.max_batch)
        if self.max_running > engine.max_batch:
            raise ValueError("max_running exceeds the engine's decode capacity")
        self.eos_id = eos_id
        self.clock = clock
        self.prefix_cache = bool(prefix_cache)
        self.spec = spec_decode
        # "auto" (default): idle-scheduler admissions run a bucketed prefill
        # program, busy ones stream. "streamed": NEVER bucketed — the
        # disaggregated fleet's decode tier runs this, so it serves streamed
        # prefill (tier-degradation intake) without ever compiling a prefill
        # bucket, keeping its compile family decode-only
        if admission_mode not in ("auto", "streamed"):
            raise ValueError(
                f"admission_mode {admission_mode!r} is not 'auto' or 'streamed'")
        self.admission_mode = admission_mode
        # shared across a fleet's replicas: buckets/debt/ladder are
        # fleet-wide state, the scheduler only consults it
        self.qos = qos
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.finished: List[Request] = []
        self.preempted_total = 0
        self.shed_total = 0
        # measured per-step latency (same 0.8/0.2 blend the fleet router
        # drains by) — the deadline-shed and retry-after estimates
        self.ewma_step_s: Optional[float] = None
        # drain mode (fleet hot-swap protocol): admissions stop, in-flight
        # work keeps decoding to completion, submit() still accepts (the
        # caller is expected to route elsewhere; anything queued here just
        # waits out the drain)
        self.draining = False

    # ---- queue surface ----
    def drain(self) -> None:
        """Stop admitting new work into decode slots (in-flight requests
        run to completion). The fleet swap protocol: drain -> swap weights
        -> resume_admission."""
        self.draining = True

    def resume_admission(self) -> None:
        self.draining = False

    def submit(self, req: Request) -> None:
        max_ctx = self.engine.max_seq_len
        # prompt_len, not len(prompt): a preempted/evacuated request folds
        # its generated prefix into the prompt, but its FINAL context is
        # still original-prompt + max_new (re-validating the folded length
        # would reject a legal request mid-recovery)
        total = req.prompt_len + req.max_new_tokens
        if total > max_ctx:
            self._count_reject("context_overflow")
            raise ValueError(
                f"request {req.rid}: prompt_len {req.prompt_len} + "
                f"max_new_tokens {req.max_new_tokens} = {total} "
                f"exceeds max_seq_len {max_ctx}"
            )
        pool = self.engine.pool
        if pool.blocks_for_tokens(total) > pool.num_blocks - 1:
            # would deadlock at its final preemption-resume: even an empty
            # pool could never hold the full context
            self._count_reject("pool_capacity")
            raise ValueError(
                f"request {req.rid}: full context of {total} tokens "
                f"(prompt_len {req.prompt_len} + max_new_tokens "
                f"{req.max_new_tokens}) needs {pool.blocks_for_tokens(total)} "
                f"pages; the pool has {pool.num_blocks - 1} usable "
                f"(num_blocks {pool.num_blocks} minus the reserved page)"
            )
        # preserved across re-dispatch (like _prompt_len): a request
        # evacuated off a dead replica keeps its ORIGINAL submit clock, so
        # its TTL and client-perceived TTFT never silently restart
        if req.submitted_time is None:
            req.submitted_time = self.clock()
        if self.qos is not None and self._qos_submit_gate(req):
            return  # shed: terminal, counted, retryable
        self.waiting.append(req)
        if req.trace is None:
            req.trace = _rt.start(
                req.rid, req.submitted_time,
                prompt_len=req.prompt_len, max_new=req.max_new_tokens,
            )
            if req.trace is not None:
                req.trace.phase("queue", self.clock())
        elif req.trace.phase_name != "preempt":
            # re-dispatch of an already-traced request (fleet migration off
            # a draining replica): it queues again; an open "preempt" span
            # (evacuation/preemption) instead runs until re-admission
            req.trace.phase("queue", self.clock(), cause="requeue")
        if telemetry.enabled():
            _req_counter().labels(event="submitted", reason="").inc()
            self._sync_gauges()

    @staticmethod
    def _count_reject(reason: str) -> None:
        """Validation rejections (the ValueError paths) get the same
        reason-labeled visibility as sheds — a dashboard must be able to
        tell WHY requests bounce, not just that they did."""
        if telemetry.enabled():
            _req_counter().labels(event="rejected", reason=reason).inc()

    def _qos_submit_gate(self, req: Request) -> bool:
        """Admission-time QoS gates in cheapest-first order; returns True
        when the request was shed (terminal — caller must not queue it)."""
        qos = self.qos
        now = self.clock()
        # brownout step 3: new lowest-class work is refused while the
        # ladder is at the top rung; retry after the recovery cooldown
        if qos.brownout.sheds(req.priority):
            self._shed_submit(req, now, "brownout",
                              retry_after=qos.brownout.cfg.cooldown_s)
            return True
        ok, retry = qos.rate_gate(req, now)
        if not ok:
            self._shed_submit(req, now, "rate_limit", retry_after=retry)
            return True
        emit_bound = (self.spec.draft_len + 1) if self.spec is not None else 1
        if qos.deadline_unmeetable(req, self.ewma_step_s, emit_bound):
            # no retry hint: a TTL the engine provably cannot meet will
            # not be meetable a bucket-refill later either
            self._shed_submit(req, now, "deadline_unmeetable")
            return True
        if qos.queue_full(len(self.waiting)):
            victim = qos.queue_full_victim(self.waiting, req)
            retry = (round(self.ewma_step_s * max(1, len(self.waiting)), 6)
                     if self.ewma_step_s else None)
            if victim is req:
                self._shed_submit(req, now, "queue_full", retry_after=retry)
                return True
            # the newcomer strictly outranks the lowest queued class:
            # the victim sheds, the newcomer takes its slot
            self.waiting.remove(victim)
            self._shed(victim, now, "queue_full", retry_after=retry)
        return False

    def _shed_submit(self, req: Request, now: float, reason: str,
                     retry_after: Optional[float] = None) -> None:
        """Shed at the submit boundary: the request still counts as
        submitted (offered load) and gets a trace so the span chain
        contract holds for EVERY terminal path."""
        if req.trace is None:
            req.trace = _rt.start(
                req.rid, req.submitted_time,
                prompt_len=req.prompt_len, max_new=req.max_new_tokens,
            )
            if req.trace is not None:
                req.trace.phase("queue", now)
        if telemetry.enabled():
            _req_counter().labels(event="submitted", reason="").inc()
        self._shed(req, now, reason, retry_after=retry_after)

    def _shed(self, req: Request, now: float, reason: str,
              retry_after: Optional[float] = None) -> None:
        """Terminal overload rejection: explicit, counted, retryable.
        Waiting/new requests hold no pages, so _finish's free is a no-op;
        the request lands in `finished` with outcome="shed" (zero-loss
        fleet accounting sees it like any other terminal outcome)."""
        req.outcome = "shed"
        req.shed_reason = reason
        req.retry_after_s = retry_after
        self.shed_total += 1
        _tl.emit("qos", "shed", severity="warn", rid=req.rid, reason=reason,
                 priority=req.priority, retry_after_s=retry_after)
        if self.qos is not None:
            self.qos.note_shed(reason)
        self._finish(req, now, reason=reason)
        if telemetry.enabled():
            self._sync_gauges()

    def idle(self) -> bool:
        return not self.waiting and not self.running

    def _sync_gauges(self) -> None:
        _queue_gauge("running").set(len(self.running))
        _queue_gauge("waiting").set(len(self.waiting))

    # ---- lifecycle ----
    def _finish(self, req: Request, now: float, reason: str = "") -> None:
        req.finish_time = now
        req.outcome = req.outcome or "completed"
        # retain=True: a finished request's registered (committed, full)
        # pages stay resident at refcount zero, LRU-evictable — the warm
        # prefix cache a follow-on request with the same system prompt hits
        self.engine.pool.free(req.pages, owner=req.rid, retain=True)
        req.pages = []
        self.finished.append(req)
        if req.trace is not None:
            extra = {"reason": reason} if reason else {}
            if req.retry_after_s is not None:
                extra["retry_after_s"] = req.retry_after_s
            req.trace.close(
                now, req.outcome,
                generated=(len(req.prompt) - req.prompt_len) + len(req.generated),
                preemptions=req.preemptions,
                cached_tokens=req.cached_tokens,
                drafted=req.drafted,
                accepted=req.accepted,
                **extra,
            )
        if telemetry.enabled():
            _req_counter().labels(event=req.outcome, reason=reason).inc()
            tpot = req.tpot()
            if tpot is not None:
                _tpot_hist().observe(tpot)
        # every terminal disposition lands on the incident timeline: the
        # completed ones are the denominator, the shed/expired/cancelled
        # ones are what an SLO-burn triage window needs to see
        _tl.emit("scheduler", "request.finish",
                 severity="info" if req.outcome == "completed" else "warn",
                 rid=req.rid, outcome=req.outcome, reason=reason,
                 generated=len(req.generated), preemptions=req.preemptions)

    def cancel(self, rid: int) -> bool:
        """Client-side cancellation: drop the request wherever it is and
        free its pages IMMEDIATELY (a stuck/gone client must not pin pool
        pages for the rest of the process). Returns False when `rid` is not
        in flight (already finished or never submitted)."""
        for queue in (self.waiting, self.running):
            for req in queue:
                if req.rid == rid:
                    queue.remove(req)
                    req.outcome = "cancelled"
                    self._finish(req, self.clock())
                    if telemetry.enabled():
                        self._sync_gauges()
                    return True
        return False

    def _expire_due(self, now: float) -> None:
        """Per-request TTL: requests past their deadline_s (scheduler-clock
        seconds since submit) finish with outcome="expired" and free their
        pages right now — the serving-tier analogue of a dead client."""
        for queue in (self.waiting, self.running):
            for req in list(queue):
                if (
                    req.deadline_s is not None
                    and req.submitted_time is not None
                    and now - req.submitted_time > req.deadline_s
                ):
                    queue.remove(req)
                    req.outcome = "expired"
                    self._finish(req, now)

    def _reset_for_resume(self, req: Request) -> Request:
        """Recompute-on-resume bookkeeping shared by preemption and fleet
        evacuation: generated tokens fold into the prompt (their K/V is
        rebuilt by a fresh prefill/stream on whatever engine resumes the
        request) and the streaming cursor rewinds. Pages must already be
        freed by the caller."""
        if req._prompt_len is None:
            req._prompt_len = len(req.prompt)
        req.prompt = req.prompt + req.generated
        req.generated = []
        req.cursor = 0
        req._registered_pages = 0
        req._chain_digest = b""
        return req

    def _preempt_one(self, cause: str = "pool_dry",
                     below_priority: Optional[int] = None) -> bool:
        """Evict the lowest-class request with the least sunk work
        (priority descending, then still-streaming first, then youngest)
        back to the front of the waiting queue, recompute-on-resume.
        `below_priority` restricts victims to strictly lower classes —
        the QoS priority-preemption path; equal-priority traffic (the
        default) keeps the original pool-dry victim order exactly."""
        candidates = (
            [r for r in self.running if r.priority > below_priority]
            if below_priority is not None else self.running
        )
        if not candidates:
            return False
        victim = max(
            candidates,
            key=lambda r: (r.priority, r.first_token_time is None,
                           r.first_token_time or 0.0, r.rid),
        )
        self.running.remove(victim)
        # retain=False: an evicted context is conceptually discarded — its
        # refcount-zero pages go straight back to the free list and their
        # index entries drop, so a preemption-freed page can NEVER serve a
        # later prefix hit after being overwritten by a new owner
        self.engine.pool.free(victim.pages, owner=victim.rid, retain=False)
        victim.pages = []
        self._reset_for_resume(victim)
        victim.preemptions += 1
        self.preempted_total += 1
        self.waiting.insert(0, victim)
        if victim.trace is not None:
            # the preempt span runs until re-admission (recompute resumes)
            victim.trace.phase("preempt", self.clock(), cause=cause)
        if telemetry.enabled():
            _req_counter().labels(
                event="preempted",
                reason="" if cause == "pool_dry" else cause,
            ).inc()
        _tl.emit("scheduler", "preempt", severity="warn", rid=victim.rid,
                 cause=cause, preemptions=victim.preemptions)
        return True

    def evacuate(self) -> List[Request]:
        """Pull EVERY in-flight and queued request out of this scheduler,
        reset for recompute-on-resume (the preemption path generalized to
        the whole replica), and return them in resume order (running
        first — they have the most sunk work — then waiting). The fleet
        calls this when a replica's circuit breaker opens: the requests are
        re-submitted to a healthy replica and their K/V pages are rebuilt
        from the folded prompt there."""
        evacuated: List[Request] = []
        now = self.clock()
        for req in self.running:
            # same retain=False contract as preemption:
            # evacuated pages leave the index before they can be recycled
            self.engine.pool.free(req.pages, owner=req.rid, retain=False)
            req.pages = []
            evacuated.append(self._reset_for_resume(req))
        # waiting requests hold no pages; a preemption-requeued one is
        # already in resume form
        evacuated.extend(self.waiting)
        for req in evacuated:
            if req.trace is not None:
                # cause-labeled: distinguishable from pool_dry preemption
                req.trace.phase("preempt", now, cause="evacuation")
        self.running = []
        self.waiting = []
        if telemetry.enabled():
            self._sync_gauges()
        return evacuated

    def adopt_running(self, req: Request) -> None:
        """Attach an in-flight request whose KV pages are ALREADY resident
        in this scheduler's pool (the fleet's prefill->decode KV migration):
        no re-validation, no clock re-stamping — the request keeps decoding
        exactly where it left off. The caller owns the page handoff (pages
        allocated here, CRC-verified) and the prefix-registration reset so
        this pool republishes the chain itself."""
        if len(self.running) >= self.max_running:
            raise RuntimeError(
                f"adopt_running: no free decode slot for request {req.rid}")
        self.running.append(req)
        if telemetry.enabled():
            self._sync_gauges()

    def _emit_token(self, req: Request, logits: np.ndarray, now: float) -> None:
        token = int(np.argmax(logits))
        req.generated.append(token)
        req.token_times.append(now)
        # every emitted token belongs to the decode phase — keyed on the
        # trace's own phase, not first_token_time, because a mid-decode
        # preemption re-opens a prefill span on resume (first_token_time
        # stays set) and the post-resume tokens must flip back to decode
        if req.trace is not None and req.trace.phase_name != "decode":
            req.trace.phase("decode", now)
        if req.first_token_time is None:
            req.first_token_time = now
            if telemetry.enabled() and req.submitted_time is not None:
                # both timestamps from the scheduler clock: queue wait
                # inside the scheduler is included, replay-offset arrival
                # bookkeeping is not (it lives on a different time base)
                _ttft_hist().observe(max(0.0, now - req.submitted_time))
        total_generated = (len(req.prompt) - req.prompt_len) + len(req.generated)
        if total_generated >= req.max_new_tokens or (
            self.eos_id is not None and token == self.eos_id
        ):
            self._finish(req, now)

    @staticmethod
    def _tokens_needed(req: Request) -> int:
        """Cache slots this step's write for `req` must be covered for:
        streaming writes prompt[cursor] at position cursor; generation
        writes generated[-1] at position context_len - 1."""
        if req.cursor < len(req.prompt):
            return req.cursor + 1
        return req.context_len

    def _try_admit(self) -> Optional[int]:
        """Admit the oldest waiting request into a free decode slot;
        returns the number of tokens emitted by the admission (1 for a
        bucketed prefill, 0 for a streamed one), or None when blocked.

        Two admission paths (the continuous-batching TPOT trade): with
        NOTHING in flight there is no one to stall, so the prompt runs
        through a bucketed prefill program in one shot (TTFT-optimal).
        With decode in flight, a monolithic prefill between two decode
        steps would stretch every in-flight request's inter-token interval
        — instead the prompt is STREAMED through the request's own decode
        slot one token per step (chunked prefill at token granularity), so
        admission never stalls anyone else's decode cadence.

        Admission consults the prefix index first. A hit shares
        the resident pages (refcounted) and ALWAYS streams — only the
        un-cached suffix flows through decode slots, and the bucketed
        prefill (which writes every prompt position) never touches shared
        pages. The last prompt token is never served from cache: its
        logits emit the first generated token, so at least one position
        always recomputes.
        """
        if self.draining or not self.waiting or len(self.running) >= self.max_running:
            return None
        # QoS dequeue order: strict priority, then deficit-round-robin
        # over token debt (single-tenant equal-priority traffic selects
        # index 0 — the pre-QoS FIFO, preemption-requeue order included)
        idx = self.qos.select(self.waiting) if self.qos is not None else 0
        req = self.waiting[idx]
        pool = self.engine.pool
        shared: List[int] = []
        if self.prefix_cache and req.cursor == 0:
            n_shareable = (len(req.prompt) - 1) // pool.block_size
            if n_shareable > 0:
                keys = prefix_chain_keys(req.prompt, pool.block_size)[:n_shareable]
                shared = pool.acquire_prefix(keys, owner=req.rid)
        if not self.running and not shared and self.admission_mode == "auto":
            need = pool.blocks_for_tokens(len(req.prompt) + 1)
            if need <= pool.available():
                self.waiting.pop(idx)
                self._qos_on_admit(req)
                req.pages = pool.alloc(need, owner=req.rid)
                if req.trace is not None:
                    self._trace_admit(req, mode="bucketed")
                logits = self.engine.prefill(req.prompt, req.pages)
                req.cursor = len(req.prompt)
                if telemetry.enabled():
                    _req_counter().labels(event="admitted", reason="").inc()
                self._emit_token(req, logits, self.clock())
                if not req.done:
                    self.running.append(req)
                self._register_committed(req)
                return 1
            # bucketed allocation doesn't fit: fall through and stream the
            # prompt page-by-page instead (the pool-constrained path)
        # streamed admission: one fresh page holds the first uncached write
        if pool.available() < 1:
            if shared:
                # admission blocked after the lookup took refs — hand them
                # back (retained, still indexed) so nothing leaks
                pool.free(shared, owner=req.rid, retain=True)
            return None
        self.waiting.pop(idx)
        self._qos_on_admit(req)
        cached = len(shared) * pool.block_size
        req.pages = list(shared) + pool.alloc(1, owner=req.rid)
        req.cursor = cached
        req.cached_tokens += cached
        # shared pages are already indexed; the chain digest resumes from
        # the last hit page's key (keys ARE the chain digests)
        req._registered_pages = len(shared)
        req._chain_digest = keys[len(shared) - 1] if shared else b""
        self.running.append(req)
        if req.trace is not None:
            self._trace_admit(req, mode="streamed", cached=cached)
        if telemetry.enabled():
            _req_counter().labels(event="admitted", reason="").inc()
        return 0

    def _trace_admit(self, req: Request, mode: str, cached: int = 0) -> None:
        """Open the prefill span; `recompute_tokens` counts the generated
        prefix folded into the prompt by preemption/evacuation — the K/V
        this prefill rebuilds rather than computes for the first time —
        and `cached_tokens` the prompt tokens served from shared prefix
        pages (never recomputed at all)."""
        req.trace.phase(
            "prefill", self.clock(), mode=mode,
            recompute_tokens=len(req.prompt) - req.prompt_len,
            cached_tokens=cached,
        )

    def _qos_on_admit(self, req: Request) -> None:
        """Dequeue accounting + brownout step-2 budget cap. The cap is an
        exact PREFIX of the uncapped greedy chain (greedy decode is
        deterministic), and recovery keeps the original budget in
        `qos_orig_max_new` so tests can pin prefix-exactness."""
        if self.qos is None:
            return
        self.qos.charge(req)
        cap = self.qos.brownout.max_new_cap(req.priority)
        if cap is not None and req.max_new_tokens > cap:
            # never cap below what a resume has already folded/generated
            # (+1 so the request still terminates on its next token)
            already = (len(req.prompt) - req.prompt_len) + len(req.generated)
            budget = max(cap, already + 1)
            if budget < req.max_new_tokens:
                if req.qos_orig_max_new is None:
                    req.qos_orig_max_new = req.max_new_tokens
                req.max_new_tokens = budget
                if req.trace is not None:
                    req.trace.event("qos_max_new_capped", self.clock(),
                                    cap=budget, orig=req.qos_orig_max_new)

    def _qos_priority_preempt(self) -> bool:
        """A blocked high-priority head may evict ONE strictly
        lower-class running request through the pool-dry preempt-resume
        machinery (the victim resumes later with the exact-output
        guarantee). Returns True when a victim was evicted — the caller
        retries admission."""
        if (self.qos is None or self.draining or not self.waiting
                or not self.running):
            return False
        head = self.waiting[self.qos.select(self.waiting)]
        return self._preempt_one(cause="priority",
                                 below_priority=head.priority)

    # ---- prefix-index registration ----
    def _kv_committed(self, req: Request) -> int:
        """Cache positions holding FINAL K/V: a streaming request has
        written [0, cursor); a generating one everything except the newest
        token (whose K/V lands when it is fed back in)."""
        if req.cursor < len(req.prompt):
            return req.cursor
        return req.context_len - 1

    def _register_committed(self, req: Request) -> None:
        """Publish the request's committed FULL pages into the prefix
        index (idempotent; shared pages are already registered). Draft
        positions are never committed, so a speculatively-written page can
        only register after its tokens are verified."""
        if not self.prefix_cache or not req.pages:
            return
        pool = self.engine.pool
        bs = pool.block_size
        full = self._kv_committed(req) // bs
        if full <= req._registered_pages:
            return
        tokens = req.prompt + req.generated
        h = req._chain_digest
        for i in range(req._registered_pages, full):
            h = chain_extend(h, tokens[i * bs:(i + 1) * bs])
            pool.register_prefix(h, req.pages[i])
        req._chain_digest = h
        req._registered_pages = full

    # ---- speculative decoding ----
    def _propose_ngram(self, req: Request, k: int) -> List[int]:
        """n-gram self-draft: the most recent earlier occurrence of the
        context's final `ngram` tokens proposes the k tokens that followed
        it. Zero extra model weights; exact greedy verify makes a bad guess
        cost only wasted FLOPs, never a wrong token."""
        n = self.spec.ngram
        seq = req.prompt + req.generated
        if k <= 0 or len(seq) <= n:
            return []
        tail = seq[-n:]
        for i in range(len(seq) - n - 1, -1, -1):
            if seq[i:i + n] == tail:
                return list(seq[i + n:i + n + k])
        return []

    def _plan_row(self, req: Request) -> Tuple[str, List[int], List[int]]:
        """One request's extend-row plan: (kind, tokens, positions).
        Streaming rows chunk up to Q prompt tokens per step (chunked
        prefill at chunk granularity); generating rows carry the committed
        last token plus up to draft_len n-gram drafts to verify."""
        Q = self.spec.draft_len + 1
        if req.cursor < len(req.prompt):
            take = min(Q, len(req.prompt) - req.cursor)
            toks = list(req.prompt[req.cursor:req.cursor + take])
            poss = list(range(req.cursor, req.cursor + take))
            return "stream", toks, poss
        ctx = req.context_len
        total_gen = (len(req.prompt) - req.prompt_len) + len(req.generated)
        rem = req.max_new_tokens - total_gen
        # a chain of d drafts can emit d+1 tokens and writes K/V through
        # position ctx-1+d — cap by the generation budget AND the table
        budget = min(self.spec.draft_len, rem - 1,
                     self.engine.max_seq_len - ctx)
        drafts = self._propose_ngram(req, budget) if budget > 0 else []
        if drafts:
            req.drafted += len(drafts)
            if telemetry.enabled():
                _spec_counter("drafted").inc(len(drafts))
        toks = [req.generated[-1]] + drafts
        poss = list(range(ctx - 1, ctx - 1 + len(toks)))
        return "draft", toks, poss

    def _spec_decode_step(self, alive: List[Request], plans: Dict) -> int:
        """One verify/extend tick: every alive row's plan runs through a
        single engine.extend() call; draft rows commit their greedy-
        verified chain (byte-identical to plain decode — each emitted token
        IS the argmax the plain path would have produced), then roll back
        surplus tail pages the rejected drafts grew."""
        pool = self.engine.pool
        Q = self.spec.draft_len + 1
        logits = self.engine.extend(
            [plans[r.rid][1] for r in alive],
            [plans[r.rid][2] for r in alive],
            [r.pages for r in alive],
            q_len=Q,
        )
        now = self.clock()
        produced = 0
        for i, r in enumerate(alive):
            kind, toks, _poss = plans[r.rid]
            if kind == "stream":
                r.cursor += len(toks)
                if r.cursor == len(r.prompt):
                    # the last prompt token's logits ARE the first
                    # generated token
                    self._emit_token(r, logits[i, len(toks) - 1], now)
                    produced += 1
                continue
            drafts = toks[1:]
            j = 0
            while j < len(toks):
                self._emit_token(r, logits[i, j], now)
                produced += 1
                if r.done:
                    break
                if j < len(drafts) and drafts[j] == r.generated[-1]:
                    # draft j matches the greedy chain: its K/V is already
                    # written and logits[i, j+1] verified it — keep reading
                    r.accepted += 1
                    if telemetry.enabled():
                        _spec_counter("accepted").inc()
                    j += 1
                else:
                    break
            if not r.done and drafts:
                # rollback: rejected drafts' stale K/V sits past seq_len
                # (masked, overwritten on commit); surplus TAIL pages the
                # draft chain grew go back to the pool now — they are
                # exclusively owned and never registered (only committed
                # full pages enter the index)
                keep = pool.blocks_for_tokens(self._tokens_needed(r))
                while len(r.pages) > keep:
                    pool.free([r.pages.pop()], owner=r.rid, retain=False)
        return produced

    def step(self) -> int:
        """One scheduler tick; returns the number of tokens produced.

        With QoS: sweep the queue-wait bound, feed measured pressure into
        the brownout ladder (transitions counted + trace-annotated), gate
        speculative decoding off at rung >= 1 (greedy verify is
        byte-identical, so this degrades only step count), and blend this
        tick's wall into `ewma_step_s` — the drain estimate the
        deadline/retry-after hints run on."""
        t_start = self.clock()
        if self.qos is not None:
            self._qos_pre_step(t_start)
        spec_saved = self.spec
        if (self.spec is not None and self.qos is not None
                and not self.qos.brownout.spec_allowed()):
            self.spec = None
        try:
            produced = self._step_inner()
        finally:
            self.spec = spec_saved
        dt = self.clock() - t_start
        if dt > 0.0:
            self.ewma_step_s = (dt if self.ewma_step_s is None
                                else 0.8 * self.ewma_step_s + 0.2 * dt)
        return produced

    def _qos_pre_step(self, now: float) -> None:
        qos = self.qos
        bound = qos.config.max_queue_wait_s
        if bound is not None:
            for req in list(self.waiting):
                if (req.submitted_time is not None
                        and now - req.submitted_time > bound):
                    self.waiting.remove(req)
                    self._shed(req, now, "queue_wait")
        pool = self.engine.pool
        pool_frac = pool.occupancy()
        if qos.config.max_waiting:
            queue_frac = len(self.waiting) / qos.config.max_waiting
        else:
            # unbounded line: scale depth against a few batches' worth so
            # sustained backlog still reads as pressure
            queue_frac = len(self.waiting) / float(4 * self.max_running)
        for direction, to_step in qos.update_pressure(now, pool_frac, queue_frac):
            if telemetry.enabled():
                _brownout_step_gauge().set(to_step)
                _brownout_transitions(direction, BROWNOUT_STEPS[to_step]).inc()
            _rt.record_event(
                "qos", "brownout", now, direction=direction, step=to_step,
                rung=BROWNOUT_STEPS[to_step],
                pressure=round(qos.last_pressure, 4),
            )
            _tl.emit("qos", "brownout",
                     severity="warn" if direction == "up" else "info",
                     direction=direction, step=to_step,
                     rung=BROWNOUT_STEPS[to_step],
                     pressure=round(qos.last_pressure, 4))

    def _step_inner(self) -> int:
        produced = 0
        # TTL sweep first: an expired request must not consume an admission
        # slot or grow pages this very tick
        self._expire_due(self.clock())
        # admission: fill free decode slots from the waiting line; a
        # blocked high-priority head may preempt a strictly lower-class
        # running victim (its pages free, admission retries)
        while True:
            emitted = self._try_admit()
            if emitted is not None:
                produced += emitted
                continue
            if not self._qos_priority_preempt():
                break

        if not self.running:
            if telemetry.enabled():
                self._sync_gauges()
            return produced

        # speculative plans first: growth must cover every position the
        # draft chain will write, not just the next token
        plans: Dict[int, Tuple[str, List[int], List[int]]] = {}
        if self.spec is not None:
            for req in self.running:
                plans[req.rid] = self._plan_row(req)

        # growth: every running sequence needs pages covering the K/V slots
        # this step writes; allocate at block boundaries, preempting until
        # the pool yields one
        pool = self.engine.pool
        for req in list(self.running):
            if req not in self.running:
                # evicted by an earlier iteration's preemption — allocating
                # into it now would leak the page at re-admission
                continue
            if self.spec is not None:
                need_tokens = plans[req.rid][2][-1] + 1
            else:
                need_tokens = self._tokens_needed(req)
            if need_tokens > self.engine.max_seq_len:
                # capacity guard (submit() bounds this; belt-and-braces)
                self._finish(req, self.clock())
                continue
            while pool.blocks_for_tokens(need_tokens) > len(req.pages):
                try:
                    req.pages.extend(pool.alloc(1, owner=req.rid))
                except PoolExhausted:
                    if req in self.running and len(self.running) == 1:
                        raise  # nothing left to evict but ourselves
                    if not self._preempt_one():
                        raise
                    if req not in self.running:
                        break  # we were the victim
            # copy-on-write guard: no position this step writes may land in
            # a page another request still reads. Full-page-aligned sharing
            # makes this structurally unreachable in steady state, but the
            # evacuate/resume and rollback races are exactly where a silent
            # scribble would corrupt a neighbor — clone instead.
            if req in self.running and req.pages:
                if self.spec is not None:
                    _, _, poss = plans[req.rid]
                    lo, hi = poss[0], poss[-1]
                else:
                    hi = self._tokens_needed(req) - 1
                    lo = hi
                for pi in range(lo // pool.block_size,
                                min(hi // pool.block_size, len(req.pages) - 1) + 1):
                    if pool.refcount(req.pages[pi]) > 1:
                        req.pages[pi] = pool.make_private(req.pages[pi], owner=req.rid)
        alive = [r for r in self.running if r.pages]

        if alive and self.spec is not None:
            produced += self._spec_decode_step(alive, plans)
            self.running = [r for r in self.running if not r.done]
        elif alive:
            rows = []
            for r in alive:
                if r.cursor < len(r.prompt):  # streaming its prompt in
                    rows.append((r, r.prompt[r.cursor], r.cursor))
                else:
                    rows.append((r, r.generated[-1], r.context_len - 1))
            logits = self.engine.decode(
                tokens=[t for _, t, _ in rows],
                positions=[p for _, _, p in rows],
                seq_lens=[p + 1 for _, _, p in rows],
                page_rows=[r.pages for r, _, _ in rows],
            )
            now = self.clock()
            for (r, _, _), lg in zip(rows, logits):
                if r.cursor < len(r.prompt):
                    r.cursor += 1
                    if r.cursor == len(r.prompt):
                        # the last prompt token's logits ARE the first
                        # generated token
                        self._emit_token(r, lg, now)
                        produced += 1
                else:
                    self._emit_token(r, lg, now)
                    produced += 1
            self.running = [r for r in self.running if not r.done]
        if self.prefix_cache:
            for r in self.running:
                self._register_committed(r)
        if telemetry.enabled():
            self._sync_gauges()
            active_tokens = sum(self._tokens_needed(r) for r in self.running)
            pool.note_fragmentation(active_tokens)
        return produced


class StaticBatchingScheduler:
    """The baseline continuous batching is measured against: requests are
    taken in arrival order in fixed groups of `batch_size`; a group decodes
    until EVERY member hits its budget (finished slots idle), and no new
    request enters until the whole group drains."""

    def __init__(self, engine, *, batch_size: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.batch_size = int(batch_size or engine.max_batch)
        self.eos_id = eos_id
        self.clock = clock
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.finished: List[Request] = []
        self.preempted_total = 0

    def submit(self, req: Request) -> None:
        req.submitted_time = self.clock()
        self.waiting.append(req)

    def idle(self) -> bool:
        return not self.waiting and not self.running

    def _emit(self, req: Request, logits: np.ndarray, now: float) -> None:
        token = int(np.argmax(logits))
        req.generated.append(token)
        req.token_times.append(now)
        if req.first_token_time is None:
            req.first_token_time = now

    def _done(self, req: Request) -> bool:
        return len(req.generated) >= req.max_new_tokens or (
            self.eos_id is not None and req.generated
            and req.generated[-1] == self.eos_id
        )

    def step(self) -> int:
        produced = 0
        pool = self.engine.pool
        if not self.running and self.waiting:
            group, self.waiting = self.waiting[: self.batch_size], self.waiting[self.batch_size:]
            for req in group:
                req.pages = pool.alloc(
                    pool.blocks_for_tokens(len(req.prompt) + req.max_new_tokens)
                )
                logits = self.engine.prefill(req.prompt, req.pages)
                self._emit(req, logits, self.clock())
                produced += 1
            self.running = group
        if not self.running:
            return produced
        live = [r for r in self.running if not self._done(r)]
        if live:
            logits = self.engine.decode(
                tokens=[r.generated[-1] for r in live],
                positions=[r.context_len - 1 for r in live],
                seq_lens=[r.context_len for r in live],
                page_rows=[r.pages for r in live],
            )
            now = self.clock()
            for r, lg in zip(live, logits):
                self._emit(r, lg, now)
                produced += 1
        if all(self._done(r) for r in self.running):
            now = self.clock()
            for r in self.running:
                r.finish_time = now
                pool.free(r.pages)
                r.pages = []
                self.finished.append(r)
            self.running = []
        return produced


def replay(scheduler, requests: Sequence[Request], *,
           clock: Callable[[], float] = time.monotonic,
           max_wall_s: float = 600.0) -> Dict:
    """Feed `requests` to `scheduler` honoring their arrival_time offsets
    (seconds from replay start) and run until everything drains. Returns
    aggregate serving stats: tokens/s over generated tokens + p50/p99
    TTFT/TPOT in milliseconds."""
    pending = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
    t0 = clock()
    i = 0
    while i < len(pending) or not scheduler.idle():
        now = clock() - t0
        if clock() - t0 > max_wall_s:
            raise TimeoutError(f"replay exceeded {max_wall_s}s wall budget")
        while i < len(pending) and pending[i].arrival_time <= now:
            scheduler.submit(pending[i])
            i += 1
        if scheduler.idle():
            # nothing in flight: don't burn a step, wait for the next arrival
            if i < len(pending):
                time.sleep(min(0.001, max(0.0, pending[i].arrival_time - now)))
            continue
        scheduler.step()
    wall = clock() - t0

    done = list(scheduler.finished)
    # arrival_time is an offset from t0; ttft/token_times are absolute clock
    # values — normalize before differencing
    ttfts = [r.first_token_time - (t0 + r.arrival_time) for r in done
             if r.first_token_time is not None]
    # TPOT percentiles over POOLED inter-token intervals (vLLM's ITL
    # convention): a per-request-mean p99 degenerates to "worst request's
    # mean", which one OS/GC blip in a short request dominates
    tpots = [iv for r in done for iv in np.diff(r.token_times)]
    total_tokens = sum(
        (len(r.prompt) - r.prompt_len) + len(r.generated) for r in done
    )
    out = {
        "n_requests": len(done),
        "generated_tokens": int(total_tokens),
        "wall_s": round(wall, 4),
        "tokens_per_sec": round(total_tokens / wall, 2) if wall > 0 else None,
        "preempted": getattr(scheduler, "preempted_total", 0),
    }
    out.update(percentiles("ttft_ms", [t * 1000 for t in ttfts]))
    out.update(percentiles("tpot_ms", [t * 1000 for t in tpots]))
    return out


def percentiles(name: str, values: Sequence[float]) -> Dict[str, Optional[float]]:
    if not values:
        return {f"p50_{name}": None, f"p99_{name}": None}
    arr = np.asarray(values, np.float64)
    return {
        f"p50_{name}": round(float(np.percentile(arr, 50)), 3),
        f"p99_{name}": round(float(np.percentile(arr, 99)), 3),
    }
