"""Retry with exponential backoff + full jitter under an overall deadline
(counterpart of paddle_tpu/distributed/resilience/retry.py).

The one retry vocabulary for the distributed runtime: TCPStore connect and
op reconnects, launch rendezvous, and the launcher's pod-restart backoff all
draw their delay schedule from here, and every retrying site publishes
`paddle_tpu_retry_attempts_total` / `_retries_total` / `_giveups_total`
{site} counters so a flapping dependency is visible in one telemetry
snapshot instead of N ad-hoc logs.

Full jitter (delay = uniform(0, min(cap, base * 2**attempt))) is the AWS
architecture-blog shape: it decorrelates a thundering herd of relaunched
workers racing the master after a preemption, which fixed backoff would
re-synchronize every round.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type

from ...framework import flags as _flags

_flags.define_flag("FLAGS_store_retry_max_attempts", 6,
                   "TCPStore connect/op attempts before giving up")
_flags.define_flag("FLAGS_store_retry_base_s", 0.05,
                   "TCPStore retry backoff base (doubles per attempt, full jitter)")
_flags.define_flag("FLAGS_store_retry_max_s", 2.0,
                   "TCPStore retry backoff cap per sleep")
_flags.define_flag("FLAGS_store_retry_deadline_s", 60.0,
                   "overall TCPStore retry budget across attempts")


class RetryError(RuntimeError):
    """All attempts exhausted; `.last` holds the final underlying error."""

    def __init__(self, site: str, attempts: int, elapsed: float, last: BaseException):
        super().__init__(
            f"{site}: gave up after {attempts} attempt(s) in {elapsed:.2f}s: "
            f"{type(last).__name__}: {last}"
        )
        self.site = site
        self.attempts = attempts
        self.elapsed = elapsed
        self.last = last


def backoff_delay(attempt: int, base: float, cap: float,
                  rng: Optional[random.Random] = None) -> float:
    """Full-jitter delay for the given 0-indexed attempt."""
    upper = min(cap, base * (2 ** attempt))
    return (rng or random).uniform(0.0, upper)


def _retry_metrics(site: str):
    from ... import telemetry as _tm

    if not _tm.enabled():
        return None
    labels = {"site": site}
    return (
        _tm.counter("paddle_tpu_retry_attempts_total",
                    "call attempts made under a RetryPolicy", ("site",)).labels(**labels),
        _tm.counter("paddle_tpu_retry_retries_total",
                    "failed attempts that were retried with backoff", ("site",)).labels(**labels),
        _tm.counter("paddle_tpu_retry_giveups_total",
                    "RetryPolicy exhaustions (deadline or attempt budget)", ("site",)).labels(**labels),
    )


@dataclass
class RetryPolicy:
    """Exponential backoff + full jitter + overall deadline.

    `retry_on` bounds which exceptions are transient; anything else
    propagates immediately (a KeyError from the store is a real answer, not
    a flap). `sleep`/`rng` are injectable for deterministic tests.
    """

    max_attempts: int = 6
    base_s: float = 0.05
    max_backoff_s: float = 2.0
    deadline_s: float = 60.0
    retry_on: Tuple[Type[BaseException], ...] = (ConnectionError, TimeoutError, OSError, RuntimeError)
    sleep: Callable[[float], None] = time.sleep
    rng: random.Random = field(default_factory=random.Random)

    def call(self, fn: Callable, *args, site: str = "unnamed", **kwargs):
        """Run `fn` until it returns, retrying transient errors with backoff
        until the attempt budget or the overall deadline runs out."""
        from ...telemetry import timeline as _tl

        metrics = _retry_metrics(site)
        start = time.monotonic()
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.max_attempts)):
            if metrics:
                metrics[0].inc()
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:  # noqa: PERF203 — retry loop
                last = e
            elapsed = time.monotonic() - start
            delay = backoff_delay(attempt, self.base_s, self.max_backoff_s, self.rng)
            if attempt + 1 >= self.max_attempts or elapsed + delay > self.deadline_s:
                break
            if metrics:
                metrics[1].inc()
            # site-labeled observation: an injected store/ckpt fault that a
            # retry absorbed still SURFACES (chaos-coverage match key)
            _tl.emit("resilience", "retry", severity="warn",
                     labels={"site": site}, attempt=attempt + 1,
                     delay_s=round(delay, 6), error=type(last).__name__)
            self.sleep(delay)
        if metrics:
            metrics[2].inc()
        _tl.emit("resilience", "retry.giveup", severity="error",
                 labels={"site": site}, attempts=attempt + 1,
                 elapsed_s=round(time.monotonic() - start, 6),
                 error=type(last).__name__ if last else None)
        raise RetryError(site, attempt + 1, time.monotonic() - start, last) from last


def default_store_policy(**overrides) -> RetryPolicy:
    """RetryPolicy configured from the FLAGS_store_retry_* registry."""
    kw = dict(
        max_attempts=int(_flags.get_flag("FLAGS_store_retry_max_attempts")),
        base_s=float(_flags.get_flag("FLAGS_store_retry_base_s")),
        max_backoff_s=float(_flags.get_flag("FLAGS_store_retry_max_s")),
        deadline_s=float(_flags.get_flag("FLAGS_store_retry_deadline_s")),
    )
    kw.update(overrides)
    return RetryPolicy(**kw)
