"""Resilience primitives (counterpart of paddle_tpu/distributed/resilience).

- `fault_injection` — deterministic `FaultPlan`s: named injection points
  with fail-N-times / delay / corrupt actions, seedable, activatable via
  the `PADDLE_TPU_FAULT_PLAN` env var. The serving replica fleet calls
  them at `fleet.route` / `fleet.tier_route` on every routing decision,
  `fleet.replica_step.<idx>` on every replica tick (a `fail*N` spec kills
  one replica deterministically mid-decode, a `delay` spec trips the
  heartbeat breaker) and `fleet.kv_migrate.<src>.<dst>` on every KV
  handoff, so chaos tests drive the real failure handling.
- `retry` — `RetryPolicy`: exponential backoff with full jitter under an
  overall deadline, publishing per-site attempt/giveup counters into the
  telemetry registry. Its TCPStore users arrive with the distributed
  runtime.
"""
from .fault_injection import (  # noqa: F401
    FaultAction,
    FaultInjected,
    FaultPlan,
    clear_plan,
    corrupt_file,
    corrupt_value,
    current_plan,
    fault_point,
    install_plan,
    plan_from_spec,
)
from .retry import (  # noqa: F401
    RetryError,
    RetryPolicy,
    backoff_delay,
    default_store_policy,
)

__all__ = [
    "FaultAction",
    "FaultInjected",
    "FaultPlan",
    "install_plan",
    "clear_plan",
    "current_plan",
    "plan_from_spec",
    "fault_point",
    "corrupt_file",
    "corrupt_value",
    "RetryPolicy",
    "RetryError",
    "backoff_delay",
    "default_store_policy",
]
