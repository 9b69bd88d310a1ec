"""Input-pipeline observability: the `paddle_tpu_input_*` metric family
(counterpart of paddle_tpu/io/streaming/stats.py, on the port's telemetry).

One process-global accumulator every input path feeds — the streaming
loader, the classic DataLoader's Benchmark timer hooks, and bench configs —
so "how long did training wait for data" has a single source of truth:

- ``observe_wait`` / ``observe_h2d`` / ``observe_batch`` publish per-event
  histograms/counters into the telemetry registry (labelled by ``source``)
  and accumulate process totals.
- ``take_step_wait`` is the training-loop boundary: the guardian calls it
  once per step and records the returned wait as the flight recorder's
  ``input_wait_s`` field. The call also closes a (step wall, step wait)
  window sample, which is exactly the join the starved-vs-slow verdict
  needs: wait is measured by the input pipeline, wall by the step cadence.
- ``starvation_verdict`` turns the rolling window into a verdict —
  "starved" means the host failed to hide data behind device compute and
  the device-side attribution (perf_report's programs) CANNOT explain the
  step time; "compute" means the device is the bottleneck and the roofline
  records can.

Everything degrades to no-ops when telemetry is disabled except the step
window (a deque of floats), which ``perf_report()`` reads explicitly.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from ... import telemetry as _tm

# finer buckets at the sub-millisecond end than the registry default:
# a healthy prefetched pipeline waits ~0, and the interesting signal is
# the transition from "tens of microseconds" to "milliseconds"
WAIT_BUCKETS = (
    1e-5, 5e-5, 1e-4, 5e-4, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# starved-vs-slow thresholds on the windowed wait fraction (wait / wall):
# >= STARVED the pipeline is the bottleneck; >= LIMITED it is eating a
# visible slice of the step; below that the device is the story
STARVED_FRACTION = 0.30
LIMITED_FRACTION = 0.10
_WINDOW = 64  # steps in the rolling starved-vs-slow window


class _InputStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.wait_seconds_total = 0.0
        self.h2d_seconds_total = 0.0
        self.batches_total = 0
        self.samples_total = 0
        self._wait_since_take = 0.0
        self._waits_seen = False
        self._last_take_t: Optional[float] = None
        # rolling (step_wall_s, step_wait_s) samples closed by take_step_wait
        self._window: deque = deque(maxlen=_WINDOW)
        # per-SOURCE samples/s accumulators: source -> [window_t0, samples]
        # (one shared accumulator would publish the combined rate under
        # whichever source happens to cross the 1-second boundary)
        self._rates: dict = {}

    def reset(self):
        with self._lock:
            self.wait_seconds_total = 0.0
            self.h2d_seconds_total = 0.0
            self.batches_total = 0
            self.samples_total = 0
            self._wait_since_take = 0.0
            self._waits_seen = False
            self._last_take_t = None
            self._window.clear()
            self._rates.clear()


_stats = _InputStats()


def observe_wait(seconds: float, source: str = "streaming") -> None:
    """One consumer-side wait-for-batch measurement (time blocked in
    ``__next__`` before a batch was available)."""
    seconds = float(seconds)
    with _stats._lock:
        _stats.wait_seconds_total += seconds
        _stats._wait_since_take += seconds
        _stats._waits_seen = True
    if _tm.enabled():
        _tm.histogram(
            "paddle_tpu_input_wait_seconds",
            "time the consumer waited for the next input batch",
            ("source",), buckets=WAIT_BUCKETS,
        ).labels(source=source).observe(seconds)


def observe_h2d(seconds: float, source: str = "streaming") -> None:
    """One host->device transfer (the copy's dispatch) measurement."""
    seconds = float(seconds)
    with _stats._lock:
        _stats.h2d_seconds_total += seconds
    if _tm.enabled():
        _tm.histogram(
            "paddle_tpu_input_h2d_seconds",
            "host->device copy dispatch time per batch",
            ("source",), buckets=WAIT_BUCKETS,
        ).labels(source=source).observe(seconds)


def observe_batch(n_samples: int, source: str = "streaming") -> None:
    """One delivered batch of `n_samples`; keeps the samples/s gauge live."""
    n_samples = int(n_samples)
    now = time.monotonic()
    rate = None
    with _stats._lock:
        _stats.batches_total += 1
        _stats.samples_total += n_samples
        acc = _stats._rates.setdefault(source, [now, 0])
        acc[1] += n_samples
        dt = now - acc[0]
        if dt >= 1.0:  # publish at most ~1/s; gauges want a rate, not noise
            rate = acc[1] / dt
            acc[0] = now
            acc[1] = 0
    if _tm.enabled():
        _tm.counter(
            "paddle_tpu_input_batches_total",
            "input batches delivered to the consumer", ("source",),
        ).labels(source=source).inc()
        _tm.counter(
            "paddle_tpu_input_samples_total",
            "input samples delivered to the consumer", ("source",),
        ).labels(source=source).inc(n_samples)
        if rate is not None:
            _tm.gauge(
                "paddle_tpu_input_samples_per_sec",
                "delivered input samples per second (rolling)", ("source",),
            ).labels(source=source).set(rate)


def set_queue_depth(depth: int, capacity: int, source: str = "streaming") -> None:
    """Publish the prefetch ring's current fill + capacity."""
    if _tm.enabled():
        _tm.gauge(
            "paddle_tpu_input_queue_depth",
            "prefetch ring fill (batches ready for the consumer)", ("source",),
        ).labels(source=source).set(int(depth))
        _tm.gauge(
            "paddle_tpu_input_queue_capacity",
            "prefetch ring capacity (batches)", ("source",),
        ).labels(source=source).set(int(capacity))


def take_step_wait() -> Optional[float]:
    """Wait accumulated since the previous call — the per-step
    ``input_wait_s`` the guardian records. Also closes one (wall, wait)
    window sample for the starved-vs-slow verdict. Returns None when no
    input pipeline has reported any wait yet (so a loader-less training
    loop records nothing instead of a misleading 0.0)."""
    now = time.monotonic()
    with _stats._lock:
        if not _stats._waits_seen:
            _stats._last_take_t = now
            return None
        wait = _stats._wait_since_take
        _stats._wait_since_take = 0.0
        if _stats._last_take_t is not None:
            wall = now - _stats._last_take_t
            if wall > 0:
                _stats._window.append((wall, wait))
        _stats._last_take_t = now
    return wait


def starvation_verdict() -> dict:
    """The starved-vs-slow join over the rolling step window.

    verdict: "starved" (input pipeline is the bottleneck: device-side
    attribution cannot explain the step time), "input_limited" (visible but
    not dominant wait), "compute" (the device is the story — see the
    roofline records), "no_data" (no step window closed yet).
    """
    with _stats._lock:
        window = list(_stats._window)
        waits_seen = _stats._waits_seen
    if not window:
        return {
            "verdict": "no_data" if not waits_seen else "unattributed",
            "steps": 0,
            "wait_fraction": None,
            "note": ("no training step closed a window yet; call "
                     "telemetry-guarded take_step_wait() once per step "
                     "(TrainingGuardian does)"),
        }
    wall = sum(w for w, _ in window)
    wait = sum(x for _, x in window)
    frac = wait / wall if wall > 0 else 0.0
    if frac >= STARVED_FRACTION:
        verdict = "starved"
    elif frac >= LIMITED_FRACTION:
        verdict = "input_limited"
    else:
        verdict = "compute"
    return {
        "verdict": verdict,
        "steps": len(window),
        "step_wall_s": wall,
        "input_wait_s": wait,
        "wait_fraction": frac,
        "thresholds": {"starved": STARVED_FRACTION,
                       "input_limited": LIMITED_FRACTION},
    }


def summary() -> dict:
    """Process-lifetime totals + the current verdict (feeds
    ``perf_report()['input_pipeline']``)."""
    with _stats._lock:
        out = {
            "wait_seconds_total": _stats.wait_seconds_total,
            "h2d_seconds_total": _stats.h2d_seconds_total,
            "batches_total": _stats.batches_total,
            "samples_total": _stats.samples_total,
        }
    out.update(starvation_verdict())
    return out


def reset() -> None:
    """Clear totals and the step window (tests)."""
    _stats.reset()
