"""Throughput benchmark hooks (counterpart of paddle_tpu/profiler/timer.py).

Reference parity: python/paddle/profiler/timer.py: the `benchmark()`
singleton with begin/step/end driven by Profiler (or directly by training
loops); reports reader cost, batch cost and ips (items/sec) with warm-up
steps discarded, as the reference's hapi/fleet logs do.
"""
from __future__ import annotations

import time


class Stat:
    def __init__(self, skip_n=10):
        self.reset()
        self.skip_n = skip_n  # discard first steps: compile + warmup

    def reset(self):
        self.total = 0.0
        self.count = 0
        self.skipped = 0

    def update(self, v):
        if self.skipped < self.skip_n:
            self.skipped += 1
            return
        self.total += v
        self.count += 1

    @property
    def avg(self):
        return self.total / self.count if self.count else 0.0


class Benchmark:
    def __init__(self):
        self.reader_cost = Stat()
        self.batch_cost = Stat()
        self.ips_stat = Stat()
        self._last_step_t = None
        self._reader_t = None
        self.num_samples = None
        self.running = False

    def begin(self):
        # fresh window: the singleton is shared across Profiler runs, so each
        # begin() discards the previous run's accumulated stats
        self.reader_cost.reset()
        self.batch_cost.reset()
        self.ips_stat.reset()
        self.running = True
        self._last_step_t = time.perf_counter()

    def before_reader(self):
        self._reader_t = time.perf_counter()

    def after_reader(self):
        if self._reader_t is not None:
            dt = time.perf_counter() - self._reader_t
            self.reader_cost.update(dt)
            self._reader_t = None
            # every reader wait also lands in the paddle_tpu_input_* family
            # (io.streaming.stats), so Benchmark users and StreamingLoader
            # users feed the same dashboards, and the guardian's per-step
            # input_wait_s sees this path too
            try:
                from ..io.streaming import stats as _instats

                _instats.observe_wait(dt, source="benchmark")
            except Exception:
                pass

    def step(self, num_samples=None):
        if not self.running:
            return
        now = time.perf_counter()
        dt = now - self._last_step_t
        self._last_step_t = now
        self.batch_cost.update(dt)
        self.num_samples = num_samples
        if num_samples is not None and dt > 0:
            self.ips_stat.update(num_samples / dt)
        self._publish_gauges()

    def _publish_gauges(self):
        """Mirror the running averages into the telemetry registry so step
        time / reader cost / ips are scrapeable alongside the other runtime
        metrics (the role of the reference's fleet metric reporters).

        The `paddle_tpu_input_*` family (source="benchmark") is the source
        of truth for samples/s; the `paddle_tpu_benchmark_*` gauges carry
        the same values under the older names, as in the JAX package."""
        from .. import telemetry as _tm

        if not _tm.enabled():
            return
        if self.ips_stat.count:
            try:
                _tm.gauge(
                    "paddle_tpu_input_samples_per_sec",
                    "delivered input samples per second (rolling)", ("source",),
                ).labels(source="benchmark").set(self.ips_stat.avg)
            except Exception:
                pass
        # ---- deprecated names (shim over the paddle_tpu_input_* family) ----
        _tm.gauge(
            "paddle_tpu_benchmark_reader_cost_seconds",
            "DEPRECATED: avg dataloader wait per step — read "
            "paddle_tpu_input_wait_seconds{source='benchmark'} instead",
        ).set(self.reader_cost.avg)
        _tm.gauge(
            "paddle_tpu_benchmark_batch_cost_seconds",
            "avg step wall time (post-warmup)",
        ).set(self.batch_cost.avg)
        if self.ips_stat.count:
            _tm.gauge(
                "paddle_tpu_benchmark_ips",
                "DEPRECATED: avg items/sec — read "
                "paddle_tpu_input_samples_per_sec{source='benchmark'} instead",
            ).set(self.ips_stat.avg)

    def end(self):
        self.running = False

    def step_info(self, unit=None):
        msg = f"reader_cost: {self.reader_cost.avg:.5f} s, batch_cost: {self.batch_cost.avg:.5f} s"
        if self.ips_stat.count:
            u = unit or "samples/sec"
            msg += f", ips: {self.ips_stat.avg:.5f} {u}"
        return msg


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    return _benchmark
