"""Profiler orchestration over host events and torch.profiler's device
tracer (counterpart of paddle_tpu/profiler/profiler.py).

Reference parity: python/paddle/profiler/profiler.py: `Profiler` (:346)
with the CLOSED/READY/RECORD(_AND_RETURN) state machine (:79),
`make_scheduler`, `export_chrome_tracing` callbacks, and `profiler.step()`
driving the transitions. The JAX package traces the device with
jax.profiler; here a record window on the card runs torch.profiler's
CUDA activity tracer (CUPTI), which sees every kernel of the process,
the hand-written ones launched through ctypes included. Its own chrome
trace is written to the window's `device_trace_dir`, and its device
events join the host spans (utils.RecordEvent) in `export` on one clock.
"""
from __future__ import annotations

import json
import os
import socket
import tempfile
import time
from enum import Enum
from typing import Callable, Iterable, Optional, Union

from .profiler_statistic import SortedKeys, StatisticData, _build_summary_table
from .utils import RecordEvent, TracerEventType, _disable_host_tracer, _enable_host_tracer


class SummaryView(Enum):
    """Summary view selector (reference profiler.py:46); accepted by
    Profiler.summary(views=...) to filter which tables print."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3  # last step of a record window: collect + callback


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2  # accepted for API compat; maps to the card's tracer
    CUSTOM_DEVICE = 3


def make_scheduler(
    *, closed: int, ready: int, record: int, repeat: int = 0, skip_first: int = 0
) -> Callable[[int], ProfilerState]:
    """python/paddle/profiler/profiler.py make_scheduler parity: cycle of
    [closed, ready, record] phases, repeated `repeat` times (0 = forever),
    after skipping `skip_first` steps."""
    if record < 1:
        raise ValueError(f"record must be >= 1, got {record}")
    if closed < 0 or ready < 0 or skip_first < 0 or repeat < 0:
        raise ValueError("closed/ready/skip_first/repeat must be non-negative")
    num_cycle = closed + ready + record

    def getter(step: int) -> ProfilerState:
        assert step >= 0
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        period_index = step // num_cycle
        if repeat > 0 and period_index >= repeat:
            return ProfilerState.CLOSED
        pos = step % num_cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos < num_cycle - 1:
            return ProfilerState.RECORD
        return ProfilerState.RECORD_AND_RETURN

    return getter


def _default_state_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None) -> Callable:
    """on_trace_ready callback writing chrome://tracing JSON per record window."""

    def handle_fn(prof: "Profiler"):
        nonlocal worker_name
        if not worker_name:
            worker_name = f"host_{socket.gethostname()}pid_{os.getpid()}"
        os.makedirs(dir_name, exist_ok=True)
        filename = f"{worker_name}_time_{time.strftime('%Y_%m_%d_%H_%M_%S')}.paddle_trace.json"
        prof.export(os.path.join(dir_name, filename), format="json")

    return handle_fn


def export_protobuf(dir_name: str, worker_name: Optional[str] = None) -> Callable:
    """The reference exports a protobuf; here the chrome JSON (host spans
    and device events) plays that role, with torch.profiler's own trace
    in the window's device_trace_dir."""
    return export_chrome_tracing(dir_name, worker_name)


def _has_cuda() -> bool:
    import torch

    return torch.cuda.is_available()


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_events(trace: dict, unix_minus_perf_us: float, window_start_us: float) -> list:
    """torch.profiler's device events of one exported trace, as chrome
    dicts on the host tracer's clock (perf_counter µs). Its timestamps
    are wall-clock µs, either absolute or relative to
    `baseTimeNanoseconds`; without either, the first event is pinned to
    the window's start."""
    evs = [e for e in trace.get("traceEvents", ())
           if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS and "ts" in e]
    if not evs:
        return []
    base_ns = trace.get("baseTimeNanoseconds")
    ts0 = min(float(e["ts"]) for e in evs)
    if base_ns is not None:
        shift = float(base_ns) / 1e3 - unix_minus_perf_us
    elif ts0 > 1e15:  # absolute unix µs
        shift = -unix_minus_perf_us
    else:
        shift = window_start_us - ts0
    out = []
    for e in evs:
        args = {k: v for k, v in (e.get("args") or {}).items()
                if k in ("grid", "block", "stream", "device", "registers per thread",
                         "shared memory", "bytes")}
        out.append({"name": e.get("name", "?"), "cat": e["cat"], "ts": float(e["ts"]) + shift,
                    "dur": float(e.get("dur", 0.0)), "tid": e.get("tid", 0), "args": args})
    return out


class Profiler:
    """paddle.profiler.Profiler parity (profiler.py:346).

    with Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                  scheduler=(2, 5)) as p:
        for it in loop:
            train_step()
            p.step()
    """

    def __init__(
        self,
        *,
        targets: Optional[Iterable[ProfilerTarget]] = None,
        scheduler: Union[Callable[[int], ProfilerState], tuple, None] = None,
        on_trace_ready: Optional[Callable] = None,
        record_shapes: bool = False,
        profile_memory: bool = False,
        timer_only: bool = False,
        emit_nvtx: bool = False,
        custom_device_types: list = [],
        with_flops: bool = False,
    ):
        if targets is None:
            targets = [ProfilerTarget.CPU]
            if _has_cuda():
                targets.append(ProfilerTarget.GPU)
        self.targets = list(targets)
        self._device_tracing = _has_cuda() and any(
            t in (ProfilerTarget.TPU, ProfilerTarget.GPU, ProfilerTarget.CUSTOM_DEVICE)
            for t in self.targets
        )
        if scheduler is None:
            self._scheduler = _default_state_scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            start = max(start, 0)
            if end <= start:
                raise ValueError(f"scheduler window ({start}, {end}) records no steps")
            self._scheduler = make_scheduler(closed=max(start - 1, 0), ready=min(start, 1),
                                             record=end - start, repeat=1)
        else:
            self._scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self.profiler_result = None
        self._trace_dir = None
        self._torch_prof = None
        self._clock = None  # (perf_counter µs at the window's start, unix - perf µs)
        self._step_record: Optional[RecordEvent] = None
        self._timer = None

    # ---- lifecycle ----
    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self):
        from . import timer as timer_mod

        self._timer = timer_mod.benchmark()
        self._timer.begin()
        if self.timer_only:
            return
        self.current_state = self._scheduler(self.step_num)
        if self.current_state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._start_tracers()
        self._step_record = RecordEvent(f"ProfileStep#{self.step_num}", TracerEventType.ProfileStep)
        self._step_record.begin()

    def stop(self):
        if self._timer is not None:
            self._timer.end()
        if self.timer_only:
            return
        if self._step_record is not None:
            self._step_record.end()
            self._step_record = None
        if self.current_state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._collect()
            if self.on_trace_ready:
                self.on_trace_ready(self)
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: Optional[int] = None):
        if self._timer is not None:
            self._timer.step(num_samples)
        if self.timer_only:
            return
        if self._step_record is not None:
            self._step_record.end()
        prev = self.current_state
        self.step_num += 1
        self.current_state = self._scheduler(self.step_num)
        self._transition(prev, self.current_state)
        self._step_record = RecordEvent(f"ProfileStep#{self.step_num}", TracerEventType.ProfileStep)
        self._step_record.begin()

    def step_info(self, unit=None):
        if self._timer is None:
            return ""
        return self._timer.step_info(unit)

    # ---- state transitions ----
    def _transition(self, prev: ProfilerState, new: ProfilerState):
        recording = prev in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        will_record = new in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if prev == ProfilerState.RECORD_AND_RETURN:
            # window closes at the step boundary: collect + fire callback
            self._collect()
            if self.on_trace_ready:
                self.on_trace_ready(self)
            recording = False
        if will_record and not recording:
            self._start_tracers()
        elif recording and not will_record:
            self._collect()
            if self.on_trace_ready:
                self.on_trace_ready(self)

    def _start_tracers(self):
        _enable_host_tracer()
        self._clock = (time.perf_counter_ns() / 1e3,
                       (time.time_ns() - time.perf_counter_ns()) / 1e3)
        if self._device_tracing and self._torch_prof is None:
            from torch.profiler import ProfilerActivity, profile

            self._trace_dir = os.path.join(
                os.environ.get("PADDLE_TPU_PROFILE_DIR",
                               os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_profile")),
                f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}_{self.step_num}")
            try:
                prof = profile(activities=[ProfilerActivity.CUDA],
                               record_shapes=self.record_shapes,
                               profile_memory=self.profile_memory)
                prof.start()
                self._torch_prof = prof
            except Exception:
                self._torch_prof = None  # tracer busy / unsupported

    def _collect(self):
        events = _disable_host_tracer()
        device_events = []
        prof, self._torch_prof = self._torch_prof, None
        if prof is not None:
            import torch

            torch.cuda.synchronize()
            prof.stop()
            os.makedirs(self._trace_dir, exist_ok=True)
            path = os.path.join(self._trace_dir, "torch_profiler.trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
            start_us, unix_minus_perf_us = self._clock
            device_events = _device_events(trace, unix_minus_perf_us, start_us)
        # snapshot the live-memory census at window close so MemoryView
        # reports the memory state of the steps just profiled
        try:
            from . import perf_attribution as _pa

            census = _pa.live_array_census(set_gauges=False)
        except Exception:
            census = None
        self.profiler_result = StatisticData(
            events, device_trace_dir=self._trace_dir if prof is not None else None,
            memory_census=census, device_events=device_events)

    # ---- reporting ----
    def export(self, path: str, format: str = "json"):
        if self.profiler_result is None:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.profiler_result.to_chrome_trace(), f)

    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail=True, thread_sep=False,
                time_unit="ms", views=None):
        """Print summary tables (reference profiler.py:849). ``views``
        filters which tables print (SummaryView or list of them): the host
        span table for OperatorView/OverView, the device kernel table for
        KernelView/DeviceView/OverView, DistributedView and MemoryView."""
        if self.profiler_result is None:
            return
        from .profiler_statistic import (_build_distributed_table, _build_kernel_table,
                                         _build_memory_table)

        if views is not None and isinstance(views, SummaryView):
            views = [views]
        op_wanted = views is None or bool(
            {SummaryView.OperatorView, SummaryView.OverView}.intersection(views))
        kernel_wanted = views is None or bool(
            {SummaryView.KernelView, SummaryView.DeviceView, SummaryView.OverView}.intersection(
                views))
        dist_wanted = views is None or SummaryView.DistributedView in views
        mem_wanted = views is None or SummaryView.MemoryView in views
        if op_wanted:
            print(_build_summary_table(self.profiler_result, sorted_by=sorted_by,
                                       time_unit=time_unit))
        if kernel_wanted:
            table = _build_kernel_table(self.profiler_result, time_unit=time_unit)
            if table:
                print(table)
        if dist_wanted:
            dist = _build_distributed_table(self.profiler_result, time_unit=time_unit)
            if dist:
                print(dist)
        if mem_wanted and getattr(self.profiler_result, "memory_census", None):
            from . import perf_attribution as _pa

            mem = _build_memory_table(self.profiler_result.memory_census,
                                      watermark=_pa.watermark())
            if mem:
                print(mem)


def load_profiler_result(filename: str):
    with open(filename) as f:
        return json.load(f)
