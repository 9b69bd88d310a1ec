"""Host-side event recording (counterpart of paddle_tpu/profiler/utils.py).

Reference parity: python/paddle/profiler/utils.py (RecordEvent,
in_profiler_mode) and the host tracer side of
paddle/fluid/platform/profiler/host_tracer.cc. The device side is
torch.profiler's CUDA activity tracer, wired in profiler.py; host events
here capture Python-level spans (dataloader, forward, backward, optimizer,
communication) the way the reference's RecordEvent instruments its loops.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import List, Optional

_state = threading.local()
_global = {
    "enabled": False,
    "events": None,
    "lock": threading.Lock(),
    "start_ns": 0,
    # RecordEvents begun but not yet ended — closed at tracer-disable time so
    # a span straddling the end of the record window is exported, not dropped
    "open": {},
}


class TracerEventType:
    # mirrors paddle/fluid/platform/profiler/trace_event.h enum
    Operator = "Operator"
    Dataloader = "Dataloader"
    ProfileStep = "ProfileStep"
    Forward = "Forward"
    Backward = "Backward"
    Optimization = "Optimization"
    PythonOp = "PythonOp"
    PythonUserDefined = "PythonUserDefined"
    UserDefined = "UserDefined"
    Communication = "Communication"


class HostEvent:
    __slots__ = ("name", "event_type", "start_ns", "end_ns", "tid", "args")

    def __init__(self, name, event_type, start_ns, end_ns, tid, args=None):
        self.name = name
        self.event_type = event_type
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.tid = tid
        self.args = args  # optional dict of span metadata (chrome trace "args")

    @property
    def duration_ns(self):
        return self.end_ns - self.start_ns


def in_profiler_mode():
    return _global["enabled"]


def _enable_host_tracer():
    with _global["lock"]:
        _global["events"] = []
        _global["start_ns"] = time.perf_counter_ns()
        _global["enabled"] = True
        _global["open"] = {}


def _disable_host_tracer() -> List[HostEvent]:
    with _global["lock"]:
        _global["enabled"] = False
        # close spans still open mid-step: the reference host tracer flushes
        # in-flight RecordEvents on stop; dropping them would truncate the
        # last profiled step's export
        now = time.perf_counter_ns()
        for rec in list(_global["open"].values()):
            if rec._begin_ns is not None and _global["events"] is not None:
                _global["events"].append(
                    HostEvent(rec.name, rec.event_type, rec._begin_ns, now,
                              rec._tid or threading.get_ident(), rec.args)
                )
            rec._begin_ns = None
        _global["open"] = {}
        events, _global["events"] = _global["events"], None
    return events or []


class RecordEvent:
    """Context manager / decorator that records a named host span while a
    Profiler is active (python/paddle/profiler/utils.py:RecordEvent)."""

    def __init__(self, name: str, event_type: str = TracerEventType.PythonUserDefined, args: Optional[dict] = None):
        self.name = name
        self.event_type = event_type
        self.args = args
        self._begin_ns: Optional[int] = None
        self._tid: Optional[int] = None

    def begin(self):
        if not _global["enabled"]:
            return
        self._begin_ns = time.perf_counter_ns()
        self._tid = threading.get_ident()
        with _global["lock"]:
            if _global["enabled"]:
                _global["open"][id(self)] = self

    def end(self):
        begin_ns = self._begin_ns
        if begin_ns is None:
            return
        if not _global["enabled"]:
            # tracer already stopped: _disable_host_tracer closed this span
            self._begin_ns = None
            return
        end_ns = time.perf_counter_ns()
        with _global["lock"]:
            # a concurrent disable may have closed this span already — every
            # live span is in `open`, so a missing entry means don't re-emit
            if _global["open"].pop(id(self), None) is not None and _global["events"] is not None:
                _global["events"].append(
                    HostEvent(self.name, self.event_type, begin_ns, end_ns,
                              self._tid or threading.get_ident(), self.args)
                )
        self._begin_ns = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with RecordEvent(self.name, self.event_type):
                return fn(*args, **kwargs)

        return wrapper


def wrap_optimizers():
    """Reference hook point: auto-instrument Optimizer.step under profiling.
    Our RecordEvent is cheap enough that hapi/timer call sites opt in directly."""
    return None
