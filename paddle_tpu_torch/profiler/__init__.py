"""paddle.profiler namespace (counterpart of paddle_tpu/profiler; reference:
python/paddle/profiler/__init__.py)."""
from .profiler import (  # noqa: F401
    Profiler,
    ProfilerState,
    ProfilerTarget,
    SummaryView,
    export_chrome_tracing,
    export_protobuf,
    load_profiler_result,
    make_scheduler,
)
from .profiler_statistic import SortedKeys, StatisticData  # noqa: F401
from .utils import RecordEvent, TracerEventType, in_profiler_mode, wrap_optimizers  # noqa: F401
from .timer import benchmark  # noqa: F401
from . import perf_attribution  # noqa: F401
from . import trace_merge  # noqa: F401
from .perf_attribution import (  # noqa: F401
    annotate_module,
    live_array_census,
    perf_report,
    roofline,
)
from .trace_merge import merge_traces  # noqa: F401

__all__ = [
    "annotate_module",
    "live_array_census",
    "merge_traces",
    "perf_attribution",
    "perf_report",
    "roofline",
    "trace_merge",
    "Profiler",
    "ProfilerState",
    "ProfilerTarget",
    "SummaryView",
    "make_scheduler",
    "export_chrome_tracing",
    "export_protobuf",
    "load_profiler_result",
    "SortedKeys",
    "RecordEvent",
    "TracerEventType",
    "in_profiler_mode",
    "wrap_optimizers",
    "benchmark",
]
