"""The streaming data tier (counterpart of paddle_tpu/io/streaming/):
per-rank sharded iterators over a dp-degree-independent ShardPlan,
host->device prefetch from pinned buffers on a copy stream, mid-epoch
resume from an iterator state_dict, and reader lag as the
`paddle_tpu_input_*` telemetry family, joined with the device-side
attribution into a starved-vs-slow verdict
(`paddle.profiler.perf_report()['input_pipeline']`).
"""
from .sharding import (  # noqa: F401
    MeshDistributedBatchSampler,
    ShardPlan,
    ShardedDataset,
    data_shard_info,
)
from .loader import (  # noqa: F401
    StreamingLoader,
    state_template,
    state_to_tensors,
    tensors_to_state,
)
from . import stats  # noqa: F401

__all__ = [
    "MeshDistributedBatchSampler",
    "ShardPlan",
    "ShardedDataset",
    "StreamingLoader",
    "data_shard_info",
    "state_template",
    "state_to_tensors",
    "tensors_to_state",
    "stats",
]
