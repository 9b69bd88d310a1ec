"""paddle.distributed (counterpart of paddle_tpu/distributed): activation
recompute (`recompute`, also as `fleet.utils.recompute`) and the
resilience primitives (`resilience`: fault injection, retry); collectives,
meshes and fleet's parallel layers are later work."""
from . import fleet, resilience
from .fleet.recompute import recompute

__all__ = ["fleet", "recompute", "resilience"]
