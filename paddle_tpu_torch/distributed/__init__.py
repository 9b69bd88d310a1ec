"""paddle.distributed (counterpart of paddle_tpu/distributed): only
activation recompute is ported (`recompute`, also as
`fleet.utils.recompute`); collectives, meshes and fleet's parallel
layers are later work."""
from . import fleet
from .fleet.recompute import recompute

__all__ = ["fleet", "recompute"]
