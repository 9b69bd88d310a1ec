"""paddle.distributed.fleet: the recompute entry points (the rest of fleet
is not ported)."""
from . import utils
from .recompute import recompute, recompute_hybrid, recompute_sequential

__all__ = ["utils", "recompute", "recompute_hybrid", "recompute_sequential"]
