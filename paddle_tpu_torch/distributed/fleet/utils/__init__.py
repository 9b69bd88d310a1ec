"""paddle.distributed.fleet.utils: `recompute` and `recompute_sequential`
(the file-system clients and DistributedInfer are not ported)."""
from ..recompute.recompute import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
