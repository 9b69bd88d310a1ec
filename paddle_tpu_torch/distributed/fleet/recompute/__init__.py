from .recompute import recompute, recompute_hybrid, recompute_sequential

__all__ = ["recompute", "recompute_hybrid", "recompute_sequential"]
