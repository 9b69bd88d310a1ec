"""Adam and AdamW, with the flat-bucket fused engine behind
FLAGS_fused_optimizer (fused_engine.py)."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW"]
