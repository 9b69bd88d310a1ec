"""SGD, Momentum, Adam and AdamW (Adam/AdamW with the flat-bucket fused
engine behind FLAGS_fused_optimizer; param groups and state dicts in the
JAX package's format), and the LR schedulers (lr.py)."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
