"""High-level API (counterpart of paddle_tpu/hapi/; reference parity:
python/paddle/hapi/). `hub` waits for a later slice (ROADMAP Queue A item
4b)."""
from . import callbacks  # noqa: F401
from .model import Model  # noqa: F401
from .model_summary import summary  # noqa: F401

__all__ = ["Model", "summary", "callbacks"]
