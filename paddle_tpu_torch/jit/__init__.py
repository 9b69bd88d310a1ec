"""paddle.jit: to_static (jit/api.py)."""
from .api import StaticFunction, enable_to_static, to_static

__all__ = ["StaticFunction", "enable_to_static", "to_static"]
