"""paddle.jit: to_static and capture_program (jit/api.py)."""
from .api import StaticFunction, capture_program, enable_to_static, to_static

__all__ = ["StaticFunction", "capture_program", "enable_to_static", "to_static"]
