"""paddle.jit: to_static and capture_program (jit/api.py), save, load
and TranslatedLayer (jit/save_load.py)."""
from .api import (StaticFunction, capture_program, enable_to_static, ignore_module,
                  not_to_static, to_static)
from .save_load import TranslatedLayer, load, save

__all__ = ["StaticFunction", "TranslatedLayer", "capture_program", "enable_to_static",
           "ignore_module", "load", "not_to_static", "save", "to_static"]
