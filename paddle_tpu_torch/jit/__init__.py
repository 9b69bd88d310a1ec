"""paddle.jit: to_static, capture_program and cond (jit/api.py), save,
load and TranslatedLayer (jit/save_load.py), and the dy2static logging
switches."""
from .api import (StaticFunction, capture_program, cond, enable_to_static, ignore_module,
                  not_to_static, to_static)
from .save_load import TranslatedLayer, load, save

_VERBOSITY = [0]
_CODE_LEVEL = [0]


def set_verbosity(level=0, also_to_stdout=False):
    """dy2static's transform log level; kept and read by nothing (the
    port's to_static transforms no code)."""
    _VERBOSITY[0] = int(level)


def set_code_level(level=100, also_to_stdout=False):
    """dy2static's transformed-code dump level; kept and read by nothing."""
    _CODE_LEVEL[0] = int(level)


__all__ = ["StaticFunction", "TranslatedLayer", "capture_program", "cond", "enable_to_static",
           "ignore_module", "load", "not_to_static", "save", "set_code_level", "set_verbosity",
           "to_static"]
