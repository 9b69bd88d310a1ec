"""The program serialization names of paddle.static (counterpart of
paddle_tpu/static/extras.py:363-442): a Program's feed->fetch
computation to bytes and back (static/io.py's export), its persistables
to bytes and back, and .pdparams states. The rest of extras.py
(CompiledProgram, BuildStrategy, gradients, Print, ...) is not ported
yet: static/__init__.py makes those names raise, naming ROADMAP Queue A
item 3.5.
"""
from __future__ import annotations

from ..framework import io as fio
from . import io as _io
from .program import Program, default_main_program


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """paddle.static.normalize_program: the program as it is (the export
    prunes to the fetches through the pass pipeline's DCE)."""
    if not isinstance(program, Program):
        raise TypeError("program must be a Program")
    return program


def serialize_program(feed_vars, fetch_vars, **kwargs) -> bytes:
    """The feed->fetch computation as bytes: a `.pdmodel`'s archive."""
    return _io._export_blob(feed_vars, fetch_vars, kwargs.get("program") or default_main_program())


def deserialize_program(data: bytes):
    """serialize_program's bytes -> the ExportedProgram on the framework
    device; call `.module()(*feeds)`. For an Executor-runnable artifact
    use save/load_inference_model, whose .pdmeta names the feeds."""
    return _io._load_blob(data)


def serialize_persistables(feed_vars, fetch_vars, executor=None, **kwargs) -> bytes:
    """The program's persistables as bytes ({key: numpy array})."""
    return fio.dumps(_io.program_state(kwargs.get("program") or default_main_program()))


def deserialize_persistables(program, data: bytes, executor=None):
    """serialize_persistables' bytes back into the program's tensors."""
    state = fio.loads(data)
    set_program_state(program, state)
    return state


def save_to_file(path, content):
    if not isinstance(content, bytes):
        raise ValueError("content must be bytes")
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def load_program_state(model_path, var_list=None) -> dict:
    """A .pdparams state (static.save's, of either package); `var_list`
    keeps the keys it names."""
    state = fio.load(_io._pdparams(model_path))
    if var_list is not None:
        state = {k: v for k, v in state.items() if k in set(var_list)}
    return state


def set_program_state(program, state_dict) -> None:
    """Write a state into the program's persistables by key, in place."""
    _io.set_state(getattr(program, "_program", program), state_dict)


__all__ = ["normalize_program", "serialize_program", "deserialize_program",
           "serialize_persistables", "deserialize_persistables", "save_to_file",
           "load_from_file", "load_program_state", "set_program_state"]
