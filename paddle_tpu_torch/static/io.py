"""save/load_inference_model and static.save/load (counterpart of
paddle_tpu/static/io.py), and the artifact format that jit.save and the
inference Predictor share.

The JAX package freezes a Program to StableHLO through `jax.export`,
weights baked in as constants. Here the frozen form is a
`torch.export.ExportedProgram` of the Program's replay from feeds to
fetches, written with `torch.export.save`: the persistables are the
module's buffers, so the weights travel inside the `.pdmodel` archive.
The port's hand-written kernels are registered ops
(`torch.ops.paddle_tpu_torch.flash_fwd`, `rms_norm_fwd`), so the graph
names them and each picks its implementation by device when the
artifact runs: an artifact traced on the CPU still launches the CUDA
kernel on the card. A declared -1 feed dim is a `torch.export.Dim`; the
export fails, naming the input, if the program fixes such a dim.

Files: `prefix.pdmodel` (the archive) and `prefix.pdmeta` (JSON: the
JAX package's keys, no pickled code). Artifacts do not cross packages:
the JAX package's `.pdmodel` is StableHLO bytes, and reading one here
raises ArtifactFormatError. Weights do cross (`.pdparams`/`.pdiparams`
through framework/io.py).
"""
from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np
import torch
import torch.export.passes
from torch.fx.experimental.symbolic_shapes import is_concrete_int

from ..core import record, state
from ..framework import device as _device
from ..framework import io as fio
from ..framework.io import numpy_to_tensor, tensor_to_numpy
from .program import Program, default_main_program


class ArtifactFormatError(ValueError):
    """A `.pdmodel`/`.pdmeta` that is not the port's artifact (the JAX
    package's StableHLO bytes and pickled meta among them)."""


# ---------------------------------------------------------------------------
# the artifact: an ExportedProgram archive and its JSON meta
# ---------------------------------------------------------------------------

def export_module(module, examples, dynamic_dims):
    """torch.export of `module(*examples)` (a module whose forward takes
    `*inputs`) with recording suspended and autograd off (the graph holds
    inference ops only). `dynamic_dims[i]`
    lists the dims of input i declared -1: each is a `Dim.AUTO` (equal
    dims of several inputs are found by the trace), and the export raises
    if the traced program fixed one of them."""
    dyn = tuple({d: torch.export.Dim.AUTO for d in dims} or None for dims in dynamic_dims)
    prev = state.set_program_capture(None)
    try:
        with record.suspended(), torch.no_grad():
            ep = torch.export.export(module, tuple(examples), dynamic_shapes=(dyn,),
                                     strict=False)
    finally:
        state.set_program_capture(prev)
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    user_inputs = [n for n, s in zip(placeholders, ep.graph_signature.input_specs)
                   if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    for i, (node, dims) in enumerate(zip(user_inputs, dynamic_dims)):
        shape = node.meta["val"].shape
        fixed = [d for d in dims if is_concrete_int(shape[d])]
        if fixed:
            raise ValueError(
                f"export: input {i} declares dims {fixed} dynamic (-1), but the traced program "
                f"fixes them to {[shape[d] for d in fixed]}: a literal of that size was recorded")
    return ep


def graph_ops(ep) -> list:
    """The call targets of an exported graph (an ExportedProgram or its
    module), in order (`paddle_tpu_torch.flash_fwd.default` for the flash
    kernel B1)."""
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


def write_artifact(prefix: str, ep, meta: dict) -> None:
    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(prefix + ".pdmodel", "wb") as f:
        torch.export.save(ep, f)
    with open(prefix + ".pdmeta", "w") as f:
        json.dump(meta, f)


def _load_program(f, what: str):
    """torch.export.load of an open binary file or buffer."""
    if not zipfile.is_zipfile(f):
        raise ArtifactFormatError(
            f"{what} is not a paddle_tpu_torch artifact (a torch.export archive); a .pdmodel of "
            "the JAX package holds StableHLO bytes, which the port does not run: export the model "
            "again with paddle_tpu_torch (its weights load through utils/convert.py)")
    f.seek(0)
    return torch.export.load(f)


def read_meta(prefix: str) -> dict:
    path = prefix + ".pdmeta"
    try:
        with open(path) as f:
            return json.load(f)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ArtifactFormatError(
            f"{path} is not a paddle_tpu_torch meta file (JSON); the JAX package writes a "
            "pickle there") from e


def read_artifact(prog_file: str, meta_prefix: str, device):
    """(ExportedProgram on `device`, meta). An artifact saved on another
    device is moved (its weights and the device literals its graph holds,
    `torch.export.passes.move_to_device_pass`)."""
    meta = read_meta(meta_prefix)
    with open(prog_file, "rb") as f:
        return _moved(_load_program(f, prog_file), device), meta


def _moved(ep, device):
    return torch.export.passes.move_to_device_pass(ep, str(device))


# ---------------------------------------------------------------------------
# Program -> artifact
# ---------------------------------------------------------------------------

class _ProgramReplay(torch.nn.Module):
    """A Program's replay from feeds to fetches as a module for
    torch.export; the program's persistables are its buffers, so the
    exported archive carries them."""

    def __init__(self, work: Program, feed_ids, fetch_ids):
        super().__init__()
        self._work = work
        self._feed_ids = list(feed_ids)
        self._fetch_ids = list(fetch_ids)
        self._n_params = len(work.param_vars)
        for i, vid in enumerate(work.param_vars):
            self.register_buffer(f"p{i}", work._var_tensors[vid].detach())

    def forward(self, *feeds):
        params = [getattr(self, f"p{i}") for i in range(self._n_params)]
        env = self._work.replay_env(dict(zip(self._feed_ids, feeds)), params,
                                    keep=set(self._fetch_ids))
        return tuple(env[v] for v in self._fetch_ids)


def _export_program(feed_vars, fetch_vars, program):
    """Export the feed->fetch computation of `program`: the verifier, then
    the default pass pipeline on a clone (so `fuse_attention` puts B1 into
    the artifact), then torch.export of the replay. A declared -1 feed dim
    stays symbolic (example size 2: sizes 0 and 1 specialise). Shared by
    save_inference_model and serialize_program. Returns (ep, feed_names)."""
    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) else [feed_vars]
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) else [fetch_vars]
    feed_ids, feed_names = [], []
    for fv in feed_vars:
        vid = program._id2var.get(id(fv))
        if vid is None or vid not in program.feed_vars.values():
            raise ValueError("feed_vars must be static.data placeholders of this program")
        feed_ids.append(vid)
        feed_names.append(program.var_name(vid))
    fetch_ids = []
    for fv in fetch_vars:
        vid = program._id2var.get(id(fv))
        if vid is None:
            raise ValueError("fetch_vars must be outputs of this program")
        fetch_ids.append(vid)

    from . import passes as _passes
    from .analysis import verifier as _verifier

    if _verifier.verify_enabled():
        _verifier.verify(program, feed_names=feed_names, fetch_vars=fetch_ids)
    work = program
    if _passes.pipeline_enabled():
        work, _result = _passes.run_default_pipeline(program, fetch_vars=fetch_ids,
                                                     feed_names=feed_names)
    examples, dynamic = [], []
    for name, vid in zip(feed_names, feed_ids):
        t = program._var_tensors[vid]
        declared = program.feed_shapes.get(name) or tuple(t.shape)
        dims = [i for i, d in enumerate(declared) if d in (-1, None)]
        shape = [2 if i in dims else int(d) for i, d in enumerate(declared)]
        examples.append(torch.zeros(shape, dtype=t.dtype, device=t.device))
        dynamic.append(dims)
    ep = export_module(_ProgramReplay(work, feed_ids, fetch_ids), examples, dynamic)
    return ep, feed_names


class _InferenceProgram:
    """What load_inference_model returns; Executor.run dispatches to
    `_run`. It runs on the framework device."""

    def __init__(self, ep, feed_names, n_fetch, device):
        self._module = ep.module()
        self.feed_names = list(feed_names)
        self.n_fetch = int(n_fetch)
        self._device = device

    def _run(self, feed, return_numpy=True):
        args = []
        for n in self.feed_names:
            v = feed[n]
            t = v if isinstance(v, torch.Tensor) else numpy_to_tensor(np.asarray(v))
            args.append(t.to(self._device))
        with torch.no_grad():  # a frozen program: its outputs carry no gradient
            outs = self._module(*args)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        return [tensor_to_numpy(o) for o in outs] if return_numpy else outs


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None, program=None,
                         **kwargs):
    """Freeze `program` (default: the current main program) to
    `path_prefix.pdmodel` (the exported program, weights inside) and
    `.pdmeta` (feed names, fetch count)."""
    program = program or default_main_program()
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) else [fetch_vars]
    ep, feed_names = _export_program(feed_vars, fetch_vars, program)
    write_artifact(path_prefix, ep, {"feed_names": feed_names, "n_fetch": len(fetch_vars)})
    return path_prefix


def load_inference_model(path_prefix, executor=None, **kwargs):
    """[program, feed_target_names, fetch_targets], as paddle returns
    them; fetch_targets are positional indices (the artifact is a frozen
    function, not a mutable graph) and `Executor.run` runs the program on
    the framework device."""
    dev = _device.resolve(None)
    ep, meta = read_artifact(path_prefix + ".pdmodel", path_prefix, dev)
    prog = _InferenceProgram(ep, meta["feed_names"], meta["n_fetch"], dev)
    return [prog, list(meta["feed_names"]), list(range(meta["n_fetch"]))]


def _export_blob(feed_vars, fetch_vars, program) -> bytes:
    """The feed->fetch computation of `program` as the bytes of a
    `.pdmodel` (serialize_program's format)."""
    buf = io.BytesIO()
    torch.export.save(_export_program(feed_vars, fetch_vars, program)[0], buf)
    return buf.getvalue()


def _load_blob(data: bytes):
    """An ExportedProgram on the framework device from `_export_blob`'s bytes."""
    return _moved(_load_program(io.BytesIO(data), "the serialized program"),
                  _device.resolve(None))


# ---------------------------------------------------------------------------
# persistables
# ---------------------------------------------------------------------------

def named_program_params(program):
    """(key, tensor) for every persistable of `program`: the one naming
    rule that save/load/serialize share (the var's name, or param_{i})."""
    for i, vid in enumerate(program.param_vars):
        yield (program.var_name(vid) or f"param_{i}"), program._var_tensors[vid]


def program_state(program) -> dict:
    """{key: numpy array} of the program's persistables (bf16 as the
    JAX package's ml_dtypes arrays, written without ml_dtypes)."""
    return {k: fio.host_array(t) for k, t in named_program_params(program)}


def set_state(program, state_dict, keys=None) -> None:
    """Write arrays of `state_dict` into the program's persistables by key
    (only `keys` where given), in place, in each tensor's dtype and device."""
    with torch.no_grad():
        for key, t in named_program_params(program):
            if key in state_dict and (keys is None or key in keys):
                v = state_dict[key]
                v = v if isinstance(v, torch.Tensor) else numpy_to_tensor(v)
                t.copy_(v.to(t.device, t.dtype))


def _pdparams(model_path):
    return model_path if model_path.endswith(".pdparams") else model_path + ".pdparams"


def save(program, model_path, protocol=4, **configs):
    """paddle.static.save: the program's persistables to
    `model_path.pdparams` ({key: numpy array}, the JAX package's layout)."""
    path = _pdparams(model_path)
    fio.save(program_state(program), path, protocol=protocol)
    return path


def load(program, model_path, executor=None, var_list=None):
    """paddle.static.load: persistables saved by static.save (by either
    package) back into the program's tensors. `var_list` entries are
    tensors (matched by identity or name) or key strings."""
    state_dict = fio.load(_pdparams(model_path), return_numpy=False)
    keys = None
    if var_list is not None:
        ids = {id(v) for v in var_list if not isinstance(v, str)}
        keys = {v for v in var_list if isinstance(v, str)}
        keys |= {k for k, t in named_program_params(program) if id(t) in ids}
    set_state(program, state_dict, keys)
