"""jit.save / jit.load and TranslatedLayer (counterpart of
paddle_tpu/jit/save_load.py).

`save(layer, path, input_spec)` puts the layer in eval mode and exports
its forward with torch.export (static/io.py `export_module`: a -1 dim
of an InputSpec stays symbolic), then writes
  path.pdmodel   — the ExportedProgram archive, weights inside;
  path.pdiparams — the state_dict through framework/io.py (paddle's
                   layout, so the JAX package reads it too);
  path.pdmeta    — JSON: input shapes and dtypes, the output count and
                   the output tree (`torch.utils._pytree.treespec_dumps`).
`load(path)` gives a TranslatedLayer that runs the artifact on the
framework device without the original class. A flash attention in the
forward is the registered op `paddle_tpu_torch.flash_fwd` in the graph,
so the artifact launches the kernel B1 on the card wherever it was
traced.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..framework import device as _device
from ..framework import dtype as _dtype
from ..framework import io as fio
from ..framework.io import numpy_to_tensor
from ..nn.layer import Layer
from ..static import io as sio


class _Forward(torch.nn.Module):
    """`fn(*inputs)` as a module whose forward takes `*inputs` (a Layer's
    forward keeps its Layer as a submodule, so its weights are state)."""

    def __init__(self, fn):
        super().__init__()
        if isinstance(fn, torch.nn.Module):
            self.layer = fn
        else:
            self._fn = fn

    def forward(self, *inputs):
        return (self.layer if hasattr(self, "layer") else self._fn)(*inputs)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _examples(input_spec, device):
    """(example tensors, dynamic dims per input, meta shapes): an
    InputSpec's -1/None dims become example size 2 (sizes 0 and 1
    specialise) and the meta's "d{i}" names; a tensor is its own example."""
    from ..static import InputSpec

    examples, dynamic, shapes = [], [], []
    n_sym = 0
    for s in input_spec:
        if isinstance(s, InputSpec):
            dims, shape, meta = [], [], []
            for i, d in enumerate(s.shape):
                if d in (-1, None):
                    dims.append(i)
                    shape.append(2)
                    meta.append(f"d{n_sym}")
                    n_sym += 1
                else:
                    shape.append(int(d))
                    meta.append(int(d))
            examples.append(torch.zeros(shape, dtype=_dtype.convert_dtype(s.dtype),
                                        device=device))
            dynamic.append(dims)
            shapes.append(meta)
        elif isinstance(s, torch.Tensor):
            examples.append(s.detach().to(device))
            dynamic.append([])
            shapes.append(list(s.shape))
        else:
            raise TypeError(f"input_spec entries must be InputSpec or Tensor, got {type(s)}")
    return examples, dynamic, shapes


def save(layer, path, input_spec=None, **configs):
    """Export `layer.forward` (or a plain function) for inference.
    input_spec: static.InputSpec entries or example tensors, on the
    device of the layer's parameters (the framework device for a
    function)."""
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (shapes to export for)")
    if isinstance(layer, torch.nn.Module):
        layer.eval()
        device = next((p.device for p in layer.parameters()), _device.resolve(None))
    else:
        device = _device.resolve(None)
    examples, dynamic, shapes = _examples(input_spec, device)
    ep = sio.export_module(_Forward(layer), examples, dynamic)
    out_spec = ep.call_spec.out_spec
    meta = {
        "in_shapes": shapes,
        "in_dtypes": [_dtype_name(e.dtype) for e in examples],
        "n_outputs": out_spec.num_leaves,
        "out_tree": pytree.treespec_dumps(out_spec),
    }
    sio.write_artifact(path, ep, meta)
    if isinstance(layer, torch.nn.Module):
        fio.save(layer.state_dict(), path + ".pdiparams")
    return path


def load_state(path: str) -> dict:
    """A `.pdiparams` of either package as a state of tensors."""
    return {k: v if isinstance(v, torch.Tensor) else numpy_to_tensor(np.asarray(v))
            for k, v in fio.load(path).items()}


class TranslatedLayer(Layer):
    """A loaded inference program, callable like the Layer it came from
    (paddle's jit/translated_layer.py). It runs on the device it was
    loaded for; its outputs keep the saved forward's structure."""

    def __init__(self, ep, meta, state_dict, device):
        super().__init__()
        self._exported = ep
        # not a submodule: an exported module refuses train()/eval()
        object.__setattr__(self, "_module", ep.module())
        self._meta = meta
        self._loaded_state = state_dict or {}
        self._device = device

    def forward(self, *inputs):
        args = [(i if isinstance(i, torch.Tensor) else numpy_to_tensor(np.asarray(i)))
                .to(self._device) for i in inputs]
        with torch.no_grad():  # a frozen program: its outputs carry no gradient
            return self._module(*args)

    def state_dict(self, *args, **kwargs):
        return dict(self._loaded_state)

    @property
    def input_shapes(self):
        return self._meta.get("in_shapes")

    @property
    def program(self):
        """The ExportedProgram this layer runs."""
        return self._exported


def load(path, **configs) -> TranslatedLayer:
    """jit.load: the artifact jit.save wrote, on the framework device
    (`set_device`)."""
    dev = _device.resolve(None)
    ep, meta = sio.read_artifact(path + ".pdmodel", path, dev)
    state = load_state(path + ".pdiparams") if os.path.exists(path + ".pdiparams") else None
    return TranslatedLayer(ep, meta, state, dev)
