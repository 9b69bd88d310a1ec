"""Layer summary table (counterpart of paddle_tpu/hapi/model_summary.py).

Reference parity: python/paddle/hapi/model_summary.py: `paddle.summary(net,
input_size)` prints a per-layer table (name, output shape, param count) via
forward post hooks and returns {'total_params', 'trainable_params'}. The
dry run's zeros lie on the device of the net's parameters.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..framework import device as _device
from ..framework.dtype import convert_dtype
from ..nn.layer import Layer


def _normalize_sizes(input_size):
    # accept (shape), [(shape), ...], InputSpec, [InputSpec, ...]
    if hasattr(input_size, "shape"):
        return [tuple(input_size.shape)]
    if isinstance(input_size, tuple) and all(isinstance(d, int) for d in input_size):
        return [input_size]
    if isinstance(input_size, list) and input_size and all(isinstance(d, int) for d in input_size):
        return [tuple(input_size)]
    out = []
    for s in input_size:
        out.extend(_normalize_sizes(s))
    return out


def _shape_of(out):
    if isinstance(out, torch.Tensor):
        return list(out.shape)
    if isinstance(out, (list, tuple)):
        return [_shape_of(o) for o in out]
    return []


def summary(net: Layer, input_size=None, dtypes=None, input=None):
    sizes = None
    if input is None:
        sizes = _normalize_sizes(input_size)
        # batch dim of -1 (InputSpec convention) becomes 1 for the dry run
        sizes = [tuple(1 if d in (-1, None) else d for d in s) for s in sizes]
        if dtypes is None:
            dtypes = ["float32"] * len(sizes)
        elif isinstance(dtypes, str):
            dtypes = [dtypes] * len(sizes)
        dev = next((p.device for p in net.parameters()), None) or _device.current_device()
        # bfloat16 dry runs take f32 zeros, as the JAX package's do
        inputs = [torch.zeros(s, dtype=torch.float32 if d == "bfloat16" else convert_dtype(d),
                              device=dev) for s, d in zip(sizes, dtypes)]
    else:
        inputs = input if isinstance(input, (list, tuple)) else [input]

    stats = OrderedDict()
    hooks = []
    counted = set()

    def register(layer, prefix):
        def hook(lyr, ins, outs):
            key = f"{type(lyr).__name__}-{len(stats) + 1}"
            n_params = 0
            trainable = 0
            # parameters shared across layers (weight tying) count once
            for p in lyr.parameters(recurse=False):
                if id(p) in counted:
                    continue
                counted.add(id(p))
                n = int(np.prod(tuple(p.shape))) if p.ndim else 1
                n_params += n
                if not p.stop_gradient:
                    trainable += n
            stats[key] = {
                "output_shape": _shape_of(outs),
                "nb_params": n_params,
                "trainable": trainable,
            }

        hooks.append(layer.register_forward_post_hook(hook))

    # hook every sublayer: leaves report their own params; composite layers
    # report only direct (non-sublayer) params, deduped via `counted`
    for _, sub in net.named_sublayers(include_self=False):
        register(sub, "")
    if not hooks:
        register(net, "")

    was_training = getattr(net, "training", True)
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()

    total_params = sum(s["nb_params"] for s in stats.values())
    trainable_params = sum(s["trainable"] for s in stats.values())

    line = "-" * 80
    print(line)
    print(f"{'Layer (type)':<28}{'Output Shape':<32}{'Param #':<12}")
    print("=" * 80)
    for name, s in stats.items():
        print(f"{name:<28}{str(s['output_shape']):<32}{s['nb_params']:<12,}")
    print("=" * 80)
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable_params:,}")
    print(f"Non-trainable params: {total_params - trainable_params:,}")
    print(line)
    return {"total_params": total_params, "trainable_params": trainable_params}
