"""batch_norm, rms_norm, layer_norm, group_norm, instance_norm and
local_response_norm (counterpart of paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp import amp_cast_inputs
from ...core import state as _state
from ...framework import dtype as _dtype


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) in f32, cast back to x's type, then
    scaled by `weight` in x's type: the JAX package's cast order. Under
    AMP the inputs cast as the black-listed op "rms_norm" (float32 under
    O1)."""
    x, weight = amp_cast_inputs("rms_norm", [x, weight])
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5, name=None):
    """(x - mean) * rsqrt(var + eps) over the trailing `normalized_shape`,
    the statistics in f32, cast back to x's type, then `* weight` and
    `+ bias` in x's type: the JAX package's cast order. Under AMP the
    inputs cast as the black-listed op "layer_norm" (float32 under O1).
    For f32 x and f32 (or no) weight and bias every step is f32, and
    torch's fused layer_norm computes the same value in one kernel."""
    x, weight, bias = amp_cast_inputs("layer_norm", [x, weight, bias])
    shape = (normalized_shape,) if isinstance(normalized_shape, int) else tuple(normalized_shape)
    if all(t is None or t.dtype == torch.float32 for t in (x, weight, bias)):
        return TF.layer_norm(x, shape, weight, bias, epsilon)
    out = TF.layer_norm(x.float(), shape, eps=epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def _bn_stats(x, axes):
    """Biased batch mean and variance in x's type, as jnp.mean/jnp.var give
    them: reduced in f32 for a 16-bit x, then rounded back. Not on an AMP
    list, so under O1 a bf16 conv output gives bf16 statistics."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    var, mean = torch.var_mean(xf, dim=axes, correction=0)
    return mean.to(x.dtype), var.to(x.dtype)


@torch.no_grad()
def _update_running(running_mean, running_var, mean, var, momentum):
    # (1 - momentum) multiplies in the statistics' type, as a weak Python
    # float does in the JAX package
    keep = _dtype.round_to(1 - momentum, mean.dtype)
    running_mean.copy_(running_mean * momentum + mean * keep)
    running_var.copy_(running_var * momentum + var * keep)


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every axis but the channel's (axis 1 for NC...
    formats, the last otherwise). In training (unless use_global_stats)
    it normalizes with the batch statistics, which the gradient flows
    through, and updates the buffers in place, paddle's way:
    running = momentum * running + (1 - momentum) * batch, with the
    biased batch variance (torch's F.batch_norm weighs the new value by
    its momentum and uses the unbiased one). Otherwise it normalizes with
    the buffers and leaves them unchanged. The normalization is the
    black-listed op "batch_norm": under AMP every input is cast to f32
    first, so the output is f32."""
    ch = 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1
    if training and not use_global_stats:
        mean, var = _bn_stats(x, [i for i in range(x.dim()) if i != ch])
        # a capture's dry run (program_guard) leaves the buffers alone, as
        # building a paddle Program runs nothing; the recorded op's replay
        # writes them
        if _state.get_program_capture() is None:
            _update_running(running_mean, running_var, mean, var, momentum)
    else:
        mean, var = running_mean, running_var
    x, mean, var, weight, bias = amp_cast_inputs("batch_norm", [x, mean, var, weight, bias])
    shape = [1] * x.dim()
    shape[ch] = -1
    out = (x - mean.reshape(shape).to(x.dtype)) * torch.rsqrt(var.reshape(shape).to(x.dtype) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape).to(x.dtype)
    if bias is not None:
        out = out + bias.reshape(shape).to(x.dtype)
    return out


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape).to(out.dtype)
    if bias is not None:
        out = out + bias.reshape(shape).to(out.dtype)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None, data_format="NCHW",
               name=None):
    """Normalized over each group of C / num_groups channels and the
    spatial axes, the statistics in f32, cast back to x's type, then the
    per-channel weight and bias. The black-listed op "group_norm" (f32
    under AMP O1)."""
    x, weight, bias = amp_cast_inputs("group_norm", [x, weight, bias])
    channels_first = data_format.startswith("NC")
    v = x if channels_first else x.movedim(-1, 1)
    n, c = v.shape[0], v.shape[1]
    r = v.reshape(n, num_groups, -1).float()
    var, mean = torch.var_mean(r, dim=-1, keepdim=True, correction=0)
    out = ((r - mean) * torch.rsqrt(var + epsilon)).reshape(v.shape).to(v.dtype)
    out = _affine(out, weight, bias, (1, c) + (1,) * (v.dim() - 2))
    return out if channels_first else out.movedim(1, -1)


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW", name=None):
    """Each (sample, channel) normalized over its spatial axes, in x's type
    (the JAX package's: no f32 upcast, no running statistics)."""
    axes = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    return _affine(out, weight, bias, (1, -1) + (1,) * (x.dim() - 2))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
    """x / (k + alpha * (sum of x^2 over `size` neighbouring channels) /
    size) ** beta, the window [c - size // 2, c + (size - 1) // 2]."""
    sq = x.square()
    half = size // 2
    pads = [0, 0] * (x.dim() - 2) + [half, size - half - 1]
    padded = TF.pad(sq, pads)
    acc = sum(padded.narrow(1, i, x.shape[1]) for i in range(size))
    return x / torch.pow(k + alpha * acc / size, beta)

# each public op is one recorded op of a static capture (core/record.py)
from ...core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
