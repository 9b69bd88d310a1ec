"""paddle.nn.utils (counterpart of paddle_tpu/nn/utils/__init__.py):
weight_norm and remove_weight_norm, spectral_norm, parameters_to_vector
and vector_to_parameters, clip_grad_norm_ and clip_grad_value_.

weight_norm and spectral_norm re-parameterize `layer.<name>` by a forward
pre-hook that recomputes it from the new parameters before every call
(and once when applied), as the JAX package's hooks do; the recomputed
weight is a plain attribute, not a parameter.
"""
from __future__ import annotations

import numpy as np
import torch

from ..layer import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm", "parameters_to_vector",
           "vector_to_parameters", "clip_grad_norm_", "clip_grad_value_"]


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of `vec` into the parameters (in place)."""
    off = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[off:off + n].reshape(p.shape).to(p.dtype))
            off += n


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale every .grad in place by min(1, max_norm / max(total, 1e-12)),
    total the norm_type norm of all of them in f32 (inf: the largest |g|);
    returns total. error_if_nonfinite raises on a non-finite total."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max() for p in params]).max()
    else:
        total = torch.stack([(p.grad.float().abs() ** norm_type).sum()
                             for p in params]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("grad norm is non-finite; cannot clip")
    scale = torch.clamp_max(max_norm / torch.clamp_min(total, 1e-12), 1.0)
    with torch.no_grad():
        for p in params:
            p.grad.copy_((p.grad.float() * scale).to(p.grad.dtype))
    return total


def clip_grad_value_(parameters, clip_value):
    with torch.no_grad():
        for p in parameters:
            if p.grad is not None:
                p.grad.clamp_(-clip_value, clip_value)


def _norm_except(v, dim):
    if dim is None:
        return v.square().sum().sqrt()
    axes = [i for i in range(v.dim()) if i != dim]
    return v.square().sum(dim=axes, keepdim=True).sqrt()


def _replace(layer, name, trainable, new):
    """Drop parameter `name`; register the new parameters {suffix: value}."""
    del layer._parameters[name]
    for suffix, value in new.items():
        layer.register_parameter(name + suffix, Parameter(value.detach().clone(),
                                                          trainable=trainable))


def weight_norm(layer, name="weight", dim=0):
    """layer.<name> = g * v / ||v||, the norm over every axis but `dim`
    (all of them for dim=None): v (`<name>_v`) starts as the weight and g
    (`<name>_g`) as its norm."""
    w = getattr(layer, name)
    trainable = w.requires_grad
    _replace(layer, name, trainable, {"_v": w, "_g": _norm_except(w.detach(), dim)})

    def hook(lyr, inputs):
        v, g = lyr._parameters[name + "_v"], lyr._parameters[name + "_g"]
        object.__setattr__(lyr, name, g * v / torch.clamp_min(_norm_except(v, dim), 1e-12))

    handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_handles = getattr(layer, "_weight_norm_handles", {})
    layer._weight_norm_handles[name] = (handle, dim)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold g * v / ||v|| back into one parameter `name`."""
    handles = getattr(layer, "_weight_norm_handles", {})
    if name not in handles:
        raise ValueError(f"no weight_norm on parameter {name!r}")
    handle, dim = handles.pop(name)
    handle.remove()
    v, g = layer._parameters.pop(name + "_v"), layer._parameters.pop(name + "_g")
    with torch.no_grad():
        w = g * v / torch.clamp_min(_norm_except(v, dim), 1e-12)
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, Parameter(w, trainable=v.requires_grad))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12, dim=None):
    """layer.<name> = w / sigma, sigma estimated by power iteration (at
    least one step) from the buffer `<name>_u`, which starts from
    np.random.RandomState(0) as in the JAX package and keeps each call's
    last u; the weight itself becomes `<name>_orig`."""
    w = getattr(layer, name)
    dim = 0 if dim is None else dim
    h = w.shape[dim]
    u0 = torch.from_numpy(np.random.RandomState(0).randn(h).astype(np.float32)).to(w.device)
    layer.register_buffer(name + "_u", u0)
    _replace(layer, name, w.requires_grad, {"_orig": w})

    def normalize(t):
        return t / torch.clamp_min(torch.linalg.vector_norm(t), eps)

    def hook(lyr, inputs):
        wv = lyr._parameters[name + "_orig"]
        wm = wv.movedim(dim, 0).reshape(h, -1)
        u = lyr._buffers[name + "_u"]
        v = normalize(wm.t() @ u)
        for _ in range(max(n_power_iterations - 1, 0)):
            u = normalize(wm @ v)
            v = normalize(wm.t() @ u)
        u = normalize(wm @ v)
        sigma = u @ wm @ v
        lyr._buffers[name + "_u"] = u.detach()
        object.__setattr__(lyr, name, wv / torch.clamp_min(sigma, eps))

    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer
