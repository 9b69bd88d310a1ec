"""paddle.static.nn: the static layer builders (counterpart of
paddle_tpu/static/nn.py).

Each builder is an eager function over the port's `nn` layers: it makes
the layer's parameters (initialized unrecorded, nn/layer.py) and calls
it, so under `program_guard` its ops record into the Program and the
parameters become the Program's persistables, and outside a guard it
computes at once. Builders with parameters of their own (`prelu`'s
element mode, `data_norm`, `row_conv`, `nce`) and the sequence ops that
have no paddle op record one op each under the JAX package's names.

Control flow keeps the JAX file's eager semantics: `cond`, `case`,
`switch_case` and `while_loop` read their predicates on the host, so
under capture the dry run's values (the zero placeholders) pick the
branch or the number of iterations, and the Program holds what ran.
`jit.cond` (also `static.cond`) is the one that decides at every run.
`py_func` and `static_pylayer` record one op whose replay calls the
Python function again.

The sequence ops take the padded-dense layout [B, T, ...] (the LoD form
is subsumed by padding and lengths). `sequence_slice` and
`sequence_unpad` read their lengths on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import record as _record
from ..ops import manipulation as _mp
from ..ops import math as _m

__all__ = [
    "fc", "embedding", "batch_norm", "conv2d", "prelu", "sequence_softmax", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "layer_norm", "group_norm", "instance_norm",
    "spectral_norm", "data_norm", "bilinear_tensor_product", "deform_conv2d", "row_conv", "nce",
    "sparse_embedding", "cond", "case", "switch_case", "while_loop", "static_pylayer", "py_func",
    "sequence_conv", "sequence_pool", "sequence_first_step", "sequence_last_step",
    "sequence_concat", "sequence_slice", "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter", "sequence_enumerate",
    "sequence_reverse",
]


def _F():
    from ..nn import functional as F

    return F


def _maybe_act(out, act):
    return getattr(_F(), act)(out) if act else out


def _dims(x):
    """x's dims as ints, the dynamic (-1) dims of a static.data placeholder
    included (their dry-run size), read without recording."""
    with _record.suspended():
        return [int(d) for d in x.shape]


def _concrete(v):
    """A predicate, index or length as a numpy value, read on the host."""
    if isinstance(v, torch.Tensor):
        with _record.suspended():
            return v.detach().cpu().numpy()
    return np.asarray(v)


def _param(shape, attr=None, is_bias=False, default=None):
    from ..ops.creation import create_parameter

    return create_parameter(tuple(int(s) for s in shape), "float32", attr=attr, is_bias=is_bias,
                            default_initializer=default)


def _constant(value):
    from ..nn.initializer import Constant

    return Constant(value)


# ---------------------------------------------------------------------------
# common builders (paddle_tpu/static/nn.py:13-350)
# ---------------------------------------------------------------------------

def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None, activation=None,
       name=None):
    """A Linear over x's dims from `num_flatten_dims` on, flattened (its
    weight [in, out]). The lead dims are kept as they come at every run
    (reshaped as 0, paddle's "this dim of the input"), so a dynamic batch
    passes through; a dynamic flattened dim raises."""
    from .. import nn

    raw = _dims(x)
    dyn = getattr(x, "_dynamic_dims", None) or set()
    in_features = 1
    for i in range(num_flatten_dims, len(raw)):
        if i in dyn:
            raise ValueError(
                "static.nn.fc: flattened dims must be static; got a dynamic (-1) "
                f"dim at index {i}: declare it in static.data")
        in_features *= raw[i]
    layer = nn.Linear(in_features, size, weight_attr=weight_attr, bias_attr=bias_attr)
    xin = x
    if len(raw) > num_flatten_dims + 1:
        xin = _mp.reshape(x, [0] * num_flatten_dims + [in_features])
    return _maybe_act(layer(xin), activation)


def embedding(input, size, is_sparse=False, padding_idx=None, param_attr=None,  # noqa: A002
              dtype="float32"):
    from .. import nn

    return nn.Embedding(size[0], size[1], padding_idx=padding_idx, weight_attr=param_attr)(input)


def sparse_embedding(input, size, padding_idx=None, is_test=False, entry=None,  # noqa: A002
                     table_class="MemorySparseTable", param_attr=None, dtype="float32",
                     slot=None):
    """The parameter-server table lookup: here the dense embedding."""
    return embedding(input, size, padding_idx=padding_idx, param_attr=param_attr, dtype=dtype)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5, param_attr=None,  # noqa: A002
               bias_attr=None, data_layout="NCHW", is_test=False, name=None):
    """A BatchNorm2D over the channel axis; `is_test` normalizes with the
    running statistics (the layer in eval mode)."""
    from .. import nn

    c = _dims(input)[1 if data_layout == "NCHW" else -1]
    layer = nn.BatchNorm2D(c, momentum=momentum, epsilon=epsilon, weight_attr=param_attr,
                           bias_attr=bias_attr, data_format=data_layout)
    if is_test:
        layer.eval()
    return _maybe_act(layer(input), act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,  # noqa: A002
           param_attr=None, bias_attr=None, act=None, data_format="NCHW", name=None):
    from .. import nn

    c_in = _dims(input)[1 if data_format == "NCHW" else -1]
    layer = nn.Conv2D(c_in, num_filters, filter_size, stride=stride, padding=padding,
                      dilation=dilation, groups=groups, data_format=data_format,
                      weight_attr=param_attr, bias_attr=bias_attr)
    return _maybe_act(layer(input), act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,  # noqa: A002
           param_attr=None, bias_attr=None, act=None, data_format="NCDHW", name=None):
    from .. import nn

    c_in = _dims(input)[1 if data_format == "NCDHW" else -1]
    layer = nn.Conv3D(c_in, num_filters, filter_size, stride=stride, padding=padding,
                      dilation=dilation, groups=groups, data_format=data_format,
                      weight_attr=param_attr, bias_attr=bias_attr)
    return _maybe_act(layer(input), act)


def _conv_transpose(cls, channels_first, input, num_filters, output_size, filter_size, stride,
                    padding, dilation, groups, param_attr, bias_attr, act, data_format, what):
    if filter_size is None:
        raise ValueError(f"static.nn.{what}: filter_size is required "
                         "(output_size-only inference is not supported)")
    c_in = _dims(input)[1 if data_format == channels_first else -1]
    layer = cls(c_in, num_filters, filter_size, stride=stride, padding=padding, dilation=dilation,
                groups=groups, data_format=data_format, weight_attr=param_attr,
                bias_attr=bias_attr)
    return _maybe_act(layer(input, output_size=output_size), act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None, stride=1,  # noqa: A002
                     padding=0, dilation=1, groups=1, param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", name=None):
    from .. import nn

    return _conv_transpose(nn.Conv2DTranspose, "NCHW", input, num_filters, output_size,
                           filter_size, stride, padding, dilation, groups, param_attr, bias_attr,
                           act, data_format, "conv2d_transpose")


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None, stride=1,  # noqa: A002
                     padding=0, dilation=1, groups=1, param_attr=None, bias_attr=None, act=None,
                     data_format="NCDHW", name=None):
    from .. import nn

    return _conv_transpose(nn.Conv3DTranspose, "NCDHW", input, num_filters, output_size,
                           filter_size, stride, padding, dilation, groups, param_attr, bias_attr,
                           act, data_format, "conv3d_transpose")


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,  # noqa: A002
               param_attr=None, bias_attr=None, act=None, name=None):
    shape = _dims(input)[begin_norm_axis:]
    w = _param(shape, param_attr, default=_constant(1.0)) if scale else None
    b = _param(shape, bias_attr, is_bias=True, default=_constant(0.0)) if shift else None
    return _maybe_act(_F().layer_norm(input, shape, weight=w, bias=b, epsilon=epsilon), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None, act=None,  # noqa: A002
               data_layout="NCHW", name=None):
    from .. import nn

    c = _dims(input)[1 if data_layout == "NCHW" else -1]
    layer = nn.GroupNorm(groups, c, epsilon=epsilon, weight_attr=param_attr,
                         bias_attr=bias_attr, data_format=data_layout)
    return _maybe_act(layer(input), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None, name=None):  # noqa: A002
    from .. import nn

    return nn.InstanceNorm2D(_dims(input)[1], epsilon=epsilon, weight_attr=param_attr,
                             bias_attr=bias_attr)(input)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    from .. import nn

    return nn.SpectralNorm(_dims(weight), dim=dim, power_iters=power_iters, epsilon=eps)(weight)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    """PReLU with one alpha ("all"), one a channel ("channel") or one an
    element of x[0] ("element": a parameter of its own, one op
    "prelu_element"); alpha starts at 0.25."""
    from .. import nn

    if mode == "element":
        alpha = _param(_dims(x)[1:], param_attr, default=_constant(0.25))
        return _record.apply("prelu_element", _prelu_element, x, alpha)
    if mode == "all":
        num = 1
    elif mode == "channel":
        num = _dims(x)[1 if data_format == "NCHW" else -1]
    else:
        raise ValueError(f"prelu mode must be all/channel/element, got {mode!r}")
    return nn.PReLU(num_parameters=num, data_format=data_format, weight_attr=param_attr)(x)


def _prelu_element(v, a):
    return torch.where(v >= 0, v, a[None] * v)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None, data_layout="NCHW",  # noqa: A002
              in_place=False, name=None, moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1, sync_stats=False,
              summary_decay_rate=0.9999999, enable_scale_and_shift=False):
    """Normalization by accumulated batch summaries: batch_size (1e4),
    batch_sum (0) and batch_square_sum (1e4) a channel, parameters of
    their own; mean = sum / size, scale = sqrt(size / max(square_sum -
    sum * mean, eps)). One op "data_norm"."""
    dims = _dims(input)
    channels_first = data_layout == "NCHW" and len(dims) > 2
    c = dims[1 if channels_first else -1]
    size = _param([c], default=_constant(1e4))
    total = _param([c], default=_constant(0.0))
    square = _param([c], default=_constant(1e4))
    bshape = [1, c] + [1] * (len(dims) - 2) if channels_first else None

    def fn(x, n, s, sq):
        mean = s / n
        scale = torch.sqrt(n / torch.clamp(sq - s * mean, min=epsilon))
        if bshape is not None:
            mean, scale = mean.reshape(bshape), scale.reshape(bshape)
        return (x - mean) * scale

    return _maybe_act(_record.apply("data_norm", fn, input, size, total, square), act)


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None, bias_attr=None):
    from .. import nn

    layer = nn.Bilinear(_dims(x)[-1], _dims(y)[-1], size, weight_attr=param_attr,
                        bias_attr=bias_attr)
    return _maybe_act(layer(x, y), act)


def deform_conv2d(input, offset, mask, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
                  dilation=1, groups=1, deformable_groups=1, im2col_step=1, param_attr=None,
                  bias_attr=None, name=None):
    from ..vision.ops import deform_conv2d as _dc

    ks = filter_size if isinstance(filter_size, (list, tuple)) else (filter_size, filter_size)
    w = _param((num_filters, _dims(input)[1] // groups, ks[0], ks[1]), param_attr)
    b = _param((num_filters,), bias_attr, is_bias=True) if bias_attr is not False else None
    return _dc(input, offset, w, bias=b, stride=stride, padding=padding, dilation=dilation,
               deformable_groups=deformable_groups, groups=groups, mask=mask)


def row_conv(input, future_context_size, param_attr=None, act=None):  # noqa: A002
    """Lookahead row convolution over [B, T, D]: out[t] = sum over i in
    0..k of x[t + i] * W[i] (x zero past T); W starts at 1 / (k + 1). One
    op "row_conv"."""
    d, k = _dims(input)[-1], future_context_size
    w = _param((k + 1, d), param_attr, default=_constant(1.0 / (k + 1)))

    def fn(x, wv):
        t = x.shape[1]
        pads = [0, 0] * (x.dim() - 2) + [0, k]
        xp = torch.nn.functional.pad(x, pads)
        out = torch.zeros_like(x)
        for i in range(k + 1):
            out = out + xp[:, i:i + t] * wv[i]
        return out

    return _maybe_act(_record.apply("row_conv", fn, input, w), act)


class NCENoise:
    """`nce`'s noise classes: [rows, k] uniform ids from a CPU generator
    seeded by `seed`, made the same on every call (and on every device),
    as the JAX package's key is baked into its fn."""

    def __init__(self, seed, k, num_classes):
        self.seed, self.k, self.num_classes = seed, k, num_classes

    def ids(self, rows, device="cpu"):
        gen = torch.Generator().manual_seed(self.seed)
        return torch.randint(0, self.num_classes, (rows, self.k), generator=gen).to(device)


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,  # noqa: A002
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform", custom_dist=None,
        seed=0, is_sparse=False):
    """Noise-contrastive estimation with uniform noise: for each row, the
    binary logistic loss of the true class against `num_neg_samples`
    (10) noise classes, softplus(-pos) + sum softplus(neg), [rows, 1].
    The noise ids' seed is drawn once, from the framework generator, when
    the builder runs (`NCENoise`). One op "nce"."""
    from ..framework import random as _random
    from ..nn.initializer import Normal

    d, k = _dims(input)[-1], num_neg_samples or 10
    # drawn first: the parameters' initializers draw from the device's
    # generator, the seed from the CPU's, so both devices draw the same
    noise = NCENoise(_random.next_uint32(), k, num_total_classes)
    w = _param((num_total_classes, d), param_attr, default=Normal(0.0, 0.01))
    b = (_param((num_total_classes,), bias_attr, is_bias=True) if bias_attr is not False
         else None)

    def fn(x, lbl, wv, *rest):
        rows = x.shape[0]
        lbl = lbl.reshape(rows)
        ids = noise.ids(rows, x.device)
        pos = torch.sum(x * wv[lbl], -1)
        neg = torch.einsum("bd,bkd->bk", x, wv[ids])
        if rest:
            pos, neg = pos + rest[0][lbl], neg + rest[0][ids]
        softplus = torch.nn.functional.softplus
        return (softplus(-pos) + torch.sum(softplus(neg), -1)).reshape(rows, 1)

    fn.noise = noise
    return _record.apply("nce", fn, input, label, w, *((b,) if b is not None else ()))


# ---------------------------------------------------------------------------
# control flow (paddle_tpu/static/nn.py:362-447)
# ---------------------------------------------------------------------------

def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """The branch `pred` picks, run now (under capture: the dry run's)."""
    if bool(_concrete(pred)):
        return true_fn() if true_fn is not None else None
    return false_fn() if false_fn is not None else None


def case(pred_fn_pairs, default=None, name=None):
    """The first pair whose predicate holds; else `default`, else the
    last pair's fn."""
    for pred, fn in pred_fn_pairs:
        if bool(_concrete(pred)):
            return fn()
    if default is not None:
        return default()
    return pred_fn_pairs[-1][1]()


def switch_case(branch_index, branch_fns, default=None, name=None):
    """branch_fns[branch_index] (a dict or (index, fn) pairs); else
    `default`, else the largest index's fn."""
    idx = int(_concrete(branch_index))
    fns = branch_fns if isinstance(branch_fns, dict) else dict(branch_fns)
    if idx in fns:
        return fns[idx]()
    if default is not None:
        return default()
    return fns[max(fns)]()


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """body over loop_vars while cond holds, iterated now (each iteration's
    ops record under capture)."""
    vars_ = list(loop_vars)
    while bool(_concrete(cond(*vars_))):
        out = body(*vars_)
        vars_ = list(out) if isinstance(out, (list, tuple)) else [out]
    return vars_


def static_pylayer(forward_fn, inputs, backward_fn=None, name=None):
    """forward_fn(*inputs) as one op "static_pylayer"; with backward_fn, a
    PyLayer whose backward it is."""
    if backward_fn is None:
        return _record.apply("static_pylayer", forward_fn, *inputs)
    from ..autograd import PyLayer

    class _P(PyLayer):
        @staticmethod
        def forward(ctx, *xs):
            return forward_fn(*xs)

        @staticmethod
        def backward(ctx, *gs):
            return backward_fn(*gs)

    return _record.apply("static_pylayer", _P.apply, *inputs)


def py_func(func, x, out=None, backward_func=None, skip_vars_in_backward_input=None):
    """func(*x) as one op "py_func" (its replay calls func again); with
    backward_func, through static_pylayer."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if backward_func is None:
        return _record.apply("py_func", func, *xs)
    return static_pylayer(func, xs, backward_fn=backward_func)


# ---------------------------------------------------------------------------
# sequence ops (paddle_tpu/static/nn.py:450-598), padded dense [B, T, ...]
# ---------------------------------------------------------------------------

def sequence_softmax(x, name=None):
    return _F().softmax(x, axis=-1)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1, padding=True,  # noqa: A002
                  padding_start=None, bias_attr=None, param_attr=None, act=None, name=None):
    """A context-window conv over time: Conv1D on [B, D, T]."""
    from .. import nn

    layer = nn.Conv1D(_dims(input)[-1], num_filters, filter_size, stride=filter_stride,
                      padding=(filter_size - 1) // 2 if padding else 0,
                      weight_attr=param_attr, bias_attr=bias_attr)
    out = layer(_mp.transpose(input, [0, 2, 1]))
    return _maybe_act(_mp.transpose(out, [0, 2, 1]), act)


def sequence_pool(input, pool_type="average", is_test=False, pad_value=0.0):  # noqa: A002
    pt = pool_type.lower()
    if pt in ("average", "avg"):
        return _m.mean(input, axis=1)
    if pt == "sum":
        return _m.sum(input, axis=1)
    if pt == "max":
        return _m.max(input, axis=1)
    if pt == "sqrt":
        return _m.sum(input, axis=1) / float(np.sqrt(_dims(input)[1]))
    if pt == "first":
        return sequence_first_step(input)
    if pt == "last":
        return sequence_last_step(input)
    raise ValueError(f"unsupported pool_type {pool_type}")


def sequence_first_step(input):  # noqa: A002
    return input[:, 0]


def sequence_last_step(input):  # noqa: A002
    return input[:, -1]


def sequence_concat(input, name=None):  # noqa: A002
    return _mp.concat(list(input), axis=1)


def _slice_fn(x, off, ln):
    l0 = int(_concrete(ln).reshape(-1)[0])
    idx = off.reshape(-1, 1).long() + torch.arange(l0, device=x.device)[None]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(-1, -1, *x.shape[2:])
    return torch.gather(x, 1, idx)


def sequence_slice(input, offset, length, name=None):  # noqa: A002
    """The time slice [offset, offset + length) of each row, one length
    for all rows (read on the host at every run). One op
    "sequence_slice"."""
    return _record.apply("sequence_slice", _slice_fn, input, offset, length)


def sequence_expand(x, y, ref_level=-1, name=None):
    """x's time steps repeated to y's length."""
    reps = _dims(y)[1] // max(1, _dims(x)[1])
    return _mp.tile(x, [1, reps] + [1] * (x.dim() - 2))


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y)


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """x's time axis padded with pad_value to maxlen (one op
    "sequence_pad"), and the lengths [B] (all T: the input is dense)."""
    dims = _dims(x)
    t = dims[1]
    target = maxlen or t

    def fn(v, pv):
        fill = torch.as_tensor(pv, dtype=v.dtype, device=v.device)
        pad = fill.reshape(()).expand(v.shape[0], target - t, *v.shape[2:])
        return torch.cat([v, pad], dim=1)

    padded = _record.apply("sequence_pad", fn, x, pad_value)
    lengths = torch.full((dims[0],), t, dtype=torch.int64, device=x.device)
    return padded, lengths


def sequence_unpad(x, length, name=None):
    """x trimmed to the longest length (read on the host); callers mask
    with `length`."""
    return x[:, :int(_concrete(length).max())]


def sequence_reshape(input, new_dim):  # noqa: A002
    return _mp.reshape(input, [_dims(input)[0], -1, new_dim])


def sequence_scatter(input, index, updates, name=None):  # noqa: A002
    """input with `updates` ADDED at the time positions `index`."""
    return _mp.put_along_axis(input, index, updates, axis=1, reduce="add")


def sequence_enumerate(input, win_size, pad_value=0, name=None):  # noqa: A002
    """The win_size-gram starting at each time step, padded with pad_value
    past T: [B, T, ..., win_size]. One op "sequence_enumerate"."""

    def fn(x):
        t = x.shape[1]
        pads = [0, 0] * (x.dim() - 2) + [0, win_size - 1]
        xp = torch.nn.functional.pad(x, pads, value=pad_value)
        return torch.stack([xp[:, i:i + t] for i in range(win_size)], dim=-1)

    return _record.apply("sequence_enumerate", fn, input)


def sequence_reverse(x, name=None):
    return _mp.flip(x, axis=1)
