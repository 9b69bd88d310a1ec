"""paddle.static.nn: the static layer builders (fc, conv2d, cond,
while_loop, the sequence ops) of paddle_tpu/static/nn.py wait for their
slice (ROADMAP Queue A item 3.4); every name here raises
NotImplementedError when called."""
from __future__ import annotations

_NAMES = (
    "fc", "embedding", "batch_norm", "conv2d", "prelu", "sequence_softmax", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "layer_norm", "group_norm", "instance_norm",
    "spectral_norm", "data_norm", "bilinear_tensor_product", "deform_conv2d", "row_conv", "nce",
    "sparse_embedding", "cond", "case", "switch_case", "while_loop", "static_pylayer", "py_func",
    "sequence_conv", "sequence_pool", "sequence_first_step", "sequence_last_step",
    "sequence_concat", "sequence_slice", "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter", "sequence_enumerate",
    "sequence_reverse",
)


def not_ported(name, what, item="3.4"):
    """A callable that raises NotImplementedError naming `what` and its
    ROADMAP Queue A item."""

    def f(*args, **kwargs):
        raise NotImplementedError(
            f"paddle.static.{name}: {what} is not ported yet (ROADMAP Queue A item {item})")

    f.__name__ = f.__qualname__ = name.rsplit(".", 1)[-1]
    return f


for _n in _NAMES:
    globals()[_n] = not_ported(f"nn.{_n}", "static/nn.py")

__all__ = list(_NAMES)
