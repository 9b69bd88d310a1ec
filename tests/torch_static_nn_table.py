"""The cases of the static.nn parity checks: each is (id, build(pkg,
static, *inputs), feeds), a builder of paddle.static.nn called on
placeholders (captured) or on tensors (eager), with its seeded numpy
inputs. `tests/test_torch_static_nn.py` runs them against the JAX
package and `chip_smoke.py`'s static_nn_parity on the card against the
CPU. Imports numpy only.
"""
import numpy as np


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def int_ids(hi, *shape, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape).astype("int64")


# (id, build(pkg, static, *inputs), feeds)
BUILDERS = [
    ("fc", lambda pk, st, x: st.nn.fc(x, 5, activation="relu"), [("x", randn(2, 3, 4))]),
    ("fc_flatten2", lambda pk, st, x: st.nn.fc(x, 3, num_flatten_dims=2), [("x", randn(2, 3, 4))]),
    ("embedding", lambda pk, st, x: st.nn.embedding(x, [10, 4], padding_idx=0),
     [("ids", int_ids(10, 2, 3))]),
    ("sparse_embedding", lambda pk, st, x: st.nn.sparse_embedding(x, [10, 4]),
     [("ids", int_ids(10, 2, 3))]),
    ("batch_norm", lambda pk, st, x: st.nn.batch_norm(x, act="relu"), [("x", randn(2, 3, 4, 4))]),
    ("batch_norm_is_test", lambda pk, st, x: st.nn.batch_norm(x, is_test=True),
     [("x", randn(2, 3, 4, 4))]),
    ("conv2d", lambda pk, st, x: st.nn.conv2d(x, 4, 3, padding=1, act="relu"),
     [("x", randn(2, 3, 6, 6))]),
    ("conv2d_no_bias", lambda pk, st, x: st.nn.conv2d(x, 4, 3, stride=2, bias_attr=False),
     [("x", randn(2, 3, 6, 6))]),
    ("conv3d", lambda pk, st, x: st.nn.conv3d(x, 3, 2), [("x", randn(1, 2, 4, 4, 4))]),
    ("conv2d_transpose", lambda pk, st, x: st.nn.conv2d_transpose(x, 3, filter_size=3, stride=2),
     [("x", randn(1, 2, 4, 4))]),
    ("conv3d_transpose", lambda pk, st, x: st.nn.conv3d_transpose(x, 2, filter_size=2),
     [("x", randn(1, 2, 3, 3, 3))]),
    ("layer_norm", lambda pk, st, x: st.nn.layer_norm(x, begin_norm_axis=1),
     [("x", randn(2, 3, 4))]),
    ("group_norm", lambda pk, st, x: st.nn.group_norm(x, 2), [("x", randn(2, 4, 3, 3))]),
    ("instance_norm", lambda pk, st, x: st.nn.instance_norm(x), [("x", randn(2, 3, 4, 4))]),
    ("prelu_all", lambda pk, st, x: st.nn.prelu(x, "all"), [("x", randn(2, 3, 4, 4))]),
    ("prelu_channel", lambda pk, st, x: st.nn.prelu(x, "channel"), [("x", randn(2, 3, 4, 4))]),
    ("prelu_element", lambda pk, st, x: st.nn.prelu(x, "element"), [("x", randn(2, 3, 4, 4))]),
    ("spectral_norm", lambda pk, st, w: st.nn.spectral_norm(w, dim=0, power_iters=2),
     [("w", randn(4, 3, 2))]),
    ("data_norm", lambda pk, st, x: st.nn.data_norm(x), [("x", randn(4, 3))]),
    ("data_norm_nchw", lambda pk, st, x: st.nn.data_norm(x, act="relu"),
     [("x", randn(2, 3, 2, 2))]),
    ("bilinear_tensor_product",
     lambda pk, st, x, y: st.nn.bilinear_tensor_product(x, y, 5, act="tanh"),
     [("x", randn(2, 3)), ("y", randn(2, 4, seed=1))]),
    ("row_conv", lambda pk, st, x: st.nn.row_conv(x, 2), [("x", randn(2, 5, 3))]),
    ("deform_conv2d", lambda pk, st, x, off, m: st.nn.deform_conv2d(x, off, m, 3, 3),
     [("x", randn(1, 2, 5, 5)), ("off", 0.7 * randn(1, 18, 3, 3, seed=1)),
      ("m", np.abs(randn(1, 9, 3, 3, seed=2)))]),
    ("deform_conv2d_v1", lambda pk, st, x, off: st.nn.deform_conv2d(x, off, None, 2, 2,
                                                                   padding=1, bias_attr=False),
     [("x", randn(1, 2, 4, 4)), ("off", 1.3 * randn(1, 8, 5, 5, seed=3))]),
    ("sequence_softmax", lambda pk, st, x: st.nn.sequence_softmax(x), [("x", randn(2, 3, 4))]),
    ("sequence_conv", lambda pk, st, x: st.nn.sequence_conv(x, 4, act="relu"),
     [("x", randn(2, 5, 3))]),
]

SEQUENCE = [
    ("sequence_pool_" + t, (lambda t: lambda pk, st, x: st.nn.sequence_pool(x, t))(t),
     [("x", randn(2, 5, 3))])
    for t in ("average", "sum", "max", "sqrt", "first", "last")
] + [
    ("sequence_first_step", lambda pk, st, x: st.nn.sequence_first_step(x),
     [("x", randn(2, 5, 3))]),
    ("sequence_last_step", lambda pk, st, x: st.nn.sequence_last_step(x), [("x", randn(2, 5, 3))]),
    ("sequence_concat", lambda pk, st, x, y: st.nn.sequence_concat([x, y]),
     [("x", randn(2, 2, 3)), ("y", randn(2, 3, 3, seed=1))]),
    ("sequence_expand", lambda pk, st, x, y: st.nn.sequence_expand(x, y),
     [("x", randn(2, 1, 3)), ("y", randn(2, 4, 3, seed=1))]),
    ("sequence_expand_as", lambda pk, st, x, y: st.nn.sequence_expand_as(x, y),
     [("x", randn(2, 2, 3)), ("y", randn(2, 4, 3, seed=1))]),
    ("sequence_pad", lambda pk, st, x: st.nn.sequence_pad(x, 0.5, maxlen=6)[0],
     [("x", randn(2, 4, 3))]),
    ("sequence_reshape", lambda pk, st, x: st.nn.sequence_reshape(x, 6), [("x", randn(2, 4, 3))]),
    ("sequence_scatter", lambda pk, st, x, i, u: st.nn.sequence_scatter(x, i, u),
     [("x", randn(2, 5, 3)), ("i", np.array([[1, 3], [0, 4]], "int64")[..., None].repeat(3, -1)),
      ("u", randn(2, 2, 3, seed=1))]),
    ("sequence_enumerate", lambda pk, st, x: st.nn.sequence_enumerate(x, 3, pad_value=-1.0),
     [("x", randn(2, 4, 2))]),
    ("sequence_reverse", lambda pk, st, x: st.nn.sequence_reverse(x), [("x", randn(2, 4, 3))]),
]


# the rest of the static surface, captured: (id, build, feeds)
def _control_flow(pk, st, x, p):
    nn = st.nn
    a = nn.cond(p.sum() > 0.5, lambda: x * 2.0, lambda: x - 1.0)  # fixed by the dry run
    b = nn.case([(p.sum() > 0.5, lambda: x + 10.0)], default=lambda: x + 20.0)
    c = nn.switch_case(pk.to_tensor(1), {0: lambda: x * 0.0, 1: lambda: x * 3.0})
    (d,) = nn.while_loop(lambda s: s.sum() < 0.5, lambda s: (s + 1.0,), [x])
    e = nn.static_pylayer(lambda v: v * 3.0, [x], backward_fn=lambda g: g * 10.0)
    f = nn.py_func(lambda v: v * v, x)
    return [a, b, c, d, e, f]


def _gradients(pk, st, x):
    w = st.create_parameter([3], "float32")
    y = x * x * w
    seed = pk.to_tensor(np.array([1.0, 2.0, 3.0], "float32"))
    return st.gradients([y * 3.0], [x, y, w], target_gradients=[seed])


def _metrics(pk, st, logits, labels, prob, binary):
    out = [st.accuracy(logits, labels, k=1), st.accuracy(logits, labels, k=5)]
    out += [st.auc(prob, binary, curve=c)[0] for c in ("ROC", "PR")]
    return out + list(st.ctr_metric_bundle(prob, binary))


def _jit_cond(pk, st, x, p):
    return pk.jit.cond(p, lambda v: v * 2.0, lambda v: v - 1.0, x)


_PROB = np.random.RandomState(3).rand(16, 2).astype("float32")
_PROB[:3, 1] = [0.25, 0.5, 1.0]  # on thresholds

EXTRAS = [
    ("control_flow", _control_flow, [("x", randn(3)), ("p", np.ones(1, "float32"))]),
    ("jit_cond_true", _jit_cond, [("x", randn(3)), ("p", np.array(True))]),
    ("jit_cond_false", _jit_cond, [("x", randn(3)), ("p", np.array(False))]),
    ("gradients", _gradients, [("x", randn(3))]),
    ("print", lambda pk, st, x: st.Print(x * 2.0, message="static_nn_parity Print"),
     [("x", randn(3))]),
    ("metrics", _metrics, [("logits", randn(16, 10)), ("labels", int_ids(10, 16, 1)),
                           ("prob", _PROB), ("binary", int_ids(2, 16, 1, seed=4))]),
    ("nce", lambda pk, st, x, lbl: st.nn.nce(x, lbl, 7, num_neg_samples=3),
     [("x", randn(4, 3)), ("lbl", int_ids(7, 4, 1, seed=1))]),
    ("sequence_slice", lambda pk, st, x, off, ln: st.nn.sequence_slice(x, off, ln),
     [("x", randn(3, 6, 2)), ("off", np.array([0, 2, 1], "int64")),
      ("ln", np.array([3, 3, 3], "int64"))]),
]
