"""Port parity for the ERNIE slice: the functionals and layers ERNIE is
built from, the MLM model's parameters and init, to_tensor and to_static,
against the JAX package on the same numpy inputs. The tiny ERNIE trained
in both packages is in test_torch_ernie_train.py."""
import os
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import ernie as jernie

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu, state_to_paddle_tpu

TINY = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _reset():
    ptt.set_device("cpu")
    yield
    paddle.set_flags({"FLAGS_fused_optimizer": False})
    ptt.set_flags({"FLAGS_fused_optimizer": False})


def _np_state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


def _carry(jlayer, tlayer):
    """Load the JAX layer's weights into the port's layer."""
    tlayer.load_state_dict(state_from_paddle_tpu(_np_state(jlayer)))
    return tlayer


# f32 cases differ only in summation order; the bf16 ones by a last bf16 bit
@pytest.mark.parametrize("case", ["layer_norm_f32", "layer_norm_bf16", "gelu_f32", "gelu_bf16",
                                  "tanh_f32", "embedding_padding", "dropout_p0", "dropout_eval"])
def test_functional_matches_jax(case):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 32).astype(np.float32) * 2.0
    w = (1.0 + 0.1 * rng.randn(32)).astype(np.float32)
    b = (0.1 * rng.randn(32)).astype(np.float32)
    JF, TF = paddle.nn.functional, ptt.nn.functional
    bf16 = case.endswith("bf16")
    xj = paddle.to_tensor(x).astype("bfloat16") if bf16 else paddle.to_tensor(x)
    xt = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    if case.startswith("layer_norm"):
        want = JF.layer_norm(xj, 32, paddle.to_tensor(w), paddle.to_tensor(b))
        got = TF.layer_norm(xt, 32, torch.from_numpy(w), torch.from_numpy(b))
    elif case.startswith("gelu"):
        want, got = JF.gelu(xj), TF.gelu(xt)
    elif case == "tanh_f32":
        want, got = JF.tanh(xj), TF.tanh(xt)
    elif case == "embedding_padding":
        # a padding row that is NOT zero (as after a step of a tied
        # embedding): the output at padding ids is zero all the same
        table = rng.randn(16, 8).astype(np.float32)
        ids = rng.randint(0, 16, (3, 7)).astype(np.int64)
        ids[0, :3] = 5
        want = JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(table), padding_idx=5)
        got = TF.embedding(torch.from_numpy(ids), torch.from_numpy(table), padding_idx=5)
        assert (got[0, :3] == 0).all() and np.abs(table[5]).sum() > 0
    elif case == "dropout_p0":
        want, got = JF.dropout(xj, p=0.0), TF.dropout(xt, p=0.0)
    else:
        want, got = JF.dropout(xj, p=0.5, training=False), TF.dropout(xt, p=0.5, training=False)
    assert str(got.dtype).split(".")[-1] == str(want._value.dtype)
    tol = dict(rtol=8e-3, atol=8e-3) if bf16 else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want._value.astype(jnp.float32)),
                               **tol)


def test_dropout_training_keeps_share_and_upscales():
    """p = 0.25 in training: about 3/4 of the values kept, each kept value
    x / (1 - p), the rest zero; drawn from the framework generator, so a
    reseed repeats the mask."""
    x = torch.ones(64, 256)
    ptt.seed(5)
    a = ptt.nn.functional.dropout(x, p=0.25)
    ptt.seed(5)
    b = ptt.nn.functional.dropout(x, p=0.25)
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    assert abs((a != 0).float().mean().item() - 0.75) < 0.01


@pytest.mark.parametrize("layer,masked,pre_ln", [("mha", False, False), ("mha", True, False),
                                                  ("encoder_layer", False, False),
                                                  ("encoder_layer", True, False),
                                                  ("encoder_layer", True, True)])
def test_attention_layers_match_jax(layer, masked, pre_ln):
    """MultiHeadAttention and TransformerEncoderLayer (post-LN and pre-LN),
    with and without an additive [B, 1, 1, S] mask, from the same weights,
    in f32: the output and the input's gradient. Attention dropout 0 (a
    masked call runs the plain chain on both sides)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 10, 32).astype(np.float32)
    mask = None
    if masked:
        keep = np.ones((2, 10), np.float32)
        keep[0, 7:] = 0.0
        mask = ((keep - 1.0) * 1e4)[:, None, None, :]
    paddle.seed(1)
    if layer == "mha":
        jl = paddle.nn.MultiHeadAttention(32, 4)
        tl = ptt.nn.MultiHeadAttention(32, 4)
        call = lambda m, v, mk: m(v, attn_mask=mk)
    else:
        kw = dict(dropout=0.0, activation="gelu", normalize_before=pre_ln)
        jl = paddle.nn.TransformerEncoderLayer(32, 4, 64, **kw)
        tl = ptt.nn.TransformerEncoderLayer(32, 4, 64, **kw)
        call = lambda m, v, mk: m(v, mk)
    _carry(jl, tl)
    xj = paddle.to_tensor(x, stop_gradient=False)
    want = call(jl, xj, None if mask is None else paddle.to_tensor(mask))
    want.sum().backward()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = call(tl, xt, None if mask is None else torch.from_numpy(mask))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._value), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(xj.grad._value), rtol=1e-4, atol=1e-4)


def test_parameter_names_and_order_match_jax():
    """named_parameters() of ErnieForMaskedLM in the JAX package's order
    (the fused AdamW bucket's flat layout follows it), decoder_bias first,
    and converting the JAX state gives exactly the port's key set and
    shapes (every Linear weight [in, out] in both)."""
    paddle.seed(0)
    jm = jernie.ErnieForMaskedLM(jernie.ernie_tiny(**TINY))
    tm = ternie.ErnieForMaskedLM(ternie.ernie_tiny(**TINY))
    names = [n for n, _ in tm.named_parameters()]
    assert names == [n for n, _ in jm.named_parameters()]
    assert names[0] == "decoder_bias" and len(names) == 44
    conv = state_from_paddle_tpu(_np_state(jm))
    assert {k: tuple(v.shape) for k, v in conv.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    back = state_to_paddle_tpu(tm.state_dict())
    assert {k: v.shape for k, v in back.items()} == {k: v.shape for k, v in _np_state(jm).items()}


def test_mlm_logits_with_padding_mask_match_jax():
    """ErnieForMaskedLM without labels: the tied decoder's logits, through
    ErnieModel's [B, S] 1/0 attention_mask (made additive [B, 1, 1, S]),
    from the same weights in f32, on ids holding the padding id."""
    paddle.seed(0)
    jm = jernie.ErnieForMaskedLM(jernie.ernie_tiny(**TINY))
    tm = _carry(jm, ternie.ErnieForMaskedLM(ternie.ernie_tiny(**TINY)))
    rng = np.random.RandomState(6)
    ids = rng.randint(1, 1024, (2, 16)).astype(np.int64)
    ids[1, 11:] = 0
    mask = (ids != 0).astype(np.int64)
    want = jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(mask))
    got = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    assert tuple(got.shape) == (2, 16, 1024)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._value), rtol=1e-4, atol=1e-5)


def test_linear_init_is_xavier_with_zero_bias():
    """nn.Linear draws its weight as paddle's: XavierUniform, std
    sqrt(2 / (in + out)), and a zero bias (torch's own Linear would give
    std 1/sqrt(3 in) and a nonzero bias)."""
    ptt.seed(0)
    lin = ptt.nn.Linear(512, 512)
    want = (2.0 / 1024) ** 0.5
    assert abs(lin.weight.std().item() / want - 1.0) < 0.1
    assert lin.weight.abs().max().item() <= (6.0 / 1024) ** 0.5
    assert torch.count_nonzero(lin.bias).item() == 0
    assert tuple(lin.weight.shape) == (512, 512) and ptt.nn.Linear(8, 4, bias_attr=False).bias is None


def test_ernie_init_follows_the_reference():
    """Every Linear and Embedding weight from Normal(0, 0.02), biases zero,
    LayerNorm ones and zeros, the padding row of the word embeddings zero,
    and every encoder layer starting from the first layer's weights."""
    ptt.seed(0)
    m = ternie.ErnieForMaskedLM(ternie.ernie_tiny(num_hidden_layers=3, **TINY))
    sd = m.state_dict()
    E = sd["ernie.embeddings.word_embeddings.weight"]
    assert torch.count_nonzero(E[0]).item() == 0
    normal = torch.cat([E[1:].reshape(-1)] + [v.reshape(-1) for k, v in sd.items()
                                              if k.endswith("proj.weight") or "linear" in k
                                              and k.endswith("weight")])
    assert abs(normal.std().item() / 0.02 - 1.0) < 0.05 and abs(normal.mean().item()) < 1e-3
    for k, v in sd.items():
        if k.endswith(".bias") or k == "decoder_bias":
            assert torch.count_nonzero(v).item() == 0, k
        if "norm" in k and k.endswith(".weight"):
            assert bool((v == 1).all()), k
    for k, v in sd.items():
        if k.startswith("ernie.encoder.layers.2."):
            assert torch.equal(v, sd[k.replace("layers.2.", "layers.0.")]), k


def test_param_attr_rejects_what_is_not_ported():
    """Everything a ParamAttr names is ported now (lr scale, regularizer and
    need_clip used to raise): they land on the parameter, where the
    optimizer and the clip read them, as the JAX package's create_parameter
    puts them."""
    reg = ptt.regularizer.L2Decay(0.1)
    w = ptt.nn.LayerNorm(4, weight_attr=ptt.nn.ParamAttr(learning_rate=0.5, regularizer=reg,
                                                         need_clip=False)).weight
    assert (w.optimize_attr, w.regularizer, w.need_clip) == ({"learning_rate": 0.5}, reg, False)
    b = ptt.nn.LayerNorm(4).bias
    assert (b.optimize_attr, b.regularizer, b.need_clip) == ({"learning_rate": 1.0}, None, True)
    attr = ptt.nn.ParamAttr(initializer=ptt.nn.initializer.Constant(0.5))
    assert bool((ptt.nn.LayerNorm(4, weight_attr=attr).weight == 0.5).all())
    assert ptt.nn.LayerNorm(4, bias_attr=False).bias is None


def test_to_tensor_matches_jax_dtypes():
    """float64 data takes the default float type, integer data keeps its
    type, a dtype argument wins, and stop_gradient=False makes a leaf."""
    cases = [(np.arange(6.0).reshape(2, 3), None), (np.arange(6, dtype=np.int64), None),
             ([1, 2, 3], "int32"), (3.5, None), (np.ones(3, np.float32), "bfloat16")]
    for data, dt in cases:
        want = paddle.to_tensor(data, dtype=dt)
        got = ptt.to_tensor(data, dtype=dt)
        assert str(got.dtype).split(".")[-1] == str(want._value.dtype), (data, dt)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want._value, np.float32))
    leaf = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert leaf.requires_grad and leaf.is_leaf and leaf.device.type == "cpu"


def test_to_static_contract():
    """A function, decorated bare or with arguments, returns what it
    returns; a Layer keeps its own forward bound; a step with backward,
    optimizer step and clear_grad runs inside."""
    f = lambda a, b: a * 2 + b
    x = torch.arange(4.0)
    assert torch.equal(ptt.jit.to_static(f)(x, 1.0), f(x, 1.0))
    assert torch.equal(ptt.jit.to_static(input_spec=None)(f)(x, 1.0), f(x, 1.0))
    ptt.seed(0)
    lin = ptt.nn.Linear(4, 3)
    want = lin(x)
    assert ptt.jit.to_static(lin) is lin and isinstance(lin.forward, ptt.jit.StaticFunction)
    assert torch.equal(lin(x), want)
    eager = ptt.nn.Linear(4, 3)
    eager.set_state_dict(lin.state_dict())

    def train_step(layer, opt, v):
        loss = layer(v).square().sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    opt, opt_eager = (ptt.optimizer.AdamW(0.1, parameters=m.parameters()) for m in (lin, eager))
    step = ptt.jit.to_static(lambda v: train_step(lin, opt, v))
    w0 = lin.weight.detach().clone()
    # the captured step updates as the eager one does, twice over
    for _ in range(2):
        assert torch.equal(step(x), train_step(eager, opt_eager, x))
    assert torch.equal(lin.weight, eager.weight) and torch.equal(lin.bias, eager.bias)
    assert not torch.equal(lin.weight, w0) and lin.weight.grad is None
    ptt.jit.enable_to_static(False)
    ptt.jit.enable_to_static(True)


def test_bench_build_train_step_runs_in_port(monkeypatch):
    """bench.py's build_train_step, as written, with the port standing in
    for the JAX package (`import paddle_tpu as paddle` resolves to
    paddle_tpu_torch) at ernie_tiny dims: seed, ErnieForMaskedLM,
    set_flags, AdamW with a bf16 moment2, to_tensor, to_static, auto_cast."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        import bench
    finally:
        sys.path.pop(0)
    for k, v in dict(BENCH_VOCAB="1024", BENCH_HIDDEN="64", BENCH_LAYERS="2",
                     BENCH_FFN="128").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setitem(sys.modules, "paddle_tpu", ptt)
    monkeypatch.setitem(sys.modules, "paddle_tpu.models", ptt.models)
    model, train_step, ids, labels = bench.build_train_step(batch=2, seq=32, heads=4)
    assert isinstance(model, ternie.ErnieForMaskedLM)
    assert ptt.get_flags("FLAGS_fused_optimizer")["FLAGS_fused_optimizer"]
    losses = [train_step(ids, labels).item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
