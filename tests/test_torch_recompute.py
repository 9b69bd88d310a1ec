"""Port parity for activation recompute (distributed/fleet/recompute) and
gradient accumulation: the tiny Llama with recompute=True against itself
without it (bit-equal) and against the JAX package's recompute; a
recomputed segment with dropout that names no seed (the replay must draw
the forward's seeds and leave the framework generator advanced once);
bench.py's micro=2 Llama step against the JAX package's."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu, state_to_paddle_tpu

TINY = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=176)


@pytest.fixture(autouse=True)
def _reset():
    ptt.set_device("cpu")
    yield
    paddle.set_flags({"FLAGS_fused_optimizer": False})
    ptt.set_flags({"FLAGS_fused_optimizer": False})


@pytest.fixture(scope="module")
def weights():
    """The JAX package's tiny Llama weights from seed 0, as numpy."""
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(**TINY)
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _port_model(weights, recompute):
    model = tllama.LlamaForCausalLM(**TINY, recompute=recompute, device="cpu")
    model.load_state_dict(state_from_paddle_tpu(weights))
    return model


def _jax_model(weights, recompute):
    paddle.seed(0)
    model = jllama.LlamaForCausalLM(**TINY, recompute=recompute)
    model.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    return model


def _ids(batch=2, seq=48, seed=1):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"], (batch, seq)).astype(np.int64)


@pytest.mark.parametrize("level", ["O0", "O1"])
def test_recompute_is_bit_equal_in_port(weights, level):
    """Loss and every gradient with recompute=True equal those without, bit
    for bit (the replay runs the same ops on the same inputs; under O1 it
    casts as the forward did although the backward runs outside auto_cast)."""
    x = torch.from_numpy(_ids())
    out = []
    for recompute in (False, True):
        model = _port_model(weights, recompute)
        with ptt.amp.auto_cast(level=level, dtype="bfloat16"):
            loss, _ = model(x, labels=x)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def _micro_step_run(pkg, weights, recompute, micro, level, steps=2):
    """bench.py's _build_llama_at step (bench.py:502-510) at the tiny
    width: `micro` rows stepped as grad-accumulated micro-batches of one
    row, (loss / micro).backward() each, then one AdamW step (1e-3, wd
    0.01) and clear_grad. Returns (losses of the last micro-batch, params)."""
    ids, labels = _ids(micro, 48, 2), _ids(micro, 48, 3)
    if pkg == "jax":
        model = _jax_model(weights, recompute)
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01)
        ids, labels = paddle.to_tensor(ids), paddle.to_tensor(labels)
        cast = paddle.amp.auto_cast
    else:
        model = _port_model(weights, recompute)
        opt = ptt.optimizer.AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01)
        ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
        cast = ptt.amp.auto_cast
    losses = []
    for _ in range(steps):
        loss = None
        for i in range(micro):
            with cast(level=level, dtype="bfloat16"):
                loss, _ = model(ids[i:i + 1], labels=labels[i:i + 1])
            (loss * (1.0 / micro)).backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()) if pkg == "jax" else loss.item())
    if pkg == "jax":
        return losses, {k: np.asarray(v._value, np.float32) for k, v in model.state_dict().items()}
    return losses, state_to_paddle_tpu(model.state_dict())


@pytest.mark.parametrize("recompute,micro,level", [(True, 1, "O0"), (True, 2, "O0"),
                                                   (False, 2, "O1"), (True, 2, "O1")])
def test_micro_batch_step_matches_jax(weights, recompute, micro, level):
    """The bench's step, recompute and micro-batching as its ladder's rungs
    set them, 2 AdamW steps in both packages from the same weights: f32
    tightly (the same operations summed in another order), O1 within
    test_torch_training's bf16 limits (GEMMs round at other points)."""
    lj, pj = _micro_step_run("jax", weights, recompute, micro, level)
    lt, pt = _micro_step_run("port", weights, recompute, micro, level)
    lr = 1e-3
    if level == "O1":
        np.testing.assert_allclose(lt, lj, rtol=5e-4)
        max_over_lr, mean_over_lr = 4.4, 0.05  # 2 steps x a flipped update (1.1 lr)
    else:
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
        max_over_lr, mean_over_lr = 0.05, 2e-5
    d = np.concatenate([np.abs(pt[k] - pj[k]).ravel() for k in pj])
    assert d.max() <= max_over_lr * lr and d.mean() <= mean_over_lr * lr, (d.max() / lr,
                                                                           d.mean() / lr)


def test_grad_accumulation_is_the_mean_of_the_micro_batches(weights):
    """Two backward passes of (loss / 2) on one row each leave in .grad the
    sum of the halves, the gradient of the two rows' mean loss; clear_grad
    empties it."""
    ids = torch.from_numpy(_ids(2, 48, 4))
    model = _port_model(weights, False)
    for i in range(2):
        loss, _ = model(ids[i:i + 1], labels=ids[i:i + 1])
        (loss * 0.5).backward()
    acc = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    parts = []
    for i in range(2):
        loss, _ = model(ids[i:i + 1], labels=ids[i:i + 1])
        parts.append(loss)
    ((parts[0] + parts[1]) * 0.5).backward()
    for n, p in model.named_parameters():
        torch.testing.assert_close(acc[n], p.grad, rtol=1e-5, atol=1e-7)
    opt = ptt.optimizer.AdamW(1e-3, parameters=model.parameters())
    opt.clear_grad()
    assert all(p.grad is None for p in model.parameters())


class _DropSegment(torch.nn.Module):
    """Linear, attention with dropout and element dropout, neither naming a
    seed: both draw one from the framework generator."""

    def __init__(self):
        super().__init__()
        self.lin = ptt.nn.Linear(16, 16)

    def forward(self, x):
        h = self.lin(x).reshape(1, 8, 2, 8)
        h = ptt.nn.functional.scaled_dot_product_attention(h, h, h, dropout_p=0.3, is_causal=True)
        return ptt.nn.functional.dropout(h.reshape(8, 16), p=0.4)


def test_recompute_replays_dropout_seeds(weights):
    """A recomputed segment whose dropouts draw their seeds gives the same
    output and gradients as the plain call from the same generator state,
    and leaves the generator where the plain call leaves it (advanced once
    per segment, not twice)."""
    torch.manual_seed(0)
    seg = _DropSegment()
    x0 = torch.from_numpy(np.random.RandomState(5).randn(8, 16).astype(np.float32))
    runs = []
    for use_ckpt in (False, True):
        ptt.seed(123)
        x = x0.clone().requires_grad_(True)
        y = ptt.distributed.fleet.utils.recompute(seg, x) if use_ckpt else seg(x)
        after_forward = trandom.get_rng_state()["cpu"].clone()
        y.square().sum().backward()
        runs.append(dict(y=y.detach(), gx=x.grad, gw=seg.lin.weight.grad.clone(),
                         fwd_state=after_forward, end_state=trandom.get_rng_state()["cpu"]))
        seg.zero_grad()
    plain, ckpt = runs
    assert torch.equal(plain["y"], ckpt["y"])
    assert torch.equal(plain["gx"], ckpt["gx"]) and torch.equal(plain["gw"], ckpt["gw"])
    assert torch.equal(ckpt["end_state"], ckpt["fwd_state"])  # the replay drew nothing net
    assert torch.equal(ckpt["end_state"], plain["end_state"])


def test_recompute_sequential_and_entry_points():
    """recompute_sequential in 2 segments equals the plain Sequential,
    output and grads; recompute_hybrid takes a dict ctx; the entry points
    sit where the JAX package exports them; without grad mode recompute
    is a plain call."""
    torch.manual_seed(1)
    seq = ptt.nn.Sequential(ptt.nn.Linear(6, 12), ptt.nn.ReLU(), ptt.nn.Linear(12, 12),
                            ptt.nn.ReLU(), ptt.nn.Linear(12, 3))
    x0 = torch.randn(5, 6)
    grads = []
    for fn in (lambda x: seq(x),
               lambda x: ptt.distributed.fleet.recompute_sequential({"segments": 2}, seq, x),
               lambda x: ptt.distributed.fleet.recompute_hybrid({"mp_group": None}, seq, x)):
        x = x0.clone().requires_grad_(True)
        y = fn(x)
        y.sum().backward()
        grads.append((y.detach(), x.grad, [p.grad.clone() for p in seq.parameters()]))
        seq.zero_grad()
    for y, gx, gp in grads[1:]:
        assert torch.equal(y, grads[0][0]) and torch.equal(gx, grads[0][1])
        assert all(torch.equal(a, b) for a, b in zip(gp, grads[0][2]))
    with pytest.raises(TypeError):
        ptt.distributed.fleet.recompute_hybrid("mp", seq, x0)
    assert ptt.distributed.recompute is ptt.distributed.fleet.utils.recompute
    with torch.no_grad():
        assert torch.equal(ptt.distributed.recompute(seq, x0), seq(x0))
