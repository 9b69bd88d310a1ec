"""Port parity for ERNIE training: a tiny ERNIE trained for 3 AdamW steps
through to_static in both packages from the same weights and batch (f32
and AMP O1 bf16, the flat-bucket engine on and off), against the JAX
package on the same numpy inputs. Split from test_torch_ernie.py (its four
JAX runs take ~75 s on an 8-core CPU host): a file of few tests, which
pytest-xdist's `--dist loadfile` hands out after the files with many
tests, so these runs no longer delay the heaviest JAX file."""
import numpy as np
import pytest

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import ernie as jernie

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.utils.convert import state_to_paddle_tpu

from test_torch_ernie import TINY, _carry, _np_state


@pytest.fixture(autouse=True)
def _reset():
    ptt.set_device("cpu")
    yield
    paddle.set_flags({"FLAGS_fused_optimizer": False})
    ptt.set_flags({"FLAGS_fused_optimizer": False})


def _train(pkg, fused, amp, steps=3):
    """3 AdamW steps (lr 1e-3, wd 0.01) of ErnieForMaskedLM on ernie_tiny
    (2 layers, hidden 64, 4 heads, ffn 128, vocab 1024, dropout 0) through
    to_static, on one batch B2 S32 holding id 0 (the padding id) with
    half the labels ignored; the stochastic-rounding seed of each step
    passed in as an argument, so both packages round with the same one.
    Returns (losses, params, the pooler's params before and after)."""
    paddle.seed(0)
    jm = jernie.ErnieForMaskedLM(jernie.ernie_tiny(**TINY))
    rng = np.random.RandomState(2)
    ids = rng.randint(1, 1024, (2, 32)).astype(np.int64)
    ids[0, 20:] = 0
    ids[1, 5] = 0
    labels = np.where(rng.rand(2, 32) < 0.5, ids, -100).astype(np.int64)
    seeds = [0x2545F491 * (i + 3) & 0xFFFFFFFF for i in range(steps)]
    level = "O1" if amp else "O0"
    m2 = "bfloat16" if amp else "float32"
    if pkg == "jax":
        paddle.set_flags({"FLAGS_fused_optimizer": fused})
        model, cast, tensor = jm, paddle.amp.auto_cast, paddle.to_tensor
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01,
                                     moment2_dtype=m2)
        key = lambda s: s._value.astype(jnp.uint32)
        seed_arg = lambda s: paddle.to_tensor(np.array(s, np.uint32))
    else:
        ptt.set_flags({"FLAGS_fused_optimizer": fused})
        model = _carry(jm, ternie.ErnieForMaskedLM(ternie.ernie_tiny(**TINY)))
        cast, tensor = ptt.amp.auto_cast, ptt.to_tensor
        opt = ptt.optimizer.AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01,
                                  moment2_dtype=m2)
        key = int
        seed_arg = int

    def params():
        sd = (_np_state(model) if pkg == "jax" else state_to_paddle_tpu(model.state_dict()))
        return {k: np.asarray(v, np.float32) for k, v in sd.items()}

    @(paddle if pkg == "jax" else ptt).jit.to_static
    def step(x, y, s):
        opt._m2_key = lambda: key(s)
        with cast(level=level, dtype="bfloat16"):
            loss, _ = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    before = params()
    x, y = tensor(ids), tensor(labels)
    losses = [float(np.asarray(step(x, y, seed_arg(s)).detach().numpy())) for s in seeds]
    after = params()
    pooler = {k: (before[k], after[k]) for k in after if k.startswith("ernie.pooler.")}
    return losses, after, pooler


@pytest.mark.parametrize("fused,amp", [(False, False), (True, False), (False, True),
                                       (True, True)])
def test_tiny_ernie_training_matches_jax(fused, amp):
    """Both packages from the same weights, 3 MLM steps through to_static,
    f32 or AMP-O1 bf16 (with a bf16 moment2), the flat-bucket engine on or
    off. Adam normalises the gradient, so a param whose gradient is near
    its rounding noise can move by up to lr per step either way: params
    are held to lr-relative bounds. The pooler, outside the MLM loss, has
    no gradient and must not move (not even by weight decay)."""
    lj, pj, pool_j = _train("jax", fused, amp)
    lt, pt, pool_t = _train("port", fused, amp)
    # the tiny Llama's limits (test_torch_training.py); measured here: f32
    # loss equal, params 0.0026 lr at most and 6.8e-6 lr on average; O1
    # loss 1.5e-5 relative, params 3.2 lr and 0.0088 lr
    lr = 1e-3
    if amp:
        np.testing.assert_allclose(lt, lj, rtol=5e-4)
        max_over_lr, mean_over_lr = 6.6, 0.05  # 3 steps x a flipped update (1.1 lr)
    else:
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
        max_over_lr, mean_over_lr = 0.05, 2e-5
    d = np.concatenate([np.abs(pt[k] - pj[k]).ravel() for k in pj])
    assert d.max() <= max_over_lr * lr and d.mean() <= mean_over_lr * lr, (d.max() / lr,
                                                                           d.mean() / lr)
    assert lt[-1] < lt[0]
    for pool in (pool_j, pool_t):
        assert len(pool) == 2 and all(np.array_equal(a, b) for a, b in pool.values())
