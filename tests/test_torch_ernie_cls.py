"""Port parity of ERNIE sequence classification (PaddleNLP's fine-tuning
loop, BASELINE configs[1]) written through the paddle op surface: one
function runs the loop in either package (to_tensor, astype, a padding
attention_mask, cross_entropy, AdamW under LinearWarmup, then an eval of
argmax / equal / cast / sum / metric.Accuracy under no_grad), from the
same weights and batches."""
import numpy as np
import pytest

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu.models import ernie as jernie

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu, state_to_paddle_tpu

TINY = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S, CLASSES = 4, 32, 3


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_flags({"FLAGS_fused_optimizer": False})
    paddle.set_flags({"FLAGS_fused_optimizer": False})


def batches(n, seed=0):
    """PaddleNLP-style padded batches: per-row lengths in [8, S], pad id 0."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rng.randint(8, S + 1, B)
        ids = rng.randint(1, 1024, (B, S)).astype(np.int64)
        ids[np.arange(S)[None, :] >= lens[:, None]] = 0
        out.append((ids, rng.randint(0, CLASSES, (B,)).astype(np.int64)))
    return out


def models():
    paddle.seed(0)
    jm = jernie.ErnieForSequenceClassification(jernie.ernie_tiny(**TINY), num_classes=CLASSES,
                                               dropout=0.0)
    tm = ternie.ErnieForSequenceClassification(ternie.ernie_tiny(**TINY), num_classes=CLASSES,
                                               dropout=0.0)
    tm.load_state_dict(state_from_paddle_tpu(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}))
    return jm, tm


def finetune(pkg, model, train, evals, fused):
    """The loop as a PaddleNLP script writes it; only `pkg` differs."""
    pkg.set_flags({"FLAGS_fused_optimizer": fused})
    sched = pkg.optimizer.lr.LinearWarmup(1e-3, warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    opt = pkg.optimizer.AdamW(learning_rate=sched, parameters=model.parameters(),
                              weight_decay=0.01)

    def step(ids, labels):
        mask = (ids != 0).astype("int64")
        logits = model(ids, attention_mask=mask)
        loss = pkg.nn.functional.cross_entropy(logits, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss

    losses = [float(step(pkg.to_tensor(i), pkg.to_tensor(y))) for i, y in train]
    model.eval()
    metric = pkg.metric.Accuracy()
    correct = total = 0
    with pkg.no_grad():
        for ids, y in evals:
            ids, y = pkg.to_tensor(ids), pkg.to_tensor(y)
            logits = model(ids, attention_mask=pkg.cast(ids != 0, "int64"))
            pred = pkg.argmax(logits, axis=-1)
            correct += int(pkg.sum(pkg.cast(pkg.equal(pred, y), "int64")))
            total += int(y.shape[0])
            metric.update(metric.compute(logits, pkg.unsqueeze(y, -1)))
    model.train()
    return losses, correct / total, metric.accumulate()


def test_classifier_logits_with_padding_mask_match_jax():
    jm, tm = models()
    ids, _ = batches(1)[0]
    mask = (ids != 0).astype(np.int64)
    want = np.asarray(jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(mask))._value)
    got = tm(ptt.to_tensor(ids), attention_mask=ptt.to_tensor(mask))
    assert tuple(got.shape) == (B, CLASSES)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_finetune_three_steps_matches_jax(fused):
    """3 AdamW steps (LinearWarmup to 1e-3, wd 0.01, f32) and an eval of 2
    batches: losses within 1e-5, the eval's accuracy and Accuracy metric
    equal, every parameter within 0.05 lr of the JAX package's (the
    limits of the MLM test, tests/test_torch_ernie.py)."""
    jm, tm = models()
    train, evals = batches(3, seed=1), batches(2, seed=2)
    lj, acc_j, met_j = finetune(paddle, jm, train, evals, fused)
    lt, acc_t, met_t = finetune(ptt, tm, train, evals, fused)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert acc_t == acc_j and met_t == met_j and acc_t == met_t
    pj = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    pt = state_to_paddle_tpu(tm.state_dict())
    assert set(pj) == set(pt)
    d = np.concatenate([np.abs(np.asarray(pt[k], np.float32) - pj[k]).ravel() for k in pj])
    assert d.max() <= 0.05 * 1e-3, d.max() / 1e-3


def test_classifier_parameters_and_medium_config():
    jm, tm = models()
    assert [n for n, _ in tm.named_parameters()] == [n for n, _ in jm.named_parameters()]
    med = ternie.ernie_3_0_medium(vocab_size=64)
    assert len(med.encoder.layers) == 6 and med.pooler.dense.in_features == 768
