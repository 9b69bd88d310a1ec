"""A narrow two-stage ResNet written with static.nn builders
(tests/torch_static_resnet.py), trained as a static Program in both
packages from the weights of one eager port model, mapped in call order.

The logits and 3 Momentum steps' losses are held to the JAX package's.
The port's batch-norm buffers are held to an eager port run of the same
steps, not to the JAX package's: its Executor never updates them (a
reference-side fault). The eval clone (Program.clone(for_test=True))
under the EMA weights is held to the eager model in eval() with the same
weights and buffers, and its runs leave the buffers where they were.
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle

import paddle_tpu_torch as ptt
from paddle_tpu_torch.vision.models.resnet import BottleneckBlock

import torch_static_resnet as sr
from test_torch_static_nn import jax_numpy_inits

B, HW, CLASSES, WIDTH, STAGES, STEPS = 4, 16, 10, 4, (1, 1), 3
F32 = dict(rtol=1e-5, atol=1e-5)


def eager_model(seed=0):
    """The eager counterpart of sr.resnet at STAGES and WIDTH, from
    vision.models.resnet's BottleneckBlock."""
    nn = ptt.nn
    ptt.seed(seed)
    layers = [nn.Conv2D(3, WIDTH, 7, stride=2, padding=3, bias_attr=False),
              nn.BatchNorm2D(WIDTH), nn.ReLU(), nn.MaxPool2D(3, stride=2, padding=1)]
    inplanes = WIDTH
    for i, blocks in enumerate(STAGES):
        planes = WIDTH * 2 ** i
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            down = None
            if j == 0 and (stride != 1 or inplanes != planes * 4):
                down = nn.Sequential(nn.Conv2D(inplanes, planes * 4, 1, stride=stride,
                                               bias_attr=False), nn.BatchNorm2D(planes * 4))
            layers.append(BottleneckBlock(inplanes, planes, stride, down))
            inplanes = planes * 4
    layers += [nn.AdaptiveAvgPool2D(1), nn.Flatten(), nn.Linear(inplanes, CLASSES)]
    return nn.Sequential(*layers)


def _order(model, image):
    return sr.eager_call_order(model, image, ptt.nn.Conv2D, ptt.nn.BatchNorm2D, ptt.nn.Linear)


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        jax_numpy_inits(mp)  # the JAX package's weights are overwritten: spare jax.random
        return _runs()


def _runs():
    ptt.set_device("cpu")
    images, labels = sr.batch(B, HW, CLASSES)
    model = eager_model()
    params, _ = _order(model, torch.from_numpy(images))
    init = [p.detach().numpy().copy() for p in params]
    out = {"init": init, "images": images, "labels": labels}
    feed = {"image": images, "label": labels}
    for pk in (paddle, ptt):
        main, fetch, ema = sr.train_program(pk, B, HW, STAGES, WIDTH, CLASSES, ema_decay=0.9)
        mine = main.all_parameters()
        sr.check_shapes(mine, params)
        for p, a in zip(mine, init):
            if pk is ptt:
                with torch.no_grad():
                    p.copy_(torch.from_numpy(a))
            else:
                p.set_value(a)
        exe = pk.static.Executor()
        steps = []
        for _ in range(STEPS):
            steps.append([np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=[fetch["loss"], fetch["logits"], fetch["acc1"],
                                             fetch["acc5"]])])
            ema.update()
        out[pk] = dict(main=main, fetch=fetch, ema=ema, exe=exe, steps=steps)
    return out


def test_logits_and_losses_match_jax(runs):
    jax_steps, port_steps = runs[paddle]["steps"], runs[ptt]["steps"]
    np.testing.assert_allclose(port_steps[0][1], jax_steps[0][1], **F32)  # the first forward
    losses = [[s[0] for s in st] for st in (port_steps, jax_steps)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=1e-5)
    assert np.all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]
    labels = runs["labels"].reshape(-1)
    for loss, logits, acc1, acc5 in port_steps:  # accuracy is top-k of the fetched logits
        top = np.argsort(-logits, -1)
        assert acc1 == np.float32(np.mean(top[:, 0] == labels))
        assert acc5 == np.float32(np.mean((top[:, :5] == labels[:, None]).any(-1)))


def test_buffers_match_an_eager_port_run(runs):
    model = eager_model()
    images, labels = (torch.from_numpy(a) for a in (runs["images"], runs["labels"]))
    params, buffers = _order(model, images)
    with torch.no_grad():
        for p, a in zip(params, runs["init"]):
            p.copy_(torch.from_numpy(a))
    opt = ptt.optimizer.Momentum(0.1, momentum=0.9, parameters=model.parameters(),
                                 weight_decay=1e-4)
    losses = []
    for _ in range(STEPS):
        loss = ptt.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    np.testing.assert_allclose([s[0] for s in runs[ptt]["steps"]], losses, rtol=1e-5)
    got = sr.program_bn_buffers(runs[ptt]["main"])
    assert len(got) == len(buffers)
    for (gm, gv), (wm, wv) in zip(got, buffers):
        assert not torch.equal(gv, torch.ones_like(gv))
        np.testing.assert_allclose(gm.numpy(), wm.numpy(), **F32)
        np.testing.assert_allclose(gv.numpy(), wv.numpy(), **F32)


def test_eval_clone_under_ema_is_the_eager_eval(runs):
    r = runs[ptt]
    main, fetch, ema, exe = r["main"], r["fetch"], r["ema"], r["exe"]
    test = main.clone(for_test=True)
    buffers = [tuple(t.clone() for t in pair) for pair in sr.program_bn_buffers(main)]
    feed = {"image": runs["images"], "label": runs["labels"]}
    model = eager_model()
    images = torch.from_numpy(runs["images"])
    params, eager_buffers = _order(model, images)
    with ema.apply():
        outs = [exe.run(test, feed=feed, fetch_list=[fetch["logits"]])[0] for _ in range(2)]
        with torch.no_grad():
            for p, q in zip(params, main.all_parameters()):
                p.copy_(q)
            for (em, ev), (pm, pv) in zip(eager_buffers, buffers):
                em.copy_(pm)
                ev.copy_(pv)
    for (m, v), (m0, v0) in zip(sr.program_bn_buffers(main), buffers):
        assert torch.equal(m, m0) and torch.equal(v, v0)  # eval runs write nothing
    model.eval()
    with torch.no_grad():
        want = model(images).numpy()
    for out in outs:
        np.testing.assert_allclose(out, want, **F32)
    # the parameters are back from the EMA values
    assert not np.allclose(main.all_parameters()[-1].detach().numpy(),
                           params[-1].detach().numpy())
