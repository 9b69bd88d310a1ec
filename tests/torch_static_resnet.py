"""ResNet written with paddle.static.nn builders, PaddleClas's static-mode
form of the model: `static.nn.conv2d(bias_attr=False)` and
`static.nn.batch_norm(act=...)` for each conv, the pools through
`nn.functional`, `static.nn.fc` for the classifier. Each function takes
the package (`paddle_tpu` or `paddle_tpu_torch`) as an argument, so the
tests build the same graph in both packages and `chip_smoke.py` builds
ResNet-50 with the port. Imports numpy only.

The bottleneck block is v1.5 (the stride on the 3x3 conv) and calls its
downsample last, as `vision.models.resnet`'s BottleneckBlock does, so a
Program built here reads its parameters in the order the eager model
calls its layers (`eager_call_order`).
"""
import numpy as np

RESNET50_STAGES = (3, 4, 6, 3)


def bottleneck(pk, x, planes, stride, downsample):
    nn = pk.static.nn
    out = nn.batch_norm(nn.conv2d(x, planes, 1, bias_attr=False), act="relu")
    out = nn.batch_norm(nn.conv2d(out, planes, 3, stride=stride, padding=1, bias_attr=False),
                        act="relu")
    out = nn.batch_norm(nn.conv2d(out, planes * 4, 1, bias_attr=False))
    identity = x
    if downsample:
        identity = nn.batch_norm(nn.conv2d(x, planes * 4, 1, stride=stride, bias_attr=False))
    return pk.nn.functional.relu(out + identity)


def resnet(pk, image, stages=RESNET50_STAGES, width=64, num_classes=1000):
    """The logits of a bottleneck ResNet over `image` [N, 3, H, W]:
    ResNet-50 at the defaults."""
    F, nn = pk.nn.functional, pk.static.nn
    x = nn.batch_norm(nn.conv2d(image, width, 7, stride=2, padding=3, bias_attr=False),
                      act="relu")
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    inplanes = width
    for i, blocks in enumerate(stages):
        planes = width * 2 ** i
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            x = bottleneck(pk, x, planes, stride,
                           j == 0 and (stride != 1 or inplanes != planes * 4))
            inplanes = planes * 4
    return nn.fc(F.adaptive_avg_pool2d(x, 1), num_classes)


def train_program(pk, batch, hw, stages=RESNET50_STAGES, width=64, num_classes=1000, lr=0.1,
                  weight_decay=1e-4, amp=None, ema_decay=None):
    """The static training program: feeds "image" [batch (-1), 3, hw, hw]
    and "label" [batch, 1]; the loss (mean cross entropy), top-1 and
    top-5 accuracy, Momentum(lr, 0.9, weight_decay).minimize; under
    `amp` (an auto_cast level, bf16) the forward runs in it. With
    ema_decay, an ExponentialMovingAverage of the parameters. Returns
    (program, dict of the fetch targets, ema or None)."""
    st = pk.static
    main = st.Program()
    with st.program_guard(main, st.Program()):
        image = st.data("image", [batch, 3, hw, hw], "float32")
        label = st.data("label", [batch, 1], "int64")
        if amp:
            with pk.amp.auto_cast(level=amp, dtype="bfloat16"):
                logits = resnet(pk, image, stages, width, num_classes)
                loss = pk.nn.functional.cross_entropy(logits, label)
        else:
            logits = resnet(pk, image, stages, width, num_classes)
            loss = pk.nn.functional.cross_entropy(logits, label)
        acc1 = st.accuracy(logits, label, k=1)
        acc5 = st.accuracy(logits, label, k=5)
        pk.optimizer.Momentum(lr, momentum=0.9, parameters=main.all_parameters(),
                              weight_decay=weight_decay).minimize(loss)
        ema = st.ExponentialMovingAverage(ema_decay) if ema_decay else None
    return main, dict(logits=logits, loss=loss, acc1=acc1, acc5=acc5), ema


def eager_call_order(model, image, conv, bn, linear):
    """(parameters, [(running mean, running variance)]) of an eager model
    in the order one forward over `image` (in eval mode: the buffers stay)
    calls its conv, batch-norm and linear layers (the classes given):
    conv weight (and bias), batch norm weight and bias, linear weight and
    bias."""
    params, buffers, hooks = [], [], []
    training = model.training

    def hook(m, inputs):
        if isinstance(m, bn):
            params.extend([m.weight, m.bias])
            buffers.append((m._mean, m._variance))
        else:
            params.extend(t for t in (m.weight, m.bias) if t is not None)

    for m in model.sublayers():
        if isinstance(m, (conv, bn, linear)):
            hooks.append(m.register_forward_pre_hook(hook))
    model.eval()
    try:
        model(image)
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return params, buffers


def program_bn_buffers(program):
    """The port's Program: (running mean, running variance) of each
    recorded batch norm, in op order (its second and third inputs)."""
    return [tuple(program._var_tensors[op.in_refs[i][1]] for i in (1, 2))
            for op in program.ops if op.name == "batch_norm"]


def check_shapes(got, want):
    got, want = [tuple(t.shape) for t in got], [tuple(t.shape) for t in want]
    if got != want:
        raise AssertionError(f"parameters in call order differ: {len(got)} against "
                             f"{len(want)}; first difference at "
                             f"{next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)}")


def batch(n, hw, num_classes, seed=0):
    """A seeded batch: images N(0, 1) [n, 3, hw, hw] f32, labels [n, 1]
    int64."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, hw, hw).astype(np.float32),
            rng.randint(0, num_classes, (n, 1)).astype(np.int64))
