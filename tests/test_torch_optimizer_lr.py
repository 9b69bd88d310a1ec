"""Port parity for the optimizer side of the ResNet slice: every LR
scheduler's last_lr sequence (exact), SGD and Momentum against the JAX
package bit for bit in f32 (nesterov or not; float, L2 and L1 decay; a
scheduler), the optimizer's LR plumbing, and the repaired refusals:
an L2Decay as Adam's weight decay, a list of param groups."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu import regularizer as jregularizer

import paddle_tpu_torch as ptt


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


SCHEDULERS = {
    "NoamDecay": dict(d_model=64, warmup_steps=5, learning_rate=2.0),
    "PiecewiseDecay": dict(boundaries=[3, 10, 20], values=[0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
    "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.2),
    "PolynomialDecay": dict(learning_rate=0.5, decay_steps=12, end_lr=0.01, power=2.0),
    "PolynomialDecay_cycle": dict(learning_rate=0.5, decay_steps=7, end_lr=0.01, cycle=True),
    "LinearWarmup": dict(learning_rate=0.3, warmup_steps=6, start_lr=0.0, end_lr=0.3),
    "LinearWarmup_sched": dict(warmup_steps=6, start_lr=0.01, end_lr=0.3),
    "ExponentialDecay": dict(learning_rate=0.5, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.5, milestones=[4, 9, 17], gamma=0.3),
    "StepDecay": dict(learning_rate=0.5, step_size=4, gamma=0.5),
    "LambdaDecay": dict(learning_rate=0.5, lr_lambda=lambda e: 0.95 ** e),
    "MultiplicativeDecay": dict(learning_rate=0.5, lr_lambda=lambda e: 0.9),
    "ReduceOnPlateau": dict(learning_rate=0.5, patience=2, factor=0.5, cooldown=1),
    "CosineAnnealingDecay": dict(learning_rate=0.5, T_max=11, eta_min=0.01),
    "CosineAnnealingWarmRestarts": dict(learning_rate=0.5, T_0=4, T_mult=2, eta_min=0.01),
    "OneCycleLR": dict(max_learning_rate=0.5, total_steps=25),
    "OneCycleLR_linear": dict(max_learning_rate=0.5, total_steps=25, anneal_strategy="linear"),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.5, step_size_up=4),
    "CyclicLR_triangular2": dict(base_learning_rate=0.01, max_learning_rate=0.5, step_size_up=3,
                                 step_size_down=5, mode="triangular2"),
    "CyclicLR_exp_range": dict(base_learning_rate=0.01, max_learning_rate=0.5, step_size_up=4,
                               mode="exp_range", exp_gamma=0.9),
    "LinearLR": dict(learning_rate=0.5, total_steps=12, start_factor=0.25),
}


def _make(lib, case):
    kw = dict(SCHEDULERS[case])
    cls = getattr(lib.optimizer.lr, case.split("_")[0])
    if case == "LinearWarmup_sched":
        kw["learning_rate"] = lib.optimizer.lr.StepDecay(0.3, step_size=5, gamma=0.5)
    return cls(**kw)


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_scheduler_sequence_matches_jax_exactly(case):
    """30 steps of every scheduler (the 17 classes, some in a second mode):
    the same last_lr, float for float (ReduceOnPlateau fed one metric
    sequence that plateaus)."""
    seqs = []
    for lib in (paddle, ptt):
        sched, seq = _make(lib, case), []
        for i in range(30):
            seq.append(sched.last_lr)
            if case == "ReduceOnPlateau":
                sched.step(max(1.0 - 0.1 * i, 0.5))
            else:
                sched.step()
        seqs.append(seq + [sched()])
    assert seqs[1] == seqs[0]
    assert len(set(seqs[1])) > 1


def test_every_jax_scheduler_is_ported():
    jax_names = {n for n, c in vars(paddle.optimizer.lr).items()
                 if isinstance(c, type) and issubclass(c, paddle.optimizer.lr.LRScheduler)}
    port_names = {n for n, c in vars(ptt.optimizer.lr).items()
                  if isinstance(c, type) and issubclass(c, ptt.optimizer.lr.LRScheduler)}
    assert port_names == jax_names and len(jax_names) == 18  # the base and 17 schedulers
    assert {c.split("_")[0] for c in SCHEDULERS} == jax_names - {"LRScheduler"}


DECAYS = {"none": None, "float": 0.01, "l2": ("L2Decay", 0.01), "l1": ("L1Decay", 0.003)}


def _decay(lib_reg, spec):
    return getattr(lib_reg, spec[0])(spec[1]) if isinstance(spec, tuple) else spec


def _run_opt(pkg, opt_name, nesterov, decay, scheduled, steps=3):
    """`steps` updates of three f32 params from seeded values, each step's
    grad a seeded array (loss = sum(p * g), so p.grad is g exactly)."""
    rng = np.random.RandomState(1)
    shapes = [(5, 3), (7,), (2, 3, 4)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(steps)]
    lib = paddle if pkg == "jax" else ptt
    reg = jregularizer if pkg == "jax" else ptt.regularizer
    if pkg == "jax":
        params = [paddle.create_parameter(list(a.shape), "float32") for a in init]
        for p, a in zip(params, init):
            p.set_value(a)
    else:
        params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    lr = lib.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.7) if scheduled else 0.1
    kw = dict(parameters=params, weight_decay=_decay(reg, DECAYS[decay]))
    if opt_name == "Momentum":
        kw.update(momentum=0.9, use_nesterov=nesterov)
    opt = getattr(lib.optimizer, opt_name)(lr, **kw)
    for step_grads in grads:
        loss = sum((p * (paddle.to_tensor(g) if pkg == "jax" else torch.from_numpy(g))).sum()
                   for p, g in zip(params, step_grads))
        loss.backward()
        opt.step()
        opt.clear_grad()
        if scheduled:
            lr.step()
    return [np.asarray(p._value) if pkg == "jax" else p.detach().numpy() for p in params]


@pytest.mark.parametrize("scheduled", [False, True], ids=["const_lr", "step_decay"])
@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("opt_name,nesterov", [("SGD", False), ("Momentum", False),
                                               ("Momentum", True)])
def test_sgd_momentum_bit_exact_with_jax(opt_name, nesterov, decay, scheduled):
    """SGD and Momentum (nesterov or not) with no decay, a float, an L2Decay
    or an L1Decay (sign), at a constant lr or under a StepDecay stepped
    each step: 3 updates give the JAX package's f32 params bit for bit."""
    want = _run_opt("jax", opt_name, nesterov, decay, scheduled)
    got = _run_opt("port", opt_name, nesterov, decay, scheduled)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_optimizer_lr_plumbing():
    """With a scheduler: get_lr reads its last_lr, step() rounds it to f32
    for the update, set_lr raises, set_lr_scheduler swaps it; without one
    set_lr rounds to f32. A learning rate of another type raises."""
    p = torch.nn.Parameter(torch.zeros(3))
    sched = ptt.optimizer.lr.PiecewiseDecay([1], [0.1, 0.3])
    opt = ptt.optimizer.SGD(sched, parameters=[p])
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)
    sched.step()
    assert opt.get_lr() == 0.3
    p.grad = torch.ones(3)
    opt.step()
    assert opt._lr == float(np.float32(0.3)) and torch.equal(p.detach(), -torch.full((3,), opt._lr))
    opt.set_lr_scheduler(ptt.optimizer.lr.ExponentialDecay(0.2, gamma=0.5))
    assert opt.get_lr() == 0.2
    plain = ptt.optimizer.Momentum(0.1, parameters=[p])
    plain.set_lr(1.0 / 3)
    assert plain.get_lr() == float(np.float32(1.0 / 3))
    with pytest.raises(TypeError):
        ptt.optimizer.SGD("0.1", parameters=[p])


def test_regularizer_decay_in_adamw_and_param_groups_refused():
    """An L2Decay as Adam/AdamW's weight_decay is its coefficient (it used
    to fail in float()), as in the JAX package; a list of param-group
    dicts (refused until param groups were ported) now trains, its
    `learning_rate` a scale of the optimizer's lr."""
    results = []
    for wd in (0.01, ptt.regularizer.L2Decay(0.01)):
        p = torch.nn.Parameter(torch.arange(4.0))
        opt = ptt.optimizer.AdamW(0.1, parameters=[p], weight_decay=wd)
        p.grad = torch.ones(4)
        opt.step()
        results.append(p.detach().clone())
    assert torch.equal(results[0], results[1])
    assert repr(ptt.regularizer.L1Decay(0.5)) == "L1Decay(0.5)"
    for cls in (ptt.optimizer.Momentum, ptt.optimizer.AdamW):
        moved = []
        for lr, groups in ((0.1, True), (0.05, False)):
            p = torch.nn.Parameter(torch.arange(2.0))
            params = [{"params": [p], "learning_rate": 0.5}] if groups else [p]
            opt = cls(lr, parameters=params)
            p.grad = torch.tensor([0.5, -2.0])
            opt.step()
            moved.append(p.detach().clone())
        assert torch.equal(moved[0], moved[1]), cls  # 0.1 x 0.5 rounds to f32(0.05)
