"""Guards of three repaired faults of the port's static path.

C8: the fused AdamW's plain update (and the static Adam) took torch's
CPU square root, which is not correctly rounded on every host; the root
is now the f64 root rounded once, the correctly rounded one.
C9: the capture's dry run wrote batch norm's running buffers; it now
leaves them alone, and the recorded op's replay writes them.
C10: Program.clone(for_test=True) kept training-mode ops; its batch
norms now normalize with the buffers and write nothing, and its
dropouts (also inside a fused op) are off.
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu_torch as ptt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.ops import fused_optimizer as fo


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_flags({"FLAGS_program_passes": True})


def test_c8_update_root_is_the_f64_rounded_root():
    rng = np.random.RandomState(0)
    n = 10 ** 5
    p, m, g = (rng.randn(n).astype("float32") for _ in range(3))
    v = rng.uniform(0, 4, n).astype("float32")
    lr, c1, c2, b1, b2, eps = 1e-3, 0.19, 0.0199, 0.9, 0.999, 1e-8
    got_p, got_m, got_v = fo._update_math(
        *(torch.from_numpy(a) for a in (p, m, v, g)), lr, 1.0, c1, c2,
        beta1=b1, beta2=b2, eps=eps, wd=0.01, decoupled=True)
    # the same formula in numpy, every step f32, the root np.sqrt's
    f = np.float32
    m_new = f(b1) * m + f(1.0 - b1) * g
    v_new = f(b2) * v + f(1.0 - b2) * g * g
    root = np.sqrt(v_new / f(c2))
    np.testing.assert_array_equal(
        root, np.sqrt((v_new / f(c2)).astype(np.float64)).astype(np.float32))
    upd = (m_new / f(c1)) / (root + f(eps)) + f(0.01) * p
    np.testing.assert_array_equal(got_m.numpy(), m_new)
    np.testing.assert_array_equal(got_v.numpy(), v_new)
    np.testing.assert_array_equal(got_p.numpy(), p - f(lr) * upd)
    x = torch.from_numpy(v)
    np.testing.assert_array_equal(fo.sqrt_rn(x).numpy(), np.sqrt(v))


def _bn_model():
    ptt.seed(0)
    return ptt.nn.Sequential(ptt.nn.Conv2D(3, 4, 3, padding=1), ptt.nn.BatchNorm2D(4),
                             ptt.nn.ReLU())


def _buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()}


def test_c9_capture_leaves_the_buffers_and_replays_write_them():
    feeds = [np.random.RandomState(i).randn(2, 3, 5, 5).astype("float32") + 3 for i in range(3)]
    model = _bn_model()
    init = _buffers(model)
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2, 3, 5, 5])
        y = model(x)
    for k, v in model.named_buffers():
        assert torch.equal(v, init[k]), k  # building the program ran nothing
    exe = tstatic.Executor()
    for f in feeds:
        exe.run(main, feed={"x": f}, fetch_list=[y])
    eager = _bn_model()
    for f in feeds:
        eager(torch.from_numpy(f))
    for (k, v), (_, w) in zip(model.named_buffers(), eager.named_buffers()):
        assert not torch.equal(v, init[k])
        assert torch.equal(v, w), k


def _dropout_model():
    ptt.seed(1)
    bn = ptt.nn.BatchNorm2D(3)
    bias = ptt.create_parameter([3, 4, 4], "float32")
    drop = ptt.nn.Dropout(0.5)
    return bn, bias, drop


@pytest.mark.parametrize("passes", [True, False])
def test_c10_test_clone_runs_in_inference_mode(passes):
    ptt.set_flags({"FLAGS_program_passes": passes})
    rng = np.random.RandomState(0)
    train_feed = {"x": rng.randn(2, 3, 4, 4).astype("float32") * 2 + 1}
    test_feed = {"x": rng.randn(2, 3, 4, 4).astype("float32")}
    bn, bias, drop = _dropout_model()
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2, 3, 4, 4])
        h = bn(x)
        y = drop(h + bias) + h  # bias -> dropout -> residual: fused with the passes on
    ops_before = list(main.ops)
    exe = tstatic.Executor()
    exe.run(main, feed=train_feed, fetch_list=[y])  # moves the buffers
    test = main.clone(for_test=True)
    assert main.ops == ops_before  # the training program is unchanged
    assert not test.grad_requests and not test.opt_updates
    buffers = _buffers(bn)
    outs = [exe.run(test, feed=test_feed, fetch_list=[y])[0] for _ in range(2)]
    for k, v in bn.named_buffers():
        assert torch.equal(v, buffers[k]), k  # eval runs write nothing
    bn.eval()
    drop.eval()
    with torch.no_grad():
        xt = torch.from_numpy(test_feed["x"])
        want = (drop(bn(xt) + bias) + bn(xt)).numpy()
    for out in outs:
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    bn.train()
    (again,) = exe.run(main, feed=train_feed, fetch_list=[y])
    assert not torch.equal(bn._mean, buffers["_mean"])  # the training program still trains
    assert not np.allclose(again, outs[0])
