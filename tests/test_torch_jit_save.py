"""Port parity for jit/save_load.py: jit.save -> jit.load -> run in both
packages on the same numpy inputs, the weights carried over by
utils/convert.py (f32 within rtol 1e-5, atol 1e-6, the JAX package's own
tolerance); the port's artifact bit-equal to the port's eager forward; a
dict output and a dynamic batch; the tiny ERNIE classifier whose
exported graph names `paddle_tpu_torch.flash_fwd` once a layer; an
exported fused_rms_norm naming `rms_norm_fwd`; the JAX package's
.pdiparams loaded into the port; and a fresh process that imports only
paddle_tpu_torch loading and running a saved artifact."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu.static import InputSpec as JSpec

import paddle_tpu_torch as ptt
from paddle_tpu_torch.static import InputSpec as TSpec
from paddle_tpu_torch.static import io as sio
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu
from test_torch_static import numpy_inits

F32 = dict(rtol=1e-5, atol=1e-6)
FLASH = "paddle_tpu_torch.flash_fwd.default"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np_state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


def _dict_net(pkg):
    class Net(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pkg.nn.Linear(4, 2)

        def forward(self, x):
            y = self.fc(x)
            return {"logits": y, "probs": pkg.nn.functional.softmax(y, axis=-1)}

    return Net()


def test_dict_output_and_dynamic_batch_match_jax(tmp_path):
    """tests/test_jit.py:175 in both packages: a [-1, 4] input and a dict
    output, run at batch 1, 3 and 7."""
    jn = _dict_net(paddle)
    tn = _dict_net(ptt)
    tn.set_state_dict(state_from_paddle_tpu(_np_state(jn)))
    jn.eval()
    paddle.jit.save(jn, str(tmp_path / "jax" / "m"), input_spec=[JSpec([-1, 4], "float32")])
    ptt.jit.save(tn, str(tmp_path / "port" / "m"), input_spec=[TSpec([-1, 4], "float32")])
    jl = paddle.jit.load(str(tmp_path / "jax" / "m"))
    tl = ptt.jit.load(str(tmp_path / "port" / "m"))
    assert isinstance(tl, ptt.jit.TranslatedLayer) and tl.input_shapes == [["d0", 4]]
    for bs in (1, 3, 7):
        x = np.random.RandomState(bs).randn(bs, 4).astype("float32")
        got, want = tl(torch.from_numpy(x)), jl(paddle.to_tensor(x))
        assert isinstance(got, dict) and set(got) == {"logits", "probs"}
        with torch.no_grad():
            eager = tn(torch.from_numpy(x))
        for k in got:
            assert torch.equal(got[k], eager[k])
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **F32)
    meta = json.load(open(str(tmp_path / "port" / "m.pdmeta")))
    assert meta["in_dtypes"] == ["float32"] and meta["n_outputs"] == 2
    assert "logits" in meta["out_tree"]


def test_roundtrip_state_and_jax_pdiparams(tmp_path):
    """tests/test_jit.py:139: .pdmodel and .pdiparams written, the loaded
    layer runs as the net does; the TranslatedLayer's state_dict is the
    saved one; the JAX package's .pdiparams loads into the port's net
    (weights cross packages; artifacts do not)."""
    paddle.seed(0)
    jn = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.ReLU(), paddle.nn.Linear(8, 2))
    jn.eval()
    paddle.jit.save(jn, str(tmp_path / "jax"), input_spec=[JSpec([2, 4], "float32")])
    tn = ptt.nn.Sequential(ptt.nn.Linear(4, 8), ptt.nn.ReLU(), ptt.nn.Linear(8, 2))
    tn.set_state_dict(ptt.jit.save_load.load_state(str(tmp_path / "jax.pdiparams")))
    path = str(tmp_path / "export" / "model")
    ptt.jit.save(tn, path, input_spec=[TSpec([2, 4], "float32")])
    assert os.path.exists(path + ".pdmodel") and os.path.exists(path + ".pdiparams")
    tl = ptt.jit.load(path)
    x = np.random.RandomState(0).randn(2, 4).astype("float32")
    with torch.no_grad():
        assert torch.equal(tl(x), tn(torch.from_numpy(x)))
    np.testing.assert_allclose(tl(x).numpy(), jn(paddle.to_tensor(x)).numpy(), **F32)
    state = tl.state_dict()
    assert set(state) == set(tn.state_dict())
    assert all(torch.equal(state[k], v) for k, v in tn.state_dict().items())


@pytest.mark.parametrize("runner", ["translated_layer", "executor", "predictor"])
def test_loaded_programs_carry_no_gradient(tmp_path, runner):
    """A loaded program's outputs stop the gradient, as the JAX package's
    do (their Tensors are new values), though the port's saved parameters
    require grad: jit.load's TranslatedLayer, Executor.run of
    load_inference_model's program and the Predictor's output handle."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch import static as tstatic

    paddle.seed(0)
    jn = paddle.nn.Linear(4, 2)
    jn.eval()
    tn = ptt.nn.Linear(4, 2)
    tn.set_state_dict(state_from_paddle_tpu(_np_state(jn)))
    x = np.random.RandomState(0).randn(3, 4).astype("float32")
    want = jn(paddle.to_tensor(x))
    paddle.jit.save(jn, str(tmp_path / "jax"), input_spec=[JSpec([-1, 4], "float32")])
    assert paddle.jit.load(str(tmp_path / "jax"))(paddle.to_tensor(x)).stop_gradient
    path = str(tmp_path / "port")
    if runner == "executor":
        main = tstatic.Program()
        with tstatic.program_guard(main, tstatic.Program()):
            xv = tstatic.data("x", [-1, 4], "float32")
            out = tn(xv)
        tstatic.save_inference_model(path, [xv], [out], program=main)
        prog, feeds, fetch = tstatic.load_inference_model(path)
        got = tstatic.Executor().run(prog, feed={"x": x}, fetch_list=fetch,
                                     return_numpy=False)[0]
    else:
        ptt.jit.save(tn, path, input_spec=[TSpec([-1, 4], "float32")])
        if runner == "translated_layer":
            got = ptt.jit.load(path)(x)
        else:
            config = ptt.inference.Config(path + ".pdmodel")
            config.disable_gpu()
            pred = inference.create_predictor(config)
            pred.run([x])
            got = pred.get_output_handle(pred.get_output_names()[0])._value
    assert next(tn.parameters()).requires_grad
    assert got.stop_gradient and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@pytest.fixture(scope="module")
def ernie_pair():
    from paddle_tpu.models import ErnieForSequenceClassification as JC, ErnieModel as JE
    from paddle_tpu_torch.models import ErnieForSequenceClassification as TC, ErnieModel as TE

    ptt.set_device("cpu")
    cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=64)
    with pytest.MonkeyPatch.context() as mp:
        numpy_inits(mp)
        jm = JC(JE(**cfg), num_classes=3)
    tm = TC(TE(**cfg), num_classes=3)
    tm.set_state_dict(state_from_paddle_tpu(_np_state(jm)))
    jm.eval()
    return jm, tm


def test_ernie_classifier_export_names_flash_and_matches_jax(tmp_path, ernie_pair):
    """The tiny ERNIE classifier as PaddleNLP deploys it: two [-1, -1]
    int64 inputs; the graph holds one flash op a layer; the port's
    artifact runs at [2, 8] (against the JAX package's artifact) and
    [3, 5], bit-equal to the port's eager forward."""
    jm, tm = ernie_pair
    paddle.jit.save(jm, str(tmp_path / "jax"),
                    input_spec=[JSpec([2, 8], "int64"), JSpec([2, 8], "int64")])
    spec = [TSpec([-1, -1], "int64", "input_ids"), TSpec([-1, -1], "int64", "token_type_ids")]
    ptt.jit.save(tm, str(tmp_path / "port"), input_spec=spec)
    tl = ptt.jit.load(str(tmp_path / "port"))
    assert sio.graph_ops(tl.program).count(FLASH) == 2
    jl = paddle.jit.load(str(tmp_path / "jax"))
    for b, s in ((2, 8), (3, 5)):
        rng = np.random.RandomState(b)
        ids = rng.randint(1, 128, (b, s)).astype("int64")
        tt = rng.randint(0, 2, (b, s)).astype("int64")
        got = tl(ids, tt)
        with torch.no_grad():
            assert torch.equal(got, tm(torch.from_numpy(ids), torch.from_numpy(tt)))
        if (b, s) == (2, 8):
            want = jl(paddle.to_tensor(ids), paddle.to_tensor(tt)).numpy()
            np.testing.assert_allclose(got.numpy(), want, **F32)


def test_exported_fused_rms_norm_names_its_op(tmp_path):
    """An exported fused_rms_norm keeps its kernel: the graph names
    `paddle_tpu_torch.rms_norm_fwd`, and the CPU run equals the eager one."""
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm

    class Norm(ptt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([16], default_initializer=ptt.nn.initializer.Constant(1.5))

        def forward(self, x):
            return fused_rms_norm(x, self.w)

    n = Norm()
    ptt.jit.save(n, str(tmp_path / "n"), input_spec=[TSpec([-1, 4, 16], "float32")])
    tl = ptt.jit.load(str(tmp_path / "n"))
    assert sio.graph_ops(tl.program).count("paddle_tpu_torch.rms_norm_fwd.default") == 1
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 4, 16).astype("float32"))
    with torch.no_grad():
        assert torch.equal(tl(x), n(x))


def test_not_to_static_and_ignore_module():
    def f(x):
        return x

    assert ptt.jit.not_to_static(f) is f and f._paddle_not_to_static
    assert ptt.jit.ignore_module([os]) is None


def test_fresh_process_loads_and_runs_an_artifact(tmp_path, ernie_pair):
    """Save here; load and run in a fresh python that imports only
    paddle_tpu_torch (no jax, no paddle_tpu), through create_predictor on
    the CPU: its output equals this process's eager forward."""
    _, tm = ernie_pair
    prefix = str(tmp_path / "xproc")
    ptt.jit.save(tm, prefix, input_spec=[TSpec([-1, -1], "int64"), TSpec([-1, -1], "int64")])
    rng = np.random.RandomState(5)
    ids = rng.randint(1, 128, (4, 6)).astype("int64")
    tt = np.zeros_like(ids)
    np.save(str(tmp_path / "ids.npy"), ids)
    child = f"""
import sys
sys.path.insert(0, {json.dumps(REPO)})
import numpy as np
from paddle_tpu_torch.inference import Config, create_predictor
cfg = Config({json.dumps(prefix)})
cfg.disable_gpu()
pred = create_predictor(cfg)
ids = np.load({json.dumps(str(tmp_path / 'ids.npy'))})
(out,) = pred.run([ids, np.zeros_like(ids)])
np.save({json.dumps(str(tmp_path / 'out.npy'))}, out)
assert "jax" not in sys.modules and "paddle_tpu" not in sys.modules
print("CHILD_OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                       timeout=300, env=env)
    assert "CHILD_OK" in r.stdout, r.stdout + r.stderr
    with torch.no_grad():
        want = tm(torch.from_numpy(ids), torch.from_numpy(tt)).numpy()
    np.testing.assert_array_equal(np.load(str(tmp_path / "out.npy")), want)
