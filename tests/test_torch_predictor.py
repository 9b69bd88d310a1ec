"""Port parity for the frozen-program Predictor (inference/__init__.py),
tests/test_inference.py's cases in both packages on the same numpy
inputs, the weights carried over by utils/convert.py (f32 within rtol
1e-5, atol 1e-6): a static artifact's handles and dynamic batch, a
jit.save artifact and its clone, Config's forms and switches, the unset
input's RuntimeError, PredictorPool, the r5 names, and
convert_to_mixed_precision. The Predictor runs on the card unless
Config.disable_gpu(): without one it raises rather than run on the CPU."""
import json

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
import paddle_tpu.inference as jinf
from paddle_tpu import static as jstatic

import paddle_tpu_torch as ptt
import paddle_tpu_torch.inference as tinf
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.static import io as sio
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np_state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


def _cpu_config(*args):
    cfg = tinf.Config(*args)
    cfg.disable_gpu()
    return cfg


@pytest.fixture(scope="module")
def static_artifacts(tmp_path_factory):
    """tests/test_inference.py's _export_static in both packages from one
    Linear(4, 3): {"jax": prefix, "port": prefix}, in directories of their
    own (the directory form of Config)."""
    ptt.set_device("cpu")
    root = tmp_path_factory.mktemp("static")
    jl = paddle.nn.Linear(4, 3)
    tl = ptt.nn.Linear(4, 3)
    tl.load_state_dict(state_from_paddle_tpu(_np_state(jl)))
    out = {}
    for pkg, st, lin, key in ((paddle, jstatic, jl, "jax"), (ptt, tstatic, tl, "port")):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            x = st.data("x", [-1, 4], "float32")
            y = pkg.nn.functional.softmax(lin(x), axis=-1)
        out[key] = str(root / key / "model")
        st.save_inference_model(out[key], [x], [y], st.Executor(), program=main)
    return out


def test_predictor_static_artifact_matches_jax(static_artifacts):
    """Handles, run(), and another batch through the same predictor."""
    jp = jinf.create_predictor(jinf.Config(static_artifacts["jax"]))
    tp = tinf.create_predictor(_cpu_config(static_artifacts["port"]))
    assert isinstance(tp, tinf.Predictor)
    assert tp.get_input_names() == jp.get_input_names() == ["x"]
    assert tp.get_output_names() == jp.get_output_names() == ["output_0"]
    xv = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    for p in (jp, tp):
        p.get_input_handle("x").copy_from_cpu(xv)
        assert p.run() is None
    got = tp.get_output_handle("output_0").copy_to_cpu()
    np.testing.assert_allclose(got, jp.get_output_handle("output_0").copy_to_cpu(), **F32)
    assert tp.get_output_handle("output_0").shape() == [5, 3]
    xv2 = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    (got2,) = tp.run([xv2])
    np.testing.assert_allclose(got2, jp.run([xv2])[0], **F32)


def test_predictor_jit_artifact_and_clone(tmp_path):
    """A jit.save artifact: positional input names, the output within F32
    of the JAX package's and bit-equal to the port's eager forward; the
    clone shares the program."""
    paddle.seed(1)
    jm = paddle.nn.Sequential(paddle.nn.Linear(6, 8), paddle.nn.ReLU(), paddle.nn.Linear(8, 2))
    jm.eval()
    tm = ptt.nn.Sequential(ptt.nn.Linear(6, 8), ptt.nn.ReLU(), ptt.nn.Linear(8, 2))
    tm.set_state_dict(state_from_paddle_tpu(_np_state(jm)))
    paddle.jit.save(jm, str(tmp_path / "j"), input_spec=[jstatic.InputSpec([3, 6], "float32")])
    ptt.jit.save(tm, str(tmp_path / "t"), input_spec=[tstatic.InputSpec([3, 6], "float32")])
    jp = jinf.create_predictor(jinf.Config(str(tmp_path / "j")))
    tp = tinf.create_predictor(_cpu_config(str(tmp_path / "t.pdmodel")))
    assert tp.get_input_names() == jp.get_input_names() == ["input_0"]
    xv = np.random.RandomState(2).randn(3, 6).astype(np.float32)
    (got,) = tp.run([xv])
    with torch.no_grad():
        np.testing.assert_array_equal(got, tm(torch.from_numpy(xv)).numpy())
    np.testing.assert_allclose(got, jp.run([xv])[0], **F32)
    clone = tp.clone()
    assert clone._module is tp._module and clone._inputs is not tp._inputs
    (got2,) = clone.run([xv])
    np.testing.assert_array_equal(got2, got)


def test_config_surface(static_artifacts):
    """The directory form, the model/params paths, the recorded switches,
    and the RuntimeError for an input that was not set."""
    import os

    d = os.path.dirname(static_artifacts["port"])
    cfg = tinf.Config(d)
    cfg.enable_use_gpu(100, 0)
    cfg.enable_memory_optim()
    cfg.switch_ir_optim(True)
    cfg.enable_tensorrt_engine()
    assert cfg.use_gpu() and cfg.gpu_device_id() == 0
    assert cfg.prog_file() == static_artifacts["port"] + ".pdmodel"
    assert cfg.params_file() == static_artifacts["port"] + ".pdiparams"
    assert cfg.model_dir() == d and "tensorrt" in cfg.summary()
    assert tinf.Config("a.pdmodel", "b.pdiparams").params_file() == "b.pdiparams"
    cfg.disable_gpu()
    assert not cfg.use_gpu()
    pred = tinf.create_predictor(cfg)
    assert pred.get_input_names() == ["x"]
    with pytest.raises(RuntimeError, match="not set"):
        pred.run()


def test_predictor_without_a_card_raises(static_artifacts):
    """No fallback: a Config left on the card raises where CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the Predictor runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.create_predictor(tinf.Config(static_artifacts["port"]))


def test_jax_artifact_raises_a_named_error(static_artifacts):
    with pytest.raises(sio.ArtifactFormatError):
        tinf.create_predictor(_cpu_config(static_artifacts["jax"]))


def test_inference_r5_surface(static_artifacts):
    """tests/test_inference.py's r5 names: DataType and byte sizes, the
    version banner, TensorRT versions, phi kernel names, XpuConfig, and
    PredictorPool (clones over one program, run alike)."""
    for name in ("FLOAT32", "BFLOAT16", "INT64", "BOOL"):
        dt = getattr(tinf.DataType, name)
        assert dt == getattr(jinf.DataType, name)
        assert tinf.get_num_bytes_of_data_type(dt) == jinf.get_num_bytes_of_data_type(dt)
    with pytest.raises(ValueError):
        tinf.get_num_bytes_of_data_type(12345)
    assert "version" in tinf.get_version()
    assert tinf.get_trt_compile_version() == tinf.get_trt_runtime_version() == (0, 0, 0)
    for op in ("elementwise_add", "matmul_v2", "matmul"):
        assert tinf._get_phi_kernel_name(op) == jinf._get_phi_kernel_name(op)
    assert tinf.XpuConfig(device_id=1).device_id == 1
    assert tinf.PlaceType.GPU == jinf.PlaceType.GPU
    pool = tinf.PredictorPool(_cpu_config(static_artifacts["port"]), 3)
    xv = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    (a,) = pool.retrieve(0).run([xv])
    (b,) = pool.retrieve(2).run([xv])
    np.testing.assert_array_equal(a, b)
    assert pool.retrieve(2)._module is pool.retrieve(0)._module
    with pytest.raises(ValueError):
        tinf.PredictorPool(_cpu_config(static_artifacts["port"]), 0)


@pytest.mark.parametrize("precision", ["Half", "Bfloat16"])
def test_convert_to_mixed_precision(tmp_path, precision):
    """The .pdiparams cast (f32 entries; the black list kept), the program
    copied as it is with a warning, the .pdmeta recording the precision;
    the JAX package's float16 payload has the same dtypes and values."""
    tm = ptt.nn.Sequential(ptt.nn.Linear(6, 8), ptt.nn.ReLU(), ptt.nn.Linear(8, 2))
    prefix, out = str(tmp_path / "jm"), str(tmp_path / "mixed")
    ptt.jit.save(tm, prefix, input_spec=[tstatic.InputSpec([3, 6], "float32")])
    mp = getattr(tinf.PrecisionType, precision)
    with pytest.warns(UserWarning, match="baked into the program"):
        tinf.convert_to_mixed_precision(prefix + ".pdmodel", prefix + ".pdiparams",
                                        out + ".pdmodel", out + ".pdiparams",
                                        mixed_precision=mp, black_list=["2.bias"])
    conv = ptt.jit.save_load.load_state(out + ".pdiparams")
    want = torch.float16 if precision == "Half" else torch.bfloat16
    assert conv["2.bias"].dtype == torch.float32
    assert {v.dtype for k, v in conv.items() if k != "2.bias"} == {want}
    assert torch.equal(conv["0.weight"], tm.state_dict()["0.weight"].to(want))
    assert json.load(open(out + ".pdmeta"))["mixed_precision"] == int(mp)
    assert open(out + ".pdmodel", "rb").read() == open(prefix + ".pdmodel", "rb").read()
    (got,) = tinf.create_predictor(_cpu_config(out)).run(
        [np.ones((3, 6), np.float32)])
    with torch.no_grad():
        np.testing.assert_array_equal(got, tm(torch.ones(3, 6)).numpy())
    if precision == "Half":
        # the JAX package's converter on its own artifact of the same weights
        jm = paddle.nn.Sequential(paddle.nn.Linear(6, 8), paddle.nn.ReLU(),
                                  paddle.nn.Linear(8, 2))
        jm.set_state_dict({k: paddle.to_tensor(v.numpy()) for k, v in tm.state_dict().items()})
        jpre = str(tmp_path / "j")
        paddle.jit.save(jm, jpre, input_spec=[jstatic.InputSpec([3, 6], "float32")])
        with pytest.warns(UserWarning):
            jinf.convert_to_mixed_precision(jpre + ".pdmodel", jpre + ".pdiparams",
                                            jpre + "_m.pdmodel", jpre + "_m.pdiparams",
                                            mixed_precision=jinf.PrecisionType.Half,
                                            black_list=["2.bias"])
        from paddle_tpu.framework import io as jio

        jconv = jio.load(jpre + "_m.pdiparams")
        assert set(jconv) == set(conv)
        for k, v in jconv.items():
            np.testing.assert_array_equal(conv[k].numpy(), np.asarray(v))
