"""Port parity for static/io.py and the serialization names of
static/extras.py: save_inference_model -> load_inference_model ->
Executor.run in both packages on the same numpy inputs, the weights
carried over by utils/convert.py (f32 within rtol 1e-5, atol 1e-6, the
JAX package's own tolerance); the port's artifact bit-equal to the port's
eager run; the tiny Llama's exported Program naming the flash op
`paddle_tpu_torch.flash_fwd` once a fused attention; static.save/load,
serialize/deserialize_program and _persistables; the registered ops'
CPU implementations against their plain functions; and the named error
for the JAX package's artifact."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu import static as jstatic

import paddle_tpu_torch as ptt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.static import io as sio
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu
from test_torch_static import numpy_inits

F32 = dict(rtol=1e-5, atol=1e-6)
FLASH = "paddle_tpu_torch.flash_fwd.default"


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np_state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


def _softmax_program(pkg, st, lin, batch=-1):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [batch, 4], "float32")
        out = pkg.nn.functional.softmax(lin(x), axis=-1)
    return main, x, out


@pytest.fixture(scope="module")
def linear_pair():
    ptt.set_device("cpu")
    jl = paddle.nn.Linear(4, 3)
    tl = ptt.nn.Linear(4, 3)
    tl.load_state_dict(state_from_paddle_tpu(_np_state(jl)))
    return jl, tl


def test_save_load_inference_model_dynamic_batch_matches_jax(tmp_path, linear_pair):
    """tests/test_static.py:101 in both packages: a [-1, 4] feed, saved,
    loaded and run at batch 2 and 5; the port's artifact bit-equal to the
    port's Program run."""
    jl, tl = linear_pair
    got = {}
    for pkg, st, lin, key in ((paddle, jstatic, jl, "jax"), (ptt, tstatic, tl, "port")):
        main, x, out = _softmax_program(pkg, st, lin)
        prefix = str(tmp_path / key / "model")
        st.save_inference_model(prefix, [x], [out], st.Executor(), program=main)
        prog, feed_names, fetch_targets = st.load_inference_model(prefix, st.Executor())
        assert feed_names == ["x"] and fetch_targets == [0]
        runs = []
        for bs in (2, 5):
            xv = np.random.RandomState(bs).randn(bs, 4).astype("float32")
            (a,) = st.Executor().run(prog, feed={"x": xv}, fetch_list=fetch_targets)
            (b,) = st.Executor().run(main, feed={"x": xv}, fetch_list=[out])
            runs.append((np.asarray(a), np.asarray(b)))
        got[key] = runs
    for (ta, tb), (ja, _) in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_allclose(ta, ja, **F32)


@pytest.fixture(scope="module")
def llama_pair():
    from paddle_tpu.models.llama import LlamaForCausalLM as J
    from paddle_tpu_torch.models.llama import LlamaForCausalLM as T

    ptt.set_device("cpu")
    cfg = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=48)
    with pytest.MonkeyPatch.context() as mp:
        numpy_inits(mp)
        jm = J(**cfg)
    tm = T(**cfg)
    tm.load_state_dict(state_from_paddle_tpu(_np_state(jm)))
    jm.eval()
    tm.eval()
    return jm, tm


def _llama_program(st, model, batch):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        ids = st.data("ids", [batch, 8], "int64")
        logits = model(ids)
    return main, ids, logits


def test_llama_program_export_names_flash_and_matches_jax(tmp_path, llama_pair):
    """The tiny Llama (GQA) as a static Program with its batch declared -1:
    the exported graph holds one flash op a layer (the fuse_attention
    matches), runs at batch 2, 3 and 1 bit-equal to the port's eager
    forward, and at batch 2 matches the JAX package's artifact."""
    from paddle_tpu_torch.static import passes as tpasses

    jm, tm = llama_pair
    jmain, jids, jlogits = _llama_program(jstatic, jm, 2)
    jstatic.save_inference_model(str(tmp_path / "jax"), [jids], [jlogits], program=jmain)
    jprog, _, jfetch = jstatic.load_inference_model(str(tmp_path / "jax"))

    main, ids, logits = _llama_program(tstatic, tm, -1)
    prefix = str(tmp_path / "port")
    tstatic.save_inference_model(prefix, [ids], [logits], program=main)
    matches = tpasses.LAST_RESULT[0].matches["fuse_attention"]
    prog, feed_names, fetch = tstatic.load_inference_model(prefix)
    assert feed_names == ["ids"]
    assert sio.graph_ops(prog._module).count(FLASH) == matches == 2
    for b in (2, 3, 1):
        x = np.random.RandomState(b).randint(0, 64, (b, 8)).astype("int64")
        (got,) = tstatic.Executor().run(prog, feed={"ids": x}, fetch_list=fetch)
        with torch.no_grad():
            np.testing.assert_array_equal(got, tm(torch.from_numpy(x)).numpy())
        if b == 2:
            (want,) = jstatic.Executor().run(jprog, feed={"ids": x}, fetch_list=jfetch)
            np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_export_refuses_a_dynamic_dim_the_program_fixes(tmp_path):
    """A constant of the dry run's making fixes a -1 feed dim (here the
    batch, by broadcasting against a [2, 4] constant): the export names the
    input and the dims instead of writing an artifact that fails at
    another batch."""
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [-1, 4], "float32")
        y = x * 2.0 + ptt.ones([2, 4])
    with pytest.raises(ValueError, match=r"input 0 declares dims \[0\] dynamic"):
        tstatic.save_inference_model(str(tmp_path / "m"), [x], [y], program=main)


def test_exported_dropout_replays_the_capture_mask(tmp_path):
    """C-trap28: a Program captured with dropout replays the capture's
    draw, as the JAX package's closed-over key does; its artifact bakes
    that mask, so every run of it equals the Program's own run."""
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [4, 16], "float32")
        y = ptt.nn.functional.dropout(x + 1.0, p=0.5, training=True)
    xv = np.ones((4, 16), "float32")
    (want,) = tstatic.Executor().run(main, feed={"x": xv}, fetch_list=[y])
    tstatic.save_inference_model(str(tmp_path / "d"), [x], [y], program=main)
    prog, _, fetch = tstatic.load_inference_model(str(tmp_path / "d"))
    runs = [tstatic.Executor().run(prog, feed={"x": xv}, fetch_list=fetch)[0] for _ in range(2)]
    assert 0 < (want == 0).sum() < want.size
    np.testing.assert_array_equal(runs[0], want)
    np.testing.assert_array_equal(runs[1], want)


def test_static_save_load_and_var_list(tmp_path, linear_pair):
    """static.save writes {key: array} (.pdparams); static.load puts it
    back, all of it or the var_list's part."""
    _, tl = linear_pair
    lin = ptt.nn.Linear(4, 3)
    lin.load_state_dict(tl.state_dict())
    main, _, _ = _softmax_program(ptt, tstatic, lin)
    path = tstatic.save(main, str(tmp_path / "s"))
    assert path.endswith(".pdparams")
    w0, b0 = lin.weight.detach().clone(), lin.bias.detach().clone()
    with torch.no_grad():
        lin.weight.zero_()
        lin.bias.zero_()
    tstatic.load(main, str(tmp_path / "s"), var_list=[lin.weight])
    assert torch.equal(lin.weight, w0) and not lin.bias.any()
    tstatic.load(main, str(tmp_path / "s.pdparams"))
    assert torch.equal(lin.bias, b0)
    state = tstatic.load_program_state(str(tmp_path / "s"))
    assert sorted(state) == ["param_0", "param_1"]


def test_serialize_program_and_persistables_roundtrip(tmp_path, linear_pair):
    """tests/test_static_r4.py's serialization round trip in the port: the
    program's bytes run through the ExportedProgram they deserialize to,
    and the persistables' bytes restore the weights."""
    _, tl = linear_pair
    lin = ptt.nn.Linear(4, 3)
    lin.load_state_dict(tl.state_dict())
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data("x", [2, 4], "float32")
        y = lin(x)
    blob = tstatic.serialize_program([x], [y], program=main)
    pblob = tstatic.serialize_persistables([x], [y], program=main)
    p = str(tmp_path / "prog.bin")
    tstatic.save_to_file(p, blob)
    assert tstatic.load_from_file(p) == blob
    assert tstatic.normalize_program(main, [x], [y]) is main
    ep = tstatic.deserialize_program(blob)
    xv = torch.from_numpy(np.random.RandomState(3).randn(2, 4).astype("float32"))
    (out,) = ep.module()(xv)
    with torch.no_grad():
        np.testing.assert_array_equal(out.numpy(), lin(xv).numpy())
        w = lin.weight.clone()
        lin.weight.zero_()
    tstatic.deserialize_persistables(main, pblob)
    assert torch.equal(lin.weight, w)


@pytest.mark.parametrize("op", ["flash_fwd", "rms_norm_fwd"])
def test_registered_op_cpu_implementation_is_the_plain_function(op):
    """Each registered kernel op runs its plain version on the CPU, bit for
    bit, with the fake's shapes and dtypes (torch.library.opcheck)."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops import attention as A

    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype("float32"))
    if op == "flash_fwd":
        args = (t(2, 8, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16), True, 0.25, 0.0, 0)
        out, lse = torch.ops.paddle_tpu_torch.flash_fwd(*args)
        want_out, want_lse = A._flash_plain(*args)
        assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    else:
        args = (t(6, 16), t(16), t(16), 1e-6)
        assert torch.equal(torch.ops.paddle_tpu_torch.rms_norm_fwd(*args), IF._rms_norm_ref(*args))
    res = torch.library.opcheck(getattr(torch.ops.paddle_tpu_torch, op).default, args,
                                test_utils=("test_schema", "test_faketensor"))
    assert set(res.values()) == {"SUCCESS"}


@pytest.mark.parametrize("op", ["flash_fwd", "rms_norm_fwd"])
def test_a_trace_on_card_tensors_records_the_op_not_the_direct_launch(op):
    """An eager call on real CUDA tensors launches its kernel directly (no
    op dispatch); a trace must not: torch.export of fake CUDA tensors
    records the registered op, and direct_launch refuses CPU tensors, fake
    tensors and any call inside a fake mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops import attention as A

    if op == "flash_fwd":
        shapes, fn = [(2, 8, 4, 16)] * 3, lambda q, k, v: A.flash_attention_bshd(q, k, v, True)
    else:
        shapes, fn = [(2, 8, 16), (16,)], lambda x, w: IF.fused_rms_norm(x, w)

    class M(torch.nn.Module):
        def forward(self, *xs):
            return fn(*xs)

    assert not A.direct_launch(*(torch.zeros(s) for s in shapes))
    mode = FakeTensorMode()
    with mode:
        fakes = tuple(torch.zeros(s, device="cuda") for s in shapes)
        assert not A.direct_launch(*fakes)
    assert not A.direct_launch(*fakes)
    ep = torch.export.export(M(), fakes, strict=False)
    assert f"paddle_tpu_torch.{op}.default" in sio.graph_ops(ep.graph_module)


def test_jax_artifact_raises_a_named_error(tmp_path, linear_pair):
    """Artifacts do not cross packages: the JAX package's .pdmodel
    (StableHLO bytes) and .pdmeta (a pickle) are refused by name."""
    jl, _ = linear_pair
    main, x, out = _softmax_program(paddle, jstatic, jl)
    prefix = str(tmp_path / "jax")
    jstatic.save_inference_model(prefix, [x], [out], program=main)
    with pytest.raises(sio.ArtifactFormatError, match="not a paddle_tpu_torch meta file"):
        tstatic.load_inference_model(prefix)
    tmain, tx, tout = _softmax_program(ptt, tstatic, ptt.nn.Linear(4, 3))
    tstatic.save_inference_model(str(tmp_path / "port"), [tx], [tout], program=tmain)
    with pytest.raises(sio.ArtifactFormatError, match="StableHLO"):
        sio.read_artifact(prefix + ".pdmodel", str(tmp_path / "port"), "cpu")
    assert issubclass(sio.ArtifactFormatError, ValueError)
