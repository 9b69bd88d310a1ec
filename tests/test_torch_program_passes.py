"""Port parity for the pass pipeline: each shipped pass gives the JAX
package's golden match and rewrite counts on the same program (both
fuse_attention patterns, fusion blocked by a fetched interior var, the
wrong scale left alone), the unfused chain's flash op against the chain
it replaced, mutant passes caught by verify with their names, the tiny
Llama capture's matches and passes-on == passes-off (eval and train),
the Executor's cache identity under FLAGS_program_passes, telemetry,
print-after-pass and custom pass registration."""
import math

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
from paddle_tpu.static import passes as jpasses

import paddle_tpu_torch as ptt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core import record
from paddle_tpu_torch.static import passes
from paddle_tpu_torch.static.analysis import ProgramVerifyError, verify
from paddle_tpu_torch.static.passes.pass_base import PassStats, ProgramPass, clone_op_with_inputs
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu
from test_torch_static import numpy_inits

PKGS = ((paddle, jstatic, jpasses), (ptt, tstatic, passes))


@pytest.fixture(autouse=True)
def _reset():
    ptt.set_device("cpu")
    yield
    ptt.set_flags({"FLAGS_program_passes": True})


def _counter_value(name, **labels):
    fam = telemetry.default_registry().get(name)
    if fam is None:
        return 0
    child = fam.labels(**labels) if labels else fam._default()
    return child.value


def _run_pass(pas, main, pass_name, fetch_vids):
    work = main.clone()
    ctx = pas.PassContext(work, fetch_vars=fetch_vids)
    return work, pas.get_pass(pass_name).run(work, ctx)


def _replay(prog, feeds, fetch_vid):
    env = prog.replay_env(
        {prog.feed_vars[n]: torch.from_numpy(a) for n, a in feeds.items()},
        [prog._var_tensors[v] for v in prog.param_vars],
    )
    return env[fetch_vid].detach().numpy()


def _names(prog):
    return [op.name for op in prog.ops]


# ---------------------------------------------------------------------------
# the same program in both packages, one per shipped pass
# ---------------------------------------------------------------------------

def _dce(pkg, st):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [2, 3], "float32")
        y = pkg.scale(x, 2.0)
        pkg.scale(pkg.nn.functional.softmax(y), 3.0)  # two dead ops
    return main, y, {"x": np.random.RandomState(0).randn(2, 3).astype("float32")}


def _fold(pkg, st):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [2], "float32")
        if pkg is ptt:
            c = record.apply("const_three", lambda: torch.tensor(3.0))
        else:
            from jax import numpy as jnp
            from paddle_tpu.core.apply import apply

            c = apply("const_three", lambda: jnp.float32(3.0))
        y = pkg.multiply(x, c)
    return main, y, {"x": np.array([1.5, -2.0], "float32")}


def _cast_reshape(pkg, st):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [2, 3], "float32")
        y = pkg.cast(x, "float32")       # same dtype: redundant
        z = pkg.reshape(y, [2, 3])       # same shape: redundant
        w = pkg.scale(z, 2.0)
    return main, w, {"x": np.random.RandomState(0).randn(2, 3).astype("float32")}


def _rope_sdpa(pkg, st):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        q, k, v = (st.data(n, [1, 8, 4, 16], "float32") for n in "qkv")
        if pkg is ptt:
            from paddle_tpu_torch.models.llama import _rope

            qk = record.apply("rope", _rope, q, k)
        else:
            from paddle_tpu.core.apply import apply
            from paddle_tpu.models.llama import _rope

            qk = apply("rope", lambda qv, kv: _rope(qv, kv), q, k)
        out = pkg.nn.functional.scaled_dot_product_attention(qk[0], qk[1], v, is_causal=True,
                                                             training=False)
    rng = np.random.RandomState(1)
    return main, out, {n: rng.randn(1, 8, 4, 16).astype("float32") for n in "qkv"}


def _norm_matmul(pkg, st):
    w2 = np.random.RandomState(0).randn(8, 4).astype("float32")
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [2, 8], "float32")
        y = pkg.matmul(pkg.nn.RMSNorm(8)(x), pkg.to_tensor(w2))
    return main, y, {"x": np.random.RandomState(2).randn(2, 8).astype("float32")}


def _bias_dropout_residual(pkg, st):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [2, 8], "float32")
        b = st.data("b", [8], "float32")
        r = st.data("r", [2, 8], "float32")
        d = pkg.nn.functional.dropout(pkg.add(x, b), p=0.3, training=True)
        y = pkg.add(d, r)
    rng = np.random.RandomState(3)
    return main, y, {"x": rng.randn(2, 8).astype("float32"), "b": rng.randn(8).astype("float32"),
                     "r": rng.randn(2, 8).astype("float32")}


def _unfused(pkg, st, scale=None, d=16):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        q, k, v = (st.data(n, [1, 2, 8, d], "float32") for n in "qkv")
        s = pkg.matmul(q, k, transpose_y=True)
        s = pkg.scale(s, scale if scale is not None else 1.0 / math.sqrt(d))
        out = pkg.matmul(pkg.nn.functional.softmax(s), v)
    rng = np.random.RandomState(4)
    return main, out, {n: rng.randn(1, 2, 8, d).astype("float32") for n in "qkv"}


GOLDEN = [
    # (builder, pass, (matches, rewritten_ops), op names after)
    (_dce, "dead_op_elimination", (2, 2), ["scale"]),
    (_fold, "constant_fold_scalars", (1, 1), ["multiply"]),
    (_cast_reshape, "redundant_cast_reshape_elim", (2, 2), ["scale"]),
    (_rope_sdpa, "fuse_attention", (1, 2), ["fused_rope_flash_attention"]),
    (_norm_matmul, "fuse_norm_matmul", (1, 2), ["fused_rms_norm_matmul"]),
    (_bias_dropout_residual, "fuse_bias_dropout_residual", (1, 3),
     ["fused_bias_dropout_residual"]),
    (_unfused, "fuse_attention", (1, 4), ["fused_flash_attention"]),
    (lambda pkg, st: _unfused(pkg, st, scale=0.5), "fuse_attention", (0, 0),
     ["matmul", "scale", "softmax", "matmul"]),
]


@pytest.mark.parametrize("build,pass_name,counts,after", GOLDEN,
                         ids=[f"{g[1]}-{i}" for i, g in enumerate(GOLDEN)])
def test_pass_golden_counts_match_jax(build, pass_name, counts, after):
    res = {}
    for pkg, st, pas in PKGS:
        main, y, feeds = build(pkg, st)
        fv = [main._id2var[id(y)]]
        work, stats = _run_pass(pas, main, pass_name, fv)
        res[pkg.__name__] = (_names(main), (stats.matches, stats.rewritten_ops), _names(work))
        if pkg is ptt:
            port = (main, work, fv[0], feeds)
    assert res["paddle_tpu_torch"] == res["paddle_tpu"]
    assert res["paddle_tpu_torch"][1:] == (counts, after)
    main, work, fv, feeds = port
    before_vals, after_vals = _replay(main, feeds, fv), _replay(work, feeds, fv)
    if after == ["fused_flash_attention"]:
        # the flash op reassociates the softmax: held against the chain
        np.testing.assert_allclose(before_vals, after_vals, rtol=2e-5, atol=2e-5)
    else:
        # a mini-replay (or a removal): bit-identical, dropout's mask too
        np.testing.assert_array_equal(before_vals, after_vals)
    assert len(main.ops) == len(res["paddle_tpu_torch"][0])  # the caller's program untouched


def test_fusion_blocked_when_interior_var_is_fetched():
    counts = {}
    for pkg, st, pas in PKGS:
        main, y, _ = _rope_sdpa(pkg, st)
        fv = [main._id2var[id(y)], main.ops[0].out_vars[0]]  # the rope output pinned
        work, stats = _run_pass(pas, main, "fuse_attention", fv)
        counts[pkg.__name__] = (stats.matches, len(work.ops))
    assert counts["paddle_tpu_torch"] == counts["paddle_tpu"] == (0, 2)


def test_cast_elim_keeps_a_device_move():
    """A recorded Tensor.to(device) is a "cast" of the same dtype and
    shape: removing it would hand its consumers the tensor on the other
    device, so the cast elimination keeps it; a same-dtype cast without
    a device goes."""
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [3])
        moved = x.to("cpu", copy=True) + 1.0
        same = x.to(torch.float32, copy=True) * 2.0
    assert [op.name for op in main.ops] == ["cast", "add", "cast", "multiply"]
    fv = [main._id2var[id(moved)], main._id2var[id(same)]]
    work, stats = _run_pass(passes, main, "redundant_cast_reshape_elim", fv)
    assert stats.matches == 1 and [op.name for op in work.ops] == ["cast", "add", "multiply"]
    got = tstatic.Executor().run(main, feed={"x": np.arange(3, dtype="float32")},
                                 fetch_list=[moved, same])
    assert [g.tolist() for g in got] == [[1.0, 2.0, 3.0], [0.0, 2.0, 4.0]]


# ---------------------------------------------------------------------------
# mutant passes: caught by the post-pass verify, with the pass named
# ---------------------------------------------------------------------------

class _MutantFusionUndefinedRead(ProgramPass):
    name = "mutant_fusion_undefined_read"

    def run(self, program, ctx):
        op = program.ops[-1]
        program.ops[-1] = clone_op_with_inputs(op, [("var", 999999)] + list(op.in_refs[1:]))
        return PassStats(matches=1, rewritten_ops=1)


class _MutantCanonicalizeDoubleDefine(ProgramPass):
    name = "mutant_canonicalize_double_define"

    def run(self, program, ctx):
        op = program.ops[0]
        program.ops.append(clone_op_with_inputs(op, list(op.in_refs)))
        return PassStats(matches=1, rewritten_ops=1)


class _MutantDceRemovesLiveOp(ProgramPass):
    name = "mutant_dce_removes_live_op"

    def run(self, program, ctx):
        program.ops = program.ops[:-1]
        return PassStats(matches=1, rewritten_ops=1)


@pytest.mark.parametrize("mutant,check", [
    (_MutantFusionUndefinedRead, "undefined-var"),
    (_MutantCanonicalizeDoubleDefine, "single-assignment"),
    (_MutantDceRemovesLiveOp, "dangling-fetch"),
])
def test_mutant_pass_caught_by_verify_with_pass_named(mutant, check):
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2, 3], "float32")
        y = ptt.nn.functional.softmax(x * 2.0)
    fv = [main._id2var[id(y)]]
    with pytest.raises(ProgramVerifyError, match=mutant.name) as ei:
        passes.PassManager([mutant()]).run(main.clone(), fetch_vars=fv)
    assert check in [d.check for d in ei.value.diagnostics]
    assert f"after pass '{mutant.name}'" in str(ei.value)


def test_post_pipeline_verify_context_named():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2], "float32")
        x * 2.0
    with pytest.raises(ProgramVerifyError, match="post-pipeline|dangling-fetch"):
        passes.run_default_pipeline(main, fetch_vars=[987654])


# ---------------------------------------------------------------------------
# the tiny Llama capture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_pair():
    from paddle_tpu.models.llama import LlamaForCausalLM as J
    from paddle_tpu_torch.models.llama import LlamaForCausalLM as T

    ptt.set_device("cpu")
    cfg = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=48)
    with pytest.MonkeyPatch.context() as mp:
        numpy_inits(mp)
        jm = J(**cfg)
    tm = T(**cfg)
    tm.load_state_dict(state_from_paddle_tpu(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}))
    return jm, tm


def test_llama_eval_capture_matches_two_fusion_patterns(llama_pair):
    from paddle_tpu.jit import capture_program as jcap
    from paddle_tpu_torch.jit import capture_program as tcap

    jm, tm = llama_pair
    jm.eval()
    tm.eval()
    ids = (np.arange(8) % 64).reshape(1, 8).astype("int64")
    jprog, jfeeds, jfetch = jcap(jm, paddle.to_tensor(ids), feed_names=["ids"])
    _, jres = jpasses.run_default_pipeline(jprog, fetch_vars=[jprog.resolve_fetch(jfetch[0])],
                                           feed_names=jfeeds)
    program, feed_names, fetch_list = tcap(tm, torch.from_numpy(ids), feed_names=["ids"])
    n_ops = len(program.ops)
    fa0 = _counter_value("paddle_tpu_pass_matches_total", **{"pass": "fuse_attention"})
    nm0 = _counter_value("paddle_tpu_pass_matches_total", **{"pass": "fuse_norm_matmul"})
    exe = tstatic.Executor()
    (on,) = exe.run(program, feed={"ids": ids}, fetch_list=fetch_list)
    assert passes.LAST_RESULT[0].matches == jres.matches
    assert jres.matches["fuse_attention"] == 2 and jres.matches["fuse_norm_matmul"] == 1
    assert _counter_value("paddle_tpu_pass_matches_total",
                          **{"pass": "fuse_attention"}) == fa0 + 2
    assert _counter_value("paddle_tpu_pass_matches_total",
                          **{"pass": "fuse_norm_matmul"}) == nm0 + 1
    assert len(program.ops) == n_ops  # the recorded capture is untouched
    ptt.set_flags({"FLAGS_program_passes": False})
    (off,) = exe.run(program, feed={"ids": ids}, fetch_list=fetch_list)
    np.testing.assert_array_equal(on, off)


def test_llama_train_capture_passes_on_off_identity(llama_pair):
    _, model = llama_pair
    model.train()
    ids_np = (np.arange(16) % 64).reshape(2, 8).astype("int64")
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        ids = tstatic.data("ids", [2, 8], "int64")
        labels = tstatic.data("labels", [2, 8], "int64")
        loss, _ = model(ids, labels=labels)
        ptt.optimizer.SGD(0.1, parameters=model.parameters()).minimize(loss)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    exe = tstatic.Executor()
    feed = {"ids": ids_np, "labels": ids_np}
    runs = {}
    for on in (True, False):
        model.load_state_dict(w0)
        ptt.set_flags({"FLAGS_program_passes": on})
        runs[on] = ([exe.run(main, feed=feed, fetch_list=[loss])[0] for _ in range(2)],
                    model.llama.layers[0].mlp.up_proj.weight.detach().clone())
    model.load_state_dict(w0)
    assert runs[True][0][1] != runs[True][0][0]  # the update really ran
    for a, b in zip(runs[True][0], runs[False][0]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(runs[True][1], runs[False][1])


# ---------------------------------------------------------------------------
# Executor integration, telemetry, print-after-pass, registration
# ---------------------------------------------------------------------------

def test_flag_toggle_recompiles_not_cache_hit():
    main, y, feed = _rope_sdpa(ptt, tstatic)
    exe = tstatic.Executor()
    miss0 = _counter_value("paddle_tpu_executor_compile_cache_total", result="miss")
    hit0 = _counter_value("paddle_tpu_executor_compile_cache_total", result="hit")
    runs0 = _counter_value("paddle_tpu_pass_runs_total", **{"pass": "fuse_attention"})
    exe.run(main, feed=feed, fetch_list=[y])         # miss, pipeline runs
    ptt.set_flags({"FLAGS_program_passes": False})
    exe.run(main, feed=feed, fetch_list=[y])         # MISS again, no pipeline
    ptt.set_flags({"FLAGS_program_passes": True})
    exe.run(main, feed=feed, fetch_list=[y])         # HIT the passes-on entry
    assert _counter_value("paddle_tpu_executor_compile_cache_total", result="miss") == miss0 + 2
    assert _counter_value("paddle_tpu_executor_compile_cache_total", result="hit") == hit0 + 1
    assert _counter_value("paddle_tpu_pass_runs_total", **{"pass": "fuse_attention"}) == runs0 + 1


def test_replaced_op_evicts_stale_entry():
    main, y, feed = _cast_reshape(ptt, tstatic)
    exe = tstatic.Executor()
    (a,) = exe.run(main, feed=feed, fetch_list=[y])
    ev0 = _counter_value("paddle_tpu_executor_compile_cache_evictions_total")
    main.ops[-1] = clone_op_with_inputs(main.ops[-1], list(main.ops[-1].in_refs))
    (b,) = exe.run(main, feed=feed, fetch_list=[y])
    np.testing.assert_array_equal(a, b)
    assert _counter_value("paddle_tpu_executor_compile_cache_evictions_total") == ev0 + 1


def test_pass_telemetry_and_summary():
    main, y, _ = _rope_sdpa(ptt, tstatic)
    fv = [main._id2var[id(y)]]
    runs0 = _counter_value("paddle_tpu_pass_runs_total", **{"pass": "fuse_attention"})
    rw0 = _counter_value("paddle_tpu_pass_rewritten_ops_total", **{"pass": "fuse_attention"})
    work, res = passes.run_default_pipeline(main, fetch_vars=fv)
    assert _counter_value("paddle_tpu_pass_runs_total", **{"pass": "fuse_attention"}) == runs0 + 1
    assert _counter_value("paddle_tpu_pass_rewritten_ops_total",
                          **{"pass": "fuse_attention"}) == rw0 + 2
    assert telemetry.default_registry().get("paddle_tpu_pass_seconds") is not None
    s = res.summary()
    assert s["matches"]["fuse_attention"] == 1 and s["rewritten_ops"]["fuse_attention"] == 2
    assert s["pipeline_ms"] > 0
    assert verify(work, fetch_vars=fv) == []


def test_print_after_pass_diff(capsys):
    main, y, _ = _rope_sdpa(ptt, tstatic)
    passes.PassManager(print_after={"fuse_attention"}).run(
        main.clone(), fetch_vars=[main._id2var[id(y)]])
    err = capsys.readouterr().err
    assert "fuse_attention: before" in err
    assert "-  %v3, %v4 = rope(%v0, %v1" in err
    assert "+  %v5 = fused_rope_flash_attention(%v0, %v1, %v2" in err


def test_flag_off_skips_pipeline_entirely():
    runs0 = _counter_value("paddle_tpu_pass_runs_total", **{"pass": "fuse_attention"})
    main, y, feed = _rope_sdpa(ptt, tstatic)
    ptt.set_flags({"FLAGS_program_passes": False})
    tstatic.Executor().run(main, feed=feed, fetch_list=[y])
    assert _counter_value("paddle_tpu_pass_runs_total", **{"pass": "fuse_attention"}) == runs0


def test_register_custom_pass_in_default_pipeline():
    from paddle_tpu_torch.static.passes import pass_base

    calls = []

    class _ProbePass(ProgramPass):
        name = "test_probe_pass"

        def run(self, program, ctx):
            calls.append(len(program.ops))
            return PassStats()

    passes.register_pass(_ProbePass, before="fuse_attention")
    try:
        names = [p.name for p in passes.default_pipeline()]
        assert names.index("test_probe_pass") == names.index("fuse_attention") - 1
        main, y, _ = _rope_sdpa(ptt, tstatic)
        passes.run_default_pipeline(main, fetch_vars=[main._id2var[id(y)]])
        assert calls == [2]  # ran, before fusion collapsed the cluster
    finally:
        pass_base._REGISTRY.pop("test_probe_pass", None)
        pass_base.PIPELINE_ORDER.remove("test_probe_pass")
