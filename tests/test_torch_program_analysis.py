"""Port parity for the program analysis layer: every verifier and donation
diagnostic gives the same check, severity, var and op on the same
malformed program in both packages; ProgramGraph and to_text; dead-op
elimination (bit-identical, roots kept, Llama's unfetched loss pruned);
the verifier's telemetry."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu import static as jstatic

import paddle_tpu_torch as ptt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core import record
from paddle_tpu_torch.static.analysis import (
    ProgramGraph,
    ProgramVerifyError,
    dead_op_elimination,
    describe_program,
    verify,
)
from paddle_tpu_torch.static.analysis.donation import verify_donated_state
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu

PKGS = ((paddle, jstatic), (ptt, tstatic))


@pytest.fixture(autouse=True)
def _reset():
    ptt.set_device("cpu")
    yield
    for pkg in (paddle, ptt):
        pkg.set_flags({"FLAGS_fused_optimizer": False, "FLAGS_verify_program": True})


def _counter_value(name, **labels):
    fam = telemetry.default_registry().get(name)
    if fam is None:
        return 0
    child = fam.labels(**labels) if labels else fam._default()
    return child.value


def _simple(pkg, st, lin=None):
    """x -> linear -> add(c): the same var numbering in both packages (the
    constant is a tensor made outside the guard, an external in both)."""
    lin = lin or pkg.nn.Linear(3, 2)
    c = pkg.to_tensor(np.ones(2, "float32"))
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [2, 3], "float32")
        y = lin(x) + c
    return main, y


def _sgd_program(pkg, st, fused=False):
    pkg.set_flags({"FLAGS_fused_optimizer": fused})
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [4, 3], "float32")
        lin = pkg.nn.Linear(3, 1)
        loss = pkg.mean(pkg.square(lin(x)))
        opt = (pkg.optimizer.AdamW(0.01, parameters=lin.parameters()) if fused
               else pkg.optimizer.SGD(0.1, parameters=lin.parameters()))
        opt.minimize(loss)
    return main, loss


def _key(diags):
    return [(d.check, d.severity, d.var, d.op_index) for d in diags]


def _corrupt_use_before_def(main, pkg):
    main.ops.reverse()


def _corrupt_undefined(main, pkg):
    main.ops[0].in_refs[0] = ("var", 9999)


def _corrupt_single_assignment(main, pkg):
    main.ops[1].out_vars[0] = main.ops[0].out_vars[0]


def _corrupt_duplicate_binding(main, pkg):
    op = main.ops[0]
    op.out_vars = op.out_vars + op.out_vars
    op.out_positions = op.out_positions + op.out_positions


def _corrupt_arity_positions(main, pkg):
    main.ops[0].out_positions = []


def _corrupt_arity_range(main, pkg):
    main.ops[0].out_positions = [5]


def _corrupt_grad_ref(main, pkg):
    main.grad_requests.append((424242, [main.param_vars[0]], [main._next_var]))


def _corrupt_param_coverage(main, pkg):
    main.param_vars.append(31337)


@pytest.mark.parametrize("corrupt,check", [
    (_corrupt_use_before_def, "use-before-def"),
    (_corrupt_undefined, "undefined-var"),
    (_corrupt_single_assignment, "single-assignment"),
    (_corrupt_duplicate_binding, "duplicate-var-binding"),
    (_corrupt_arity_positions, "op-output-arity"),
    (_corrupt_arity_range, "op-output-arity"),
    (_corrupt_grad_ref, "dangling-grad-ref"),
    (_corrupt_param_coverage, "param-coverage"),
])
def test_each_diagnostic_matches_jax(corrupt, check):
    got = {}
    for pkg, st in PKGS:
        main, _ = _simple(pkg, st)
        corrupt(main, pkg)
        with pytest.raises((ProgramVerifyError, jstatic.ProgramVerifyError)) as ei:
            (verify if pkg is ptt else jstatic.verify)(main)
        got[pkg.__name__] = ei.value.diagnostics
    port, jax_ = got["paddle_tpu_torch"], got["paddle_tpu"]
    assert check in [d.check for d in port]
    assert _key(port) == _key(jax_)
    assert [d.message for d in port] == [d.message for d in jax_]


@pytest.mark.parametrize("case", ["dangling_fetch", "dangling_opt_ref", "fed_and_fetched",
                                  "feed_coverage", "donated_bucket_read", "aliased_opt_state"])
def test_fetch_opt_and_donation_diagnostics_match_jax(case):
    import copy

    got = {}
    for pkg, st in PKGS:
        v = verify if pkg is ptt else jstatic.verify
        if case == "dangling_fetch":
            main, _ = _simple(pkg, st)
            diags = v(main, fetch_vars=[123456], raise_on_error=False)
        elif case == "dangling_opt_ref":
            main, _ = _sgd_program(pkg, st)
            main.opt_updates[0].grad_var = 777777  # grad producer "removed"
            diags = v(main, raise_on_error=False)
        elif case == "fed_and_fetched":
            main, _ = _simple(pkg, st)
            diags = v(main, feed_names=["x"], fetch_vars=[main.feed_vars["x"]])
        elif case == "feed_coverage":  # x read but not provided, zz provided but unknown
            main, _ = _simple(pkg, st)
            diags = v(main, feed_names=["zz"], raise_on_error=False)
        else:
            main, _ = _sgd_program(pkg, st, fused=True)
            upd = main.opt_updates[0]
            if case == "donated_bucket_read":
                # an op reads the flat bucket (a program input now)
                vid = main.var_of(upd.accum_tensors[0])
                out = main._new_var(pkg.to_tensor(np.zeros(4, "float32")))
                main.ops.append(type(main.ops[0])("mul", lambda a: a * 2, [("var", vid)], {},
                                                  [out]))
            else:
                main.opt_updates.append(copy.copy(upd))  # shares accum_tensors
            diags = v(main, raise_on_error=False)
        got[pkg.__name__] = diags
    port, jax_ = got["paddle_tpu_torch"], got["paddle_tpu"]
    assert _key(port) == _key(jax_) and port
    assert [d.message for d in port] == [d.message for d in jax_]
    if case in ("fed_and_fetched", "donated_bucket_read"):
        assert all(d.severity == "warning" for d in port)


def test_missing_and_unknown_feed_are_named():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        a = tstatic.data("a", [2], "float32")
        b = tstatic.data("b", [2], "float32")
        c = a + b
    exe = tstatic.Executor()
    with pytest.raises(ProgramVerifyError, match="feed-coverage.*'b'"):
        exe.run(main, feed={"a": np.ones(2, "float32")}, fetch_list=[c])
    with pytest.raises(ProgramVerifyError, match="feed-coverage.*'zz'"):
        exe.run(main, feed={n: np.ones(2, "float32") for n in ("a", "b", "zz")},
                fetch_list=[c])
    ptt.set_flags({"FLAGS_verify_program": False})
    with pytest.raises(Exception) as ei:
        exe.run(main, feed={"a": np.ones(2, "float32")}, fetch_list=[c])
    assert not isinstance(ei.value, ProgramVerifyError)


def test_replay_arity_mismatch_raises_named_error():
    main, y = _simple(ptt, tstatic)
    op = main.ops[-1]
    op.fn = lambda *a, **kw: (a[0], a[0])  # 2 outputs, 1 recorded
    with pytest.raises(RuntimeError, match=rf"op#1 '{op.name}'.*returned 2"):
        tstatic.Executor().run(main, feed={"x": np.ones((2, 3), "float32")}, fetch_list=[y])


def test_donated_state_alias_named():
    w = torch.zeros(4, 4)
    with pytest.raises(ProgramVerifyError, match="donated-state-alias"):
        verify_donated_state([w, torch.ones(2), w.view(16)], labels=["a", "b", "c"])
    verify_donated_state([w, w.clone()])


def test_program_graph_and_to_text_match_jax():
    jl = paddle.nn.Linear(3, 2)
    tl = ptt.nn.Linear(3, 2)
    tl.load_state_dict(state_from_paddle_tpu(
        {k: np.asarray(v._value) for k, v in jl.state_dict().items()}))
    texts = {}
    for (pkg, st), lin in zip(PKGS, (jl, tl)):
        main, y = _simple(pkg, st, lin)
        yv = main._id2var[id(y)]
        texts[pkg.__name__] = main.to_text(fetch_vars=[yv])
    port = texts["paddle_tpu_torch"]
    # the port records its literals (the bias-free linear's None) as
    # literal inputs; every line but the ops' argument lists is the same
    strip = [ln.split("=", 1)[0] if "# op#" in ln else ln for ln in port.splitlines()]
    want = [ln.split("=", 1)[0] if "# op#" in ln else ln
            for ln in texts["paddle_tpu"].splitlines()]
    assert strip == want
    assert port == tstatic.Program.to_text(main, fetch_vars=[yv])  # stable
    g = ProgramGraph(main, fetch_vars=[yv])
    xv = main.feed_vars["x"]
    assert g.def_of(xv).kind == "feed"
    assert g.def_of(yv).kind == "op" and g.def_of(yv).def_op == 1
    assert ("fetch", 0, 0) in g.uses_of(yv)
    assert g.def_of(yv).shape == (2, 2) and g.def_of(yv).dtype == "float32"


def test_to_text_empty_partial_and_training_programs():
    empty = tstatic.Program()
    assert empty.to_text().startswith("program {") and "0 ops" in empty.to_text()
    assert repr(empty) == empty.to_text()
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        tstatic.data("x", [-1, 4], "float32")
    assert "feed  %v0 'x' : float32[-1, 4]" in main.to_text()
    assert describe_program(main) == main.to_text()
    main2, _ = _sgd_program(ptt, tstatic)
    t = main2.to_text()
    assert "grad [" in t and "opt OptUpdate" in t


def test_dce_removes_dead_ops_bit_identical():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2, 4], "float32")
        lin = ptt.nn.Linear(4, 2)
        y = lin(x) + 1.0
        ptt.nn.functional.softmax(y) * 3.0  # two dead ops
    exe = tstatic.Executor()
    xv = np.random.RandomState(0).randn(2, 4).astype("float32")
    (before,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    c0 = _counter_value("paddle_tpu_program_dce_removed_ops_total")
    assert dead_op_elimination(main, fetch_list=[y]) == 2
    (after,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    np.testing.assert_array_equal(before, after)
    assert _counter_value("paddle_tpu_program_dce_removed_ops_total") == c0 + 2
    assert verify(main, feed_names=["x"], fetch_vars=[main._id2var[id(y)]]) == []
    with pytest.raises(ValueError, match="fetch var id 9999"):
        dead_op_elimination(main, fetch_list=[9999])


def test_dce_keeps_effectful_and_grad_opt_roots():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [4, 3], "float32")
        lin = ptt.nn.Linear(3, 1)
        loss = ptt.mean(lin(x) ** 2)
        record.apply("print_op", lambda t: t.clone(), loss)  # effectful, unfetched
        ptt.optimizer.SGD(0.1, parameters=lin.parameters()).minimize(loss)
    n_ops = len(main.ops)
    assert dead_op_elimination(main, fetch_list=[loss]) == 0 and len(main.ops) == n_ops
    assert any(op.name == "print_op" for op in main.ops)
    w0 = lin.weight.numpy().copy()
    tstatic.Executor().run(main, feed={"x": np.ones((4, 3), "float32")}, fetch_list=[loss])
    assert np.abs(lin.weight.numpy() - w0).max() > 0  # update still ran


def test_dce_llama_prunes_unfetched_loss_bit_identical():
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    model = LlamaForCausalLM(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                             num_attention_heads=4, intermediate_size=48)
    model.eval()
    ids_np = (np.arange(8, dtype="int64") % 64).reshape(1, 8)
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        ids = tstatic.data("ids", [1, 8], "int64")
        labels = tstatic.data("labels", [1, 8], "int64")
        logits = model(ids)
        model(ids, labels=labels)  # recorded, never fetched
    exe = tstatic.Executor()
    (before,) = exe.run(main, feed={"ids": ids_np, "labels": ids_np}, fetch_list=[logits])
    assert dead_op_elimination(main, fetch_list=[logits]) > 0
    assert verify(main, fetch_vars=[main._id2var[id(logits)]]) == []
    (after,) = exe.run(main, feed={"ids": ids_np}, fetch_list=[logits])  # labels dead too
    np.testing.assert_array_equal(before, after)


def test_verify_telemetry_counters():
    runs0 = _counter_value("paddle_tpu_program_verify_runs_total")
    bad0 = _counter_value("paddle_tpu_program_verify_diagnostics_total", check="undefined-var")
    main, _ = _simple(ptt, tstatic)
    verify(main)
    main.ops[0].in_refs[0] = ("var", 31337)
    with pytest.raises(ProgramVerifyError):
        verify(main)
    assert _counter_value("paddle_tpu_program_verify_runs_total") == runs0 + 2
    assert _counter_value("paddle_tpu_program_verify_diagnostics_total",
                          check="undefined-var") == bad0 + 1
    hist = telemetry.default_registry().get("paddle_tpu_program_verify_seconds")
    assert hist is not None and hist.count >= 2
