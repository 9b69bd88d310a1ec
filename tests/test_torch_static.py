"""Port parity for the static graph's core: Program capture under
program_guard (the recorded op names), the Executor's feed/fetch and
append_backward, static minimize training (SGD, Momentum, Adam, AdamW and
the fused AdamW bucket), and capture_program over the tiny Llama and the
tiny ERNIE — each program built in both packages from the same numpy
inputs, the weights carried over, and compared."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu import static as jstatic

import paddle_tpu_torch as ptt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _reset():
    ptt.set_device("cpu")
    yield
    for pkg in (paddle, ptt):
        pkg.set_flags({"FLAGS_fused_optimizer": False, "FLAGS_program_passes": True})


def _np_state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


def _carry(jlayer, tlayer):
    tlayer.load_state_dict(state_from_paddle_tpu(_np_state(jlayer)))
    return tlayer


def _names(prog):
    return [op.name for op in prog.ops]


def _linear_pair(i, o):
    jl = paddle.nn.Linear(i, o)
    return jl, _carry(jl, ptt.nn.Linear(i, o))


# ---------------------------------------------------------------------------
# capture + Executor
# ---------------------------------------------------------------------------

def test_program_capture_and_fetch():
    w = np.ones((4, 2), "float32")
    outs = {}
    for pkg, st, name in ((paddle, jstatic, "jax"), (ptt, tstatic, "port")):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            x = st.data("x", [-1, 4], "float32")
            y = pkg.matmul(x, pkg.to_tensor(w)) + pkg.to_tensor(np.float32(1.0))
        exe = st.Executor()
        feed_x = np.arange(8, dtype="float32").reshape(2, 4)
        (out,) = exe.run(main, feed={"x": feed_x}, fetch_list=[y])
        (out8,) = exe.run(main, feed={"x": np.ones((8, 4), "float32")}, fetch_list=[y])
        outs[name] = (_names(main), out, out8)
    assert outs["port"][0] == outs["jax"][0] == ["matmul", "add"]
    np.testing.assert_allclose(outs["port"][1], outs["jax"][1], **F32)
    assert outs["port"][2].shape == (8, 2)  # another batch replays as it is
    np.testing.assert_allclose(outs["port"][2], outs["jax"][2], **F32)


def test_layers_under_program_guard():
    xv = np.random.RandomState(0).randn(3, 4).astype("float32")
    jl, tl = _linear_pair(4, 5)
    got = {}
    for st, lin, name in ((jstatic, jl, "jax"), (tstatic, tl, "port")):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            x = st.data("x", [3, 4], "float32")
            out = lin(x)
        got[name] = (_names(main), st.Executor().run(main, feed={"x": xv}, fetch_list=[out])[0])
    assert got["port"][0] == got["jax"][0] == ["linear"]
    np.testing.assert_allclose(got["port"][1], got["jax"][1], **F32)
    # a layer made inside the guard initializes unrecorded
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [3, 4], "float32")
        ptt.nn.Linear(4, 5)(x)
    assert _names(main) == ["linear"]


def test_append_backward_grads_match_jax():
    xv = np.random.RandomState(1).randn(2, 3).astype("float32")
    jl, tl = _linear_pair(3, 1)
    res = {}
    for pkg, st, lin, name in ((paddle, jstatic, jl, "jax"), (ptt, tstatic, tl, "port")):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            x = st.data("x", [2, 3], "float32")
            loss = pkg.mean(lin(x) ** 2)
            pairs = st.append_backward(loss)
        assert len(pairs) == 2  # weight + bias
        res[name] = st.Executor().run(main, feed={"x": xv},
                                      fetch_list=[loss] + [g for _, g in pairs])
    assert res["port"][0].shape == ()
    for a, b in zip(res["port"], res["jax"]):
        np.testing.assert_allclose(a, b, **GRAD)


def _regression(pkg, st, lin, opt_name, **opt_kw):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [-1, 3], "float32")
        y = st.data("y", [-1, 1], "float32")
        loss = pkg.mean((lin(x) - y) ** 2)
        opt = {
            "sgd": lambda: pkg.optimizer.SGD(0.1, parameters=lin.parameters(), **opt_kw),
            "momentum": lambda: pkg.optimizer.Momentum(0.05, parameters=lin.parameters(),
                                                       **opt_kw),
            "adam": lambda: pkg.optimizer.Adam(0.1, parameters=lin.parameters(), **opt_kw),
            "adamw": lambda: pkg.optimizer.AdamW(0.1, parameters=lin.parameters(), **opt_kw),
        }[opt_name]()
        opt.minimize(loss)
    return main, loss


def _data():
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 3).astype("float32")
    w_true = np.array([[1.5], [-2.0], [0.5]], "float32")
    return xs, xs @ w_true + 0.3, w_true


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adam", "adamw"])
def test_static_training_matches_jax(opt_name):
    xs, ys, w_true = _data()
    jl, tl = _linear_pair(3, 1)
    losses, params = {}, {}
    for pkg, st, lin, name in ((paddle, jstatic, jl, "jax"), (ptt, tstatic, tl, "port")):
        main, loss = _regression(pkg, st, lin, opt_name)
        exe = st.Executor()
        losses[name] = [float(exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])[0])
                        for _ in range(4)]
        params[name] = [np.array(lin.weight.numpy()), np.array(lin.bias.numpy())]
    np.testing.assert_allclose(losses["port"], losses["jax"], **F32)
    for a, b in zip(params["port"], params["jax"]):
        np.testing.assert_allclose(a, b, **F32)
    # and it converges (the JAX package's own check, in the port alone)
    main, loss = _regression(ptt, tstatic, tl, opt_name)
    exe = tstatic.Executor()
    run = [float(exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])[0])
           for _ in range(60)]
    assert run[-1] < run[0] * 0.05, run[::20]
    np.testing.assert_allclose(tl.weight.numpy(), w_true, atol=0.4)


def test_static_fused_adamw_matches_jax(monkeypatch):
    """FLAGS_fused_optimizer: one flat bucket a minimize, updated with seed 0
    and clip scale 1 every step (C-trap: the static path never draws a
    stochastic-rounding seed); losses, params and both flat moments match
    the JAX package's after 3 steps (the grads differ in summation order,
    so the moments are held at f32 tolerance; the update itself is
    bit-exact, see the next test)."""
    from paddle_tpu.ops import fused_optimizer as jfo
    from paddle_tpu_torch.ops import fused_optimizer as tfo

    xs, ys, _ = _data()
    jl, tl = _linear_pair(3, 1)
    seeds = {"jax": [], "port": []}

    def spy(mod, key):
        real = mod.fused_adamw_apply

        def f(*a, **kw):
            seeds[key].append((int(kw["seed"]), float(kw["clip_scale"])))
            return real(*a, **kw)

        monkeypatch.setattr(mod, "fused_adamw_apply", f)

    spy(jfo, "jax")
    spy(tfo, "port")
    res = {}
    for pkg, st, lin, name in ((paddle, jstatic, jl, "jax"), (ptt, tstatic, tl, "port")):
        pkg.set_flags({"FLAGS_fused_optimizer": True})
        main, loss = _regression(pkg, st, lin, "adamw", weight_decay=0.01)
        upd = main.opt_updates[0]
        assert type(upd).__name__ == "_FusedAdamWUpdate" and len(main.opt_updates) == 1
        exe = st.Executor()
        ls = [float(exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])[0])
              for _ in range(3)]
        m, v = (np.array(ptt.framework.io.tensor_to_numpy(a)) if name == "port"
                else np.asarray(a._value) for a in upd.accum_tensors[:2])
        res[name] = (ls, lin.weight.numpy().copy(), m, v)
    # the JAX package traces its replay once: seed 0 is a constant of it
    assert seeds["jax"] == [(0, 1.0)] and seeds["port"] == [(0, 1.0)] * 3
    assert res["port"][3].dtype == np.float32  # moment2 is f32 whatever moment2_dtype says
    np.testing.assert_allclose(res["port"][0], res["jax"][0], **F32)
    np.testing.assert_allclose(res["port"][1], res["jax"][1], **F32)
    for a, b in zip(res["port"][2:], res["jax"][2:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("m2_dtype", ["float32", "bfloat16"])
def test_static_fused_update_bits_match_jax(m2_dtype):
    """Executor._apply_fused_update in both packages on the same flat
    bucket: params and moments bit-equal over two steps; with a bf16
    moment2 the stochastic rounding is keyed by seed 0 at every step in
    both (the same bits each step)."""
    import jax.numpy as jnp

    from paddle_tpu.static import executor as jex
    from paddle_tpu_torch.static import executor as tex
    from paddle_tpu_torch.framework.io import tensor_to_numpy

    rng = np.random.RandomState(5)
    shapes = [(40, 30), (30,), (7, 9)]
    ps = [rng.randn(*s).astype("float32") for s in shapes]
    index, off = {}, 0
    for i, s in enumerate(shapes):
        index[i] = (off, int(np.prod(s)), s)
        off += int(np.prod(s))
    n_pad = 16384
    m2 = jnp.bfloat16 if m2_dtype == "bfloat16" else jnp.float32
    jacc = [jnp.zeros((n_pad,), jnp.float32), jnp.zeros((n_pad,), m2), jnp.zeros((), jnp.int32)]
    tacc = [torch.zeros(n_pad), torch.zeros(n_pad, dtype=getattr(torch, m2_dtype)),
            torch.zeros((), dtype=torch.int32)]
    args = ([0, 1, 2], [3, 4, 5], index, n_pad)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.01, decoupled=True)
    jupd = jex._FusedAdamWUpdate(*args, jacc, None, None, **kw)
    tupd = tex._FusedAdamWUpdate(*args, tacc, None, None, **kw)
    jp = [jnp.asarray(p) for p in ps]
    tp = [torch.from_numpy(p.copy()) for p in ps]
    pos = {0: 0, 1: 1, 2: 2}
    for _ in range(2):
        gs = [rng.randn(*s).astype("float32") for s in shapes]
        jacc = jex.Executor._apply_fused_update(jupd, jacc, jnp.float32(1e-3),
                                                [jnp.asarray(g) for g in gs], jp, pos)
        tex.Executor._apply_fused_update(tupd, tacc, 1e-3, [torch.from_numpy(g) for g in gs],
                                         tp, pos)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(b).view(np.uint32))
        for a, b in zip(tacc[:2], jacc[:2]):
            ta, ja = tensor_to_numpy(a), np.asarray(b)
            np.testing.assert_array_equal(ta.view(np.uint8), ja.view(np.uint8))
        assert int(tacc[2]) == int(jacc[2])


def test_program_clone_for_test_drops_updates():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2, 2], "float32")
        lin = ptt.nn.Linear(2, 1)
        loss = lin(x).sum()
        ptt.optimizer.SGD(0.1, parameters=lin.parameters()).minimize(loss)
    test_prog = main.clone(for_test=True)
    assert test_prog.opt_updates == [] and test_prog.grad_requests == []
    w0 = lin.weight.numpy().copy()
    tstatic.Executor().run(test_prog, feed={"x": np.ones((2, 2), "float32")}, fetch_list=[loss])
    np.testing.assert_array_equal(lin.weight.numpy(), w0)  # eval: no update


def test_fetch_by_name_and_errors():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2], "float32")
        y = x * 2.0
    exe = tstatic.Executor()
    (got,) = exe.run(main, feed={"x": np.array([1.0, 2.0], "float32")}, fetch_list=["x"])
    np.testing.assert_array_equal(got, [1.0, 2.0])
    with pytest.raises(ValueError):
        exe.run(main, feed={"x": np.zeros(2, "float32")}, fetch_list=[torch.ones(2)])
    main.name_vars([("doubled", y)])
    (got,) = exe.run(main, feed={"x": np.array([1.0, 2.0], "float32")}, fetch_list=["doubled"])
    np.testing.assert_array_equal(got, [2.0, 4.0])


def test_two_append_backward_requests_independent():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2, 2], "float32")
        lin = ptt.nn.Linear(2, 1)
        loss1 = lin(x).sum()
        loss2 = (lin(x) ** 2).sum() * 0.0  # grad must be exactly 0
        pairs1 = tstatic.append_backward(loss1, parameter_list=[lin.weight])
        pairs2 = tstatic.append_backward(loss2, parameter_list=[lin.weight])
    g1, g2 = tstatic.Executor().run(main, feed={"x": np.ones((2, 2), "float32")},
                                    fetch_list=[pairs1[0][1], pairs2[0][1]])
    np.testing.assert_allclose(g1, np.full((2, 1), 2.0), rtol=1e-6)
    np.testing.assert_allclose(g2, np.zeros((2, 1)), atol=1e-7)  # NOT contaminated by loss1


def test_static_minimize_with_clip_and_wd_matches_jax():
    jl, tl = _linear_pair(3, 1)
    w = {}
    for pkg, st, lin, name in ((paddle, jstatic, jl, "jax"), (ptt, tstatic, tl, "port")):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            x = st.data("x", [4, 3], "float32")
            loss = (lin(x) * pkg.to_tensor(np.float32(100.0))).sum()  # clip must engage
            pkg.optimizer.SGD(0.1, parameters=lin.parameters(), weight_decay=0.01,
                              grad_clip=pkg.nn.ClipGradByGlobalNorm(1.0)).minimize(loss)
        st.Executor().run(main, feed={"x": np.ones((4, 3), "float32")}, fetch_list=[loss])
        w[name] = lin.weight.numpy().copy()
    np.testing.assert_allclose(w["port"], w["jax"], **F32)


def test_external_int_tensor_does_not_break_grads():
    idx = torch.tensor([0, 1])  # created OUTSIDE the guard
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2, 3], "float32")
        emb = ptt.nn.Embedding(4, 3)
        loss = emb(idx).sum() + x.sum()
        pairs = tstatic.append_backward(loss, parameter_list=[emb.weight])
    (g,) = tstatic.Executor().run(main, feed={"x": np.zeros((2, 3), "float32")},
                                  fetch_list=[pairs[0][1]])
    assert g.shape == (4, 3) and g[:2].sum() > 0 and g[2:].sum() == 0


def test_dynamic_dim_python_read_hard_errors():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [-1, 4], "float32")
        assert x.shape[1] == 4  # static dims readable
        with pytest.raises(RuntimeError, match="dynamic"):
            x.shape[0]
        with pytest.raises(RuntimeError, match="dynamic"):
            list(x.shape)
        with pytest.raises(RuntimeError, match="dynamic"):
            x.size(0)
        y = (x * 2.0).sum()  # derived computations via ops stay fine
    (got,) = tstatic.Executor().run(main, feed={"x": np.ones((3, 4), "float32")}, fetch_list=[y])
    assert float(got) == 24.0


def test_inplace_on_a_program_var_raises():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2], "float32")
        y = x * 2.0
        with pytest.raises(RuntimeError, match="in-place"):
            y.add_(1.0)


def test_minimize_outside_capture_steps_eagerly():
    lin = ptt.nn.Linear(3, 1)
    w0 = lin.weight.detach().clone()
    opt = ptt.optimizer.SGD(0.1, parameters=lin.parameters())
    assert opt.minimize(lin(torch.ones(2, 3)).sum()) == (None, None)
    assert not torch.equal(lin.weight, w0)


# ---------------------------------------------------------------------------
# the capture point: op names, AMP and randomness carried in the recorded fn
# ---------------------------------------------------------------------------

def test_function_form_and_method_form_record_their_own_meaning():
    """C-trap20: paddle.max(x, axis) is paddle's (the values); x.max(1)
    keeps torch's ((values, indices)); each replays what was called."""
    xv = np.random.RandomState(2).randn(3, 4).astype("float32")
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [3, 4], "float32")
        a = ptt.max(x, axis=1)
        vals, idx = x.max(1)
    assert _names(main) == ["max", "max"]
    assert [len(op.out_vars) for op in main.ops] == [1, 2]
    got = tstatic.Executor().run(main, feed={"x": xv}, fetch_list=[a, vals, idx])
    np.testing.assert_array_equal(got[0], xv.max(1))
    np.testing.assert_array_equal(got[1], xv.max(1))
    np.testing.assert_array_equal(got[2], xv.argmax(1))


def test_recorded_fn_carries_its_amp_state():
    """A program captured under auto_cast(O1) runs its linear in bf16 when
    replayed outside auto_cast; one captured outside runs f32 inside one."""
    xv = np.random.RandomState(3).randn(4, 8).astype("float32")
    lin = ptt.nn.Linear(8, 8)
    progs = {}
    for amp_on in (True, False):
        main = tstatic.Program()
        with tstatic.program_guard(main, tstatic.Program()):
            x = tstatic.data("x", [4, 8], "float32")
            if amp_on:
                with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
                    y = lin(x)
            else:
                y = lin(x)
        progs[amp_on] = (main, y)
    exe = tstatic.Executor()
    (low,) = exe.run(progs[True][0], feed={"x": xv}, fetch_list=[progs[True][1]],
                     return_numpy=False)
    with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
        (high,) = exe.run(progs[False][0], feed={"x": xv}, fetch_list=[progs[False][1]],
                          return_numpy=False)
        want_low = lin(torch.from_numpy(xv))
    assert low.dtype == torch.bfloat16 and high.dtype == torch.float32
    assert torch.equal(low, want_low)
    np.testing.assert_allclose(high.numpy(), lin(torch.from_numpy(xv)).detach().numpy(), **F32)


def test_random_op_replays_the_capture_draw():
    """A dropout recorded under capture draws the capture's mask again at
    every replay (the JAX package closes over the capture's key), and the
    replay leaves the framework generators where they were."""
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [64], "float32")
        y = ptt.nn.functional.dropout(x, p=0.5)
    exe = tstatic.Executor()
    feed = {"x": np.ones(64, "float32")}
    state0 = ptt.get_rng_state()
    a = exe.run(main, feed=feed, fetch_list=[y])[0]
    b = exe.run(main, feed=feed, fetch_list=[y])[0]
    np.testing.assert_array_equal(a, b)
    assert 0 < (a == 0).sum() < 64
    assert all(torch.equal(state0[k], v) for k, v in ptt.get_rng_state().items())


def numpy_inits(mp, seed=0):
    """Stand-ins for the JAX package's Normal and XavierUniform draws from a
    seeded numpy generator: the weights are carried into the port, and
    jax.random would compile once a parameter shape."""
    import math

    import jax.numpy as jnp
    from paddle_tpu.nn import initializer as jinit

    rng = np.random.RandomState(seed)

    def normal(self, shape, dtype):
        return jnp.asarray((rng.randn(*shape) * self.std + self.mean).astype("float32")).astype(dtype)

    def xavier(self, shape, dtype):
        fi, fo = jinit._fans(shape)
        lim = self.gain * math.sqrt(6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return jnp.asarray(rng.uniform(-lim, lim, shape).astype("float32")).astype(dtype)

    mp.setattr(jinit.Normal, "__call__", normal)
    mp.setattr(jinit.XavierUniform, "__call__", xavier)


def _tiny_llama_pair(**kw):
    from paddle_tpu.models.llama import LlamaForCausalLM as J
    from paddle_tpu_torch.models.llama import LlamaForCausalLM as T

    cfg = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=48)
    cfg.update(kw)
    with pytest.MonkeyPatch.context() as mp:
        numpy_inits(mp)
        jm = J(**cfg)
    tm = T(**cfg)
    tm.load_state_dict(state_from_paddle_tpu(_np_state(jm)))
    return jm, tm


@pytest.fixture(scope="module")
def llama_pair():
    ptt.set_device("cpu")
    jm, tm = _tiny_llama_pair()
    jm.eval()
    tm.eval()
    return jm, tm


def test_llama_capture_names_and_outputs_match_jax(llama_pair):
    from paddle_tpu.jit import capture_program as jcap
    from paddle_tpu_torch.jit import capture_program as tcap

    jm, tm = llama_pair
    ids = (np.arange(8) % 64).reshape(1, 8).astype("int64")
    jprog, _, jfetch = jcap(jm, paddle.to_tensor(ids), feed_names=["ids"])
    tprog, _, tfetch = tcap(tm, torch.from_numpy(ids), feed_names=["ids"])
    assert _names(tprog) == _names(jprog)
    (want,) = jstatic.Executor().run(jprog, feed={"ids": ids}, fetch_list=jfetch)
    (got,) = tstatic.Executor().run(tprog, feed={"ids": ids}, fetch_list=tfetch)
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    # the capture keeps no dry-run activations: interior vars are meta
    interior = [tprog._var_tensors[v] for op in tprog.ops[:-1] for v in op.out_vars]
    assert interior and all(t.is_meta for t in interior)


def test_llama_train_capture_names_match_jax(llama_pair):
    jm, tm = llama_pair
    names = {}
    for st, m, key in ((jstatic, jm, "jax"), (tstatic, tm, "port")):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            ids = st.data("ids", [2, 8], "int64")
            labels = st.data("labels", [2, 8], "int64")
            m(ids, labels=labels)
        names[key] = _names(main)
    assert names["port"] == names["jax"]
    assert names["port"][-3:] == ["getitem", "getitem", "fused_linear_cross_entropy"]


def _tiny_ernie_pair():
    from paddle_tpu.models import ErnieForMaskedLM as JM, ErnieModel as JE
    from paddle_tpu_torch.models import ErnieForMaskedLM as TM, ErnieModel as TE

    cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
               intermediate_size=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               max_position_embeddings=64)
    with pytest.MonkeyPatch.context() as mp:
        numpy_inits(mp)
        jm = JM(JE(**cfg))
    tm = TM(TE(**cfg))
    tm.load_state_dict(state_from_paddle_tpu(_np_state(jm)))
    return jm, tm


def _ernie_program(pkg, st, model, amp):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        ids = st.data("ids", [2, 8], "int64")
        labels = st.data("labels", [2, 8], "int64")
        if amp:
            with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss, _ = model(ids, labels=labels)
        else:
            loss, _ = model(ids, labels=labels)
        pkg.optimizer.AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01,
                            moment2_dtype="bfloat16").minimize(loss)
    return main, loss


def test_ernie_static_training_matches_jax():
    """Tiny ERNIE MLM as a static Program, AdamW through the fused bucket:
    the JAX package's op names and pass matches, and in f32 the same losses
    and parameters after 3 steps; under O1 the port records the same ops
    (the casts live inside the recorded fns)."""
    jm, tm = _tiny_ernie_pair()
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(1, 128, (2, 8)).astype("int64"),
            "labels": rng.randint(0, 128, (2, 8)).astype("int64")}
    names, matches, res = {}, {}, {}
    for pkg, st, m, key in ((paddle, jstatic, jm, "jax"), (ptt, tstatic, tm, "port")):
        pkg.set_flags({"FLAGS_fused_optimizer": True})
        main, loss = _ernie_program(pkg, st, m, amp=False)
        names[key] = _names(main)
        _, pipe = st.passes.run_default_pipeline(main, fetch_vars=[main._id2var[id(loss)]],
                                                 feed_names=list(feed))
        matches[key] = pipe.matches  # the pooler is dead: DCE takes its three ops
        exe = st.Executor()
        res[key] = ([float(exe.run(main, feed=feed, fetch_list=[loss])[0]) for _ in range(3)],
                    m.ernie.encoder.layers[0].linear1.weight.numpy().copy())
    assert names["port"] == names["jax"]
    assert matches["port"] == matches["jax"] and matches["port"]["dead_op_elimination"] == 3
    np.testing.assert_allclose(res["port"][0], res["jax"][0], **F32)
    np.testing.assert_allclose(res["port"][1], res["jax"][1], **F32)
    assert res["port"][0][2] < res["port"][0][0]
    assert _names(_ernie_program(ptt, tstatic, tm, amp=True)[0]) == names["jax"]


# ---------------------------------------------------------------------------
# what is refused, and what waits for a later slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["IpuStrategy", "IpuCompiledProgram", "ipu_shard_guard",
                                  "set_ipu_shard", "xpu_places"])
def test_names_the_jax_package_refuses_raise_as_there(name):
    """static.nn and the rest of extras.py are ported; the names the JAX
    package itself refuses (the IPU and XPU ones) raise RuntimeError in
    both packages."""
    for st in (jstatic, tstatic):
        fn = getattr(st, name)
        with pytest.raises(RuntimeError, match="IPU|XPU"):
            if name == "ipu_shard_guard":
                with fn():
                    pass
            elif name == "set_ipu_shard":
                fn(lambda: None)
            else:
                fn()


def test_unported_executor_hooks_raise(monkeypatch, tmp_path):
    """The two switches that raised until the guardian and the compile cache
    were ported now work: FLAGS_check_nan_inf checks what a run writes back
    and PADDLE_TPU_COMPILE_CACHE_DIR changes nothing the Executor computes
    (it persists kernel libraries, not replay plans)."""
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2], "float32")
        y = x * 2.0
    exe = tstatic.Executor()
    feed = {"x": np.ones(2, "float32")}
    ptt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        assert exe.run(main, feed=feed, fetch_list=[y])[0].tolist() == [2.0, 2.0]
    finally:
        ptt.set_flags({"FLAGS_check_nan_inf": False})
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    assert exe.run(main, feed=feed, fetch_list=[y])[0].tolist() == [2.0, 2.0]
    monkeypatch.delenv("PADDLE_TPU_COMPILE_CACHE_DIR")
    assert exe.run(main, feed=feed, fetch_list=[y])[0].tolist() == [2.0, 2.0]


def test_static_reachable_as_paddle_static():
    assert ptt.static is tstatic
    assert ptt.jit.capture_program is not None
    spec = tstatic.InputSpec([None, 4], "float32", "x")
    assert spec.shape == [None, 4] and "x" in repr(spec)
