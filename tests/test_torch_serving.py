"""Port parity for the serving slice: the tiny Llama, the engine steps, the
continuous-batching scheduler and the LLM predictor of paddle_tpu_torch
against the JAX package, from the same weights (carried across with
utils/convert.py) and the same prompts. Greedy ids must match token for
token; logits within f32 tolerance."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import engine as jeng
from paddle_tpu.inference import scheduler as jsch
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import engine as teng
from paddle_tpu_torch.inference import scheduler as tsch
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu, state_to_paddle_tpu

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # f32 throughout; matmul/softmax sums in another order
ENGINE = dict(max_seq_len=64, block_size=8, max_batch=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    ptt.set_device("cpu")
    paddle.seed(0)
    jm = jllama.llama_tiny(num_key_value_heads=2)
    jm.eval()
    np_state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(**jm.config, device="cpu")
    tm.load_state_dict(state_from_paddle_tpu(np_state))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def jax_engine(models):
    return jeng.InferenceEngine(models[0], **ENGINE)


def _prompts():
    rng = np.random.RandomState(3)
    p0 = rng.randint(0, 1024, (20,)).tolist()
    return [p0,
            p0[:16] + rng.randint(0, 1024, (5,)).tolist(),  # shares two full pages with p0
            rng.randint(0, 1024, (7,)).tolist(),
            rng.randint(0, 1024, (11,)).tolist()]


def test_weight_conversion_layout(models):
    jm, tm = models
    jstate = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tstate = tm.state_dict()
    # paddle's Linear [in, out] in both packages, and the embedding: unchanged
    w = "llama.layers.0.self_attn.k_proj.weight"
    assert jstate[w].shape == (64, 32) and tuple(tstate[w].shape) == (64, 32)
    np.testing.assert_array_equal(tstate[w].numpy(), jstate[w])
    e = "llama.embed_tokens.weight"
    np.testing.assert_array_equal(tstate[e].numpy(), jstate[e])
    back = state_to_paddle_tpu(tstate)
    for k, a in jstate.items():
        np.testing.assert_array_equal(back[k], a)


def test_rope_interleaved_pairing_matches():
    rng = np.random.RandomState(0)
    q = rng.randn(2, 5, 4, 16).astype(np.float32)
    k = rng.randn(2, 5, 2, 16).astype(np.float32)
    pos = np.asarray([[3, 4, 5, 6, 7], [40, 41, 42, 43, 44]], np.int32)
    jq, jk = jllama._rope(jnp.asarray(q), jnp.asarray(k), positions=pos, max_pos=64)
    tq, tk = tllama._rope(torch.from_numpy(q), torch.from_numpy(k),
                          positions=torch.from_numpy(pos), max_pos=64)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-6)


def test_llama_tiny_no_cache_logits(models):
    jm, tm = models
    ids = np.random.RandomState(1).randint(0, 1024, (2, 13))
    with paddle.no_grad():
        want = jm(paddle.to_tensor(ids.astype(np.int64))).numpy()
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_engine_prefill_decode_extend_logits(models, jax_engine):
    """Step by step through both engines on identical page allocations.
    Decode runs 3 rows in the 4-row bucket: the pad row reads one slot of
    the trash page (seq_len 1, all-trash table) and must not disturb the
    real rows."""
    jm, tm = models
    je, te = jax_engine, teng.InferenceEngine(tm, **ENGINE)
    je.pool.reset()
    prompts = _prompts()[:3]
    pages, jl, tl = [], [], []
    for p in prompts:
        pj = je.pool.alloc(je.pool.blocks_for_tokens(len(p) + 4))
        assert te.pool.alloc(len(pj)) == pj
        pages.append(pj)
        jl.append(je.prefill(p, pj))
        tl.append(te.prefill(p, pj))
    np.testing.assert_allclose(np.stack(tl), np.stack(jl), **LOGIT_TOL)
    toks = [int(np.argmax(x)) for x in jl]
    poss = [len(p) for p in prompts]
    args = (toks, poss, [x + 1 for x in poss], pages)
    np.testing.assert_allclose(te.decode(*args), je.decode(*args), **LOGIT_TOL)
    rows = [[toks[0], 5, 9], [toks[1]], [toks[2], 4]]
    prow = [list(range(x + 1, x + 1 + len(r))) for x, r in zip(poss, rows)]
    got = te.extend(rows, prow, pages, q_len=3)
    want = je.extend(rows, prow, pages, q_len=3)
    for i, r in enumerate(rows):  # pad slots hold garbage on both sides
        np.testing.assert_allclose(got[i, :len(r)], np.asarray(want[i, :len(r)]), **LOGIT_TOL)
    assert te.step_counts == {"prefill": 3, "decode": 1, "extend": 1}
    je.pool.reset()


def _run_sched(mod, engine, prompts, max_new, **kw):
    sched = mod.ContinuousBatchingScheduler(engine, **kw)
    reqs = [mod.Request(rid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    while not sched.idle():
        sched.step()
    assert engine.pool.used() == 0
    ids = [r.prompt[r.prompt_len:] + list(r.generated) for r in reqs]
    return ids, sched, reqs


def test_generate_ids_match_with_prefix_hit(models, jax_engine):
    jm, tm = models
    jax_engine.pool.reset()
    te = teng.InferenceEngine(tm, **ENGINE)
    j_ids, _, j_reqs = _run_sched(jsch, jax_engine, _prompts(), 8)
    t_ids, _, t_reqs = _run_sched(tsch, te, _prompts(), 8)
    assert t_ids == j_ids
    cached = [r.cached_tokens for r in t_reqs]
    assert cached == [r.cached_tokens for r in j_reqs] and cached[1] == 16
    assert te.generate(_prompts(), max_new_tokens=8) == t_ids


def test_preemption_trace_matches(models):
    """Two 31-token contexts (4 pages each at block 8) in a 5-page pool:
    the youngest is preempted and recomputed on resume; ids and decisions
    match."""
    jm, tm = models
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 1024, (19,)).tolist(), rng.randint(0, 1024, (19,)).tolist()]
    opts = dict(ENGINE, num_blocks=6, max_batch=2)
    j_ids, js, j_reqs = _run_sched(jsch, jeng.InferenceEngine(jm, **opts), prompts, 12)
    t_ids, ts, t_reqs = _run_sched(tsch, teng.InferenceEngine(tm, **opts), prompts, 12)
    assert t_ids == j_ids
    assert ts.preempted_total == js.preempted_total >= 1
    assert [r.preemptions for r in t_reqs] == [r.preemptions for r in j_reqs]


def test_spec_decode_ids_match(models):
    """Draft-then-verify through the extend kernel path: drafts are
    proposed, some accepted and some rolled back, with ids equal to the
    JAX package's and to plain decode."""
    jm, tm = models
    motif = np.random.RandomState(2).randint(0, 64, (5,)).tolist()
    prompts = [motif * 4, motif[:3] * 3]
    opts = dict(ENGINE, max_batch=2)
    spec = dict(draft_len=3, ngram=2)
    j_ids, _, j_reqs = _run_sched(jsch, jeng.InferenceEngine(jm, **opts), prompts, 24,
                                  spec_decode=jsch.SpecDecodeConfig(**spec))
    t_ids, _, t_reqs = _run_sched(tsch, teng.InferenceEngine(tm, **opts), prompts, 24,
                                  spec_decode=tsch.SpecDecodeConfig(**spec))
    assert t_ids == j_ids
    counts = [(r.drafted, r.accepted) for r in t_reqs]
    assert counts == [(r.drafted, r.accepted) for r in j_reqs]
    assert all(d > a > 0 for d, a in counts)
    plain, _, _ = _run_sched(tsch, teng.InferenceEngine(tm, **opts), prompts, 24)
    assert plain == t_ids  # greedy verify emits exactly what plain decode does


def test_predictor_run_matches_jax(models, tmp_path):
    """The port serves the JAX package's save_llm artifact, and the JAX
    package reads the port's: ids equal the JAX LLMPredictor's."""
    from paddle_tpu import inference as jinf
    from paddle_tpu_torch import inference as tinf

    jm, tm = models
    prefix = str(tmp_path / "jax" / "tiny")
    jinf.save_llm(jm, prefix)
    ids = np.zeros((3, 21), np.int64)
    lens = np.asarray([20, 7, 11], np.int64)
    for i, p in enumerate([_prompts()[0], _prompts()[2], _prompts()[3]]):
        ids[i, :len(p)] = p
    opts = dict(max_new_tokens=6, **ENGINE)

    def run(mod, cfg_prefix, cpu=False, replicas=1):
        cfg = mod.Config(cfg_prefix)
        if cpu:
            cfg.disable_gpu()
        cfg.enable_llm_engine(llm_replicas=replicas, **opts)
        pred = mod.create_predictor(cfg)
        pred.get_input_handle("input_ids").copy_from_cpu(ids)
        pred.get_input_handle("seq_lens").copy_from_cpu(lens)
        pred.run()
        return pred.get_output_handle("generated_ids").copy_to_cpu()

    want = run(jinf, prefix)
    np.testing.assert_array_equal(run(tinf, prefix, cpu=True), want)
    tprefix = str(tmp_path / "torch" / "tiny")
    tinf.save_llm(tm, tprefix)
    reloaded = jinf.load_llm(tprefix)
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(reloaded.state_dict()[k]._value),
                                      np.asarray(v._value))
    # the fleet-backed predictor (two engines over one model) gives the same ids
    np.testing.assert_array_equal(run(tinf, prefix, cpu=True, replicas=2), want)


def test_port_imports_no_jax_and_needs_a_device_choice():
    """In a fresh interpreter: the port never imports jax or the JAX
    package, and without CUDA an entry point raises until the caller asks
    for the CPU."""
    code = r"""
import sys, torch
import paddle_tpu_torch as ptt
from paddle_tpu_torch.models.llama import llama_tiny
from paddle_tpu_torch.inference import InferenceEngine
if not torch.cuda.is_available():
    try:
        llama_tiny()
    except RuntimeError as e:
        assert "set_device" in str(e), e
    else:
        raise AssertionError("a CPU-only box must raise without set_device('cpu')")
ptt.set_device("cpu")
ptt.seed(0)
eng = InferenceEngine(llama_tiny(num_key_value_heads=2).eval(), max_seq_len=32, block_size=8,
                      max_batch=2)
out = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12]], max_new_tokens=4)
assert [len(o) for o in out] == [4, 4], out
# the telemetry, resilience, QoS and fleet modules, driven once
import paddle_tpu_torch.telemetry.exporters, paddle_tpu_torch.telemetry.request_trace
import paddle_tpu_torch.telemetry.timeline, paddle_tpu_torch.distributed.resilience.retry
from paddle_tpu_torch.distributed.resilience import FaultPlan, install_plan, clear_plan
from paddle_tpu_torch.inference import QoSConfig, QoSPolicy, ReplicaFleet
fleet = ReplicaFleet([eng, InferenceEngine(eng._model, max_seq_len=32, block_size=8,
                                           max_batch=2, kv_dtype="int8")],
                     tiers=("prefill", "decode"), qos=QoSPolicy(QoSConfig(max_waiting=4)))
install_plan(FaultPlan().add("fleet.kv_migrate.*", "corrupt"))
assert [len(o) for o in fleet.generate([[1, 2, 3]], max_new_tokens=3)] == [3]
clear_plan()
assert fleet.migration_crc_rejects == 1
assert "paddle_tpu_fleet_kv_migrations_total" in ptt.telemetry.to_prometheus()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_load_weights_rebinds_one_engine_and_drops_prefix_index(models):
    """C5: two engines over one model; swapping engine 0's weights leaves
    the model's tensors and engine 1 (ids and tensors) untouched, as in
    the JAX package, whose run of the same gives the same ids."""
    jm, tm = models
    prompts = _prompts()[:2]
    scaled = {k: np.asarray(v._value) * np.float32(1.5) for k, v in jm.state_dict().items()}
    model_before = {k: v.clone() for k, v in tm.state_dict().items()}
    t0, t1 = teng.InferenceEngine(tm, **ENGINE), teng.InferenceEngine(tm, **ENGINE)
    j0, j1 = jeng.InferenceEngine(jm, **ENGINE), jeng.InferenceEngine(jm, **ENGINE)
    before = t0.generate(prompts, max_new_tokens=4)
    assert before == j0.generate(prompts, max_new_tokens=4)
    assert t0.pool.prefix_index_size() > 0
    p1 = dict(t1.params)
    assert t0.load_weights(state_from_paddle_tpu(scaled)) == 1 == j0.load_weights(scaled)
    assert t0.pool.prefix_index_size() == 0 and t0.pool.retained() == 0
    swapped = t0.generate(prompts, max_new_tokens=4)
    assert swapped == j0.generate(prompts, max_new_tokens=4) != before
    # the other engine and the model keep the old weights (same tensors)
    assert t1.generate(prompts, max_new_tokens=4) == before == j1.generate(prompts, max_new_tokens=4)
    assert all(t1.params[k] is v for k, v in p1.items())
    for k, v in tm.state_dict().items():
        assert torch.equal(v, model_before[k]), k
    ref = tllama.LlamaForCausalLM(**jm.config, device="cpu").eval()
    ref.load_state_dict(state_from_paddle_tpu(scaled))
    assert teng.InferenceEngine(ref, **ENGINE).generate(prompts, max_new_tokens=4) == swapped
    with pytest.raises(ValueError, match="shape"):
        t0.load_weights({k: v[..., :1] for k, v in model_before.items()})
    assert t0.weights_version == 1  # a refused swap changes nothing
    assert t0.load_weights(model_before) == 2
    assert t0.generate(prompts, max_new_tokens=4) == before


def test_io_bf16_round_trip_with_jax_package(tmp_path):
    """bf16 tensors are stored as ml_dtypes.bfloat16 arrays, the JAX
    package's format, in both directions."""
    import ml_dtypes

    from paddle_tpu.framework import io as jio
    from paddle_tpu_torch.framework import io as tio

    t = torch.randn(3, 5).to(torch.bfloat16)
    tio.save({"w": t, "n": [1, 2]}, str(tmp_path / "a.pd"))
    got = jio.load(str(tmp_path / "a.pd"), return_numpy=True)
    assert got["w"].dtype == ml_dtypes.bfloat16 and got["n"] == [1, 2]
    np.testing.assert_array_equal(got["w"].astype(np.float32), t.float().numpy())
    jio.save({"w": paddle.to_tensor(got["w"])}, str(tmp_path / "b.pd"))
    back = tio.load(str(tmp_path / "b.pd"))["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
