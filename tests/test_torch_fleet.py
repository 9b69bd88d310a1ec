"""Port parity for the replica fleet (inference/fleet.py), the engine's hot
swap (C5) and the KV payload migration (inference/kv_cache.py): the same
scenario, written once against a package namespace, runs through the JAX
package and through paddle_tpu_torch from the same weights (carried across
with utils/convert.py), the same seeded traffic, the same injected clock
and the same FaultPlans. Decisions (outcomes, routing, evacuations,
migrations, modes, the telemetry they publish and the incident timeline)
and greedy ids must be equal; nothing here is held to a tolerance."""
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu.distributed.resilience import fault_injection as jfi
from paddle_tpu.inference import engine as jeng
from paddle_tpu.inference import fleet as jfl
from paddle_tpu.inference import kv_cache as jkvc
from paddle_tpu.inference import scheduler as jsch
from paddle_tpu.models import llama as jllama
from paddle_tpu.telemetry import metrics as jtm
from paddle_tpu.telemetry import timeline as jtl

import paddle_tpu_torch as ptt
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.distributed.resilience import fault_injection as tfi
from paddle_tpu_torch.inference import engine as teng
from paddle_tpu_torch.inference import fleet as tfl
from paddle_tpu_torch.inference import kv_cache as tkvc
from paddle_tpu_torch.inference import scheduler as tsch
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.telemetry import metrics as ttm
from paddle_tpu_torch.telemetry import timeline as ttl
from paddle_tpu_torch.utils.convert import state_from_paddle_tpu

ENGINE = dict(max_seq_len=64, block_size=8, max_batch=4, decode_batch_buckets=(4,))
# the sources of the timeline records both packages emit on these paths
TIMELINE_SOURCES = ("fleet", "scheduler", "qos", "resilience")
# the JAX engine counts its bucket dispatches (it compiles a program a
# bucket); the port's eager engine compiles nothing and counts none
NOT_COMPARED = ("paddle_tpu_serving_bucket_events_total",)
COMPARED_PREFIXES = ("paddle_tpu_fleet", "paddle_tpu_serving", "paddle_tpu_kv", "paddle_tpu_qos",
                     "paddle_tpu_faults", "paddle_tpu_spec")


@pytest.fixture(scope="module")
def pkgs():
    ptt.set_device("cpu")
    paddle.seed(0)
    jm = jllama.llama_tiny(num_key_value_heads=2)
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(**jm.config, device="cpu")
    tm.load_state_dict(state_from_paddle_tpu(state))
    tm.eval()
    paddle.seed(0)
    jb = jllama.llama_tiny(num_key_value_heads=2)
    jb.eval()
    jb.to(dtype="bfloat16")
    tb = tllama.LlamaForCausalLM(**jb.config, device="cpu", dtype="bfloat16")
    tb.load_state_dict(state_from_paddle_tpu(
        {k: np.asarray(v._value) for k, v in jb.state_dict().items()}))
    tb.eval()
    scaled = {k: a * np.float32(1.25) for k, a in state.items()}
    jax_ns = SimpleNamespace(name="jax", eng=jeng, fl=jfl, sch=jsch, fi=jfi, kvc=jkvc, tm=jtm,
                             tl=jtl, inf=jinf, model=jm, bf16=jb,
                             weights=lambda: dict(scaled))
    torch_ns = SimpleNamespace(name="torch", eng=teng, fl=tfl, sch=tsch, fi=tfi, kvc=tkvc,
                               tm=ttm, tl=ttl, inf=tinf, model=tm, bf16=tb,
                               weights=lambda: state_from_paddle_tpu(scaled))
    yield {"jax": jax_ns, "torch": torch_ns}
    for ns in (jax_ns, torch_ns):
        ns.fi.clear_plan()


def _clock():
    t = [0.0]

    def clock():
        t[0] += 0.0005
        return t[0]
    return clock


def _requests(ns, n=10, seed=13, sessions=False, shared_prefix=0, gap=0.002):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 1024, (shared_prefix,)).tolist()
    out, t = [], 0.0
    for i in range(n):
        t += rng.exponential(gap)
        out.append(ns.sch.Request(
            rid=i, prompt=prefix + rng.randint(0, 1024, (int(rng.randint(3, 14)),)).tolist(),
            max_new_tokens=int(rng.choice([3, 6, 10])), arrival_time=t,
            session=(i % 3 if sessions else None)))
    return out


def _engines(ns, n, model=None, **kw):
    return [ns.eng.InferenceEngine(model if model is not None else ns.model, **dict(ENGINE, **kw))
            for _ in range(n)]


def _metrics(ns) -> dict:
    out = {}
    for s in ns.tm.default_registry().collect():
        if s["name"] in NOT_COMPARED or not s["name"].startswith(COMPARED_PREFIXES):
            continue
        key = (s["name"], tuple(sorted(s["labels"].items())))
        out[key] = (s["count"], s["sum"]) if s["type"] == "histogram" else s["value"]
    return out


def _delta(before: dict, after: dict, ns) -> dict:
    kinds = {s["name"]: s["type"] for s in ns.tm.default_registry().collect()}
    out = {}
    for k, v in after.items():
        if kinds[k[0]] == "gauge":
            out[k] = v
        elif kinds[k[0]] == "histogram":
            b = before.get(k, (0, 0.0))
            out[k] = (v[0] - b[0], round(v[1] - b[1], 9))
        elif v != before.get(k, 0):
            out[k] = v - before.get(k, 0)
    return out


def _fleet_record(fleet, stats=None) -> dict:
    reqs = [(r.rid, r.outcome, r.shed_reason, r.retry_after_s, r.preemptions, r.cached_tokens,
             r.prompt[r.prompt_len:] + list(r.generated), r.first_token_time, r.finish_time)
            for r in fleet.finished]
    rec = dict(
        requests=reqs, mode=fleet.mode(), evacuated=fleet.evacuated_total,
        failures=fleet.failures_total, swaps=fleet.swaps_completed,
        migrations=fleet.migrations_total, fallbacks=fleet.migration_fallbacks,
        crc_rejects=fleet.migration_crc_rejects, deferred=fleet.migration_deferred,
        migration_failures=fleet.migration_failures, pages=fleet.migrated_pages_total,
        prefix_routed=fleet.prefix_routed_total,
        status=[r.status for r in fleet.replicas],
        versions=[r.engine.weights_version for r in fleet.replicas],
        sessions=list(fleet._session_home.items()),
        owners=sorted(fleet._prefix_owner.values()),
        pools=[(r.engine.pool.used(), r.engine.pool.retained()) for r in fleet.replicas])
    if stats is not None:
        rec["stats"] = dict(stats)
    return rec


def _observe(ns, fn):
    """Run a scenario with the incident timeline on; returns its record plus
    the metric deltas and the timeline events it produced."""
    ns.fi.clear_plan()
    ns.tl.reset()
    paddle_mod = paddle if ns.name == "jax" else ptt
    paddle_mod.set_flags({"FLAGS_incident_timeline": True})
    # gauges are compared by value: drop the compared families that earlier
    # tests in this process left in either registry (the scenario's fleet
    # and engines are built after this and register theirs anew)
    reg = ns.tm.default_registry()
    for name in {s["name"] for s in reg.collect()}:
        if name.startswith(COMPARED_PREFIXES):
            reg.unregister(name)
    before = _metrics(ns)
    try:
        rec = fn(ns)
    finally:
        paddle_mod.set_flags({"FLAGS_incident_timeline": False})
        ns.fi.clear_plan()
    rec["metrics"] = _delta(before, _metrics(ns), ns)
    rec["timeline"] = [(r["source"], r["kind"], r["severity"], r["labels"], r["payload"])
                       for r in ns.tl.recorder().records() if r["source"] in TIMELINE_SOURCES]
    # `matched` counts observations within 5 s of wall time of each injection:
    # it depends on how fast the run went, the rest does not
    rec["coverage"] = {k: v for k, v in ns.tl.chaos_coverage().items() if k != "matched"}
    return rec


# ---------------------------------------------------------------------------
# scenarios, each written once against a package namespace
# ---------------------------------------------------------------------------

def _routing_affinity(ns):
    fleet = ns.fl.ReplicaFleet(_engines(ns, 3), clock=_clock())
    stats = ns.fl.fleet_replay(fleet, _requests(ns, n=12, sessions=True))
    return _fleet_record(fleet, stats)


def _kill_mid_decode(ns):
    fleet = ns.fl.ReplicaFleet(_engines(ns, 2), clock=_clock())

    def kill():
        ns.fi.install_plan(ns.fi.FaultPlan().add("fleet.replica_step.1", "fail", times=2))
    stats = ns.fl.fleet_replay(fleet, _requests(ns), events=[(3, kill)])
    return _fleet_record(fleet, stats)


def _half_open_recovers(ns):
    fleet = ns.fl.ReplicaFleet(_engines(ns, 2), clock=_clock(), breaker_threshold=3)

    def blip():
        ns.fi.install_plan(ns.fi.FaultPlan().add("fleet.replica_step.0", "fail", times=1))
    stats = ns.fl.fleet_replay(fleet, _requests(ns), events=[(2, blip)])
    return _fleet_record(fleet, stats)


def _route_fault_retried(ns):
    fleet = ns.fl.ReplicaFleet(_engines(ns, 2), clock=_clock())
    ns.fi.install_plan(ns.fi.FaultPlan().add("fleet.route", "fail", times=2))
    raised = []
    for r in _requests(ns, n=6):
        while True:
            try:
                fleet.submit(r)
                break
            except ns.fi.FaultInjected as e:
                raised.append((r.rid, e.site))
    while not fleet.idle():
        fleet.step()
    return dict(_fleet_record(fleet), raised=raised, submitted=fleet.submitted_total)


def _all_down_raises(ns):
    fleet = ns.fl.ReplicaFleet(_engines(ns, 2), clock=_clock(), breaker_threshold=1)
    ns.fi.install_plan(ns.fi.FaultPlan().add("fleet.replica_step.*", "fail", times=None))
    for r in _requests(ns, n=4):
        fleet.submit(r)
    with pytest.raises(ns.fl.NoHealthyReplica) as err:
        for _ in range(10):
            fleet.step()
    return dict(_fleet_record(fleet), error=str(err.value), held=len(fleet._pending))


def _swap_mapping(ns):
    fleet = ns.fl.ReplicaFleet(_engines(ns, 3), clock=_clock())
    snaps = []

    def snap():
        snaps.append([r.engine.weights_version for r in fleet.replicas])
        if ns.name == "torch":
            model = dict(ns.model.state_dict(keep_vars=True))
            snaps.append([all(r.engine.params[k] is v for k, v in model.items())
                          for r in fleet.replicas])
    stats = ns.fl.fleet_replay(fleet, _requests(ns, n=12), events=[
        (3, lambda: fleet.request_swap(ns.weights())), (4, snap), (6, snap)])
    return dict(_fleet_record(fleet, stats), snaps=snaps[::2] if ns.name == "torch" else snaps,
                _port_only=snaps[1::2] if ns.name == "torch" else None)


def _disagg(ns, kv_dtype="int8", model=None, plan=None, events=(), prefix=0, n=8):
    model = model if model is not None else ns.model
    fleet = ns.fl.ReplicaFleet(
        _engines(ns, 1, model) + _engines(ns, 1, model, **({"kv_dtype": kv_dtype}
                                                            if kv_dtype else {})),
        clock=_clock(), tiers=("prefill", "decode"))
    fleet.prewarm()
    if plan is not None:
        ns.fi.install_plan(plan)
    stats = ns.fl.fleet_replay(fleet, _requests(ns, n=n, shared_prefix=prefix),
                               events=list(events))
    return _fleet_record(fleet, stats)


def _tiered_int8(ns):
    return _disagg(ns, "int8", prefix=16)


def _tiered_bf16(ns):
    """bf16 -> bf16 pages (a pure page move, CRC-verified on readback).
    bf16 rounds at other points in XLA and in torch, and with the batch
    makeup, so the two packages' bf16 ids are not compared: the decisions
    are (no request ends on an EOS here, so they do not depend on ids)."""
    rec = _disagg(ns, None, model=ns.bf16)
    rec["requests"] = [r[:6] + r[7:] for r in rec["requests"]]
    return rec


def _migration_fail(ns):
    return _disagg(ns, None, plan=ns.fi.FaultPlan().add("fleet.kv_migrate.*", "fail", times=2))


def _migration_corrupt(ns):
    return _disagg(ns, "int8", plan=ns.fi.FaultPlan().add("fleet.kv_migrate.*", "corrupt",
                                                          times=1, arg=5))


def _migration_perma_fault(ns):
    return _disagg(ns, None, plan=ns.fi.FaultPlan().add("fleet.kv_migrate.*", "fail",
                                                        times=None))


def _decode_tier_death(ns):
    kill = lambda: ns.fi.install_plan(  # noqa: E731
        ns.fi.FaultPlan().add("fleet.replica_step.1", "fail", times=2))
    return _disagg(ns, "int8", events=[(2, kill)])


def _prefill_tier_death_then_revive(ns):
    fleet = ns.fl.ReplicaFleet(_engines(ns, 2) + _engines(ns, 1), clock=_clock(),
                               tiers=("prefill", "prefill", "decode"))
    modes = []

    def kill():
        ns.fi.install_plan(ns.fi.FaultPlan().add("fleet.replica_step.[01]", "fail", times=4))

    def revive():
        modes.append(fleet.mode())
        fleet.revive(0)
        modes.append((fleet.mode(), fleet._resplit))
    stats = ns.fl.fleet_replay(fleet, _requests(ns, n=12), events=[(2, kill), (7, revive)])
    return dict(_fleet_record(fleet, stats), modes=modes, health=fleet.tier_health())


def _prefix_owner_routing(ns):
    # untiered 3 replicas, a shared 2-page prefix: later requests route to
    # the owner; the owner dies and ownership fails over
    fleet = ns.fl.ReplicaFleet(_engines(ns, 3), clock=_clock())
    owners = []

    def kill_owner():
        owners.append(sorted(set(fleet._prefix_owner.values())))
        idx = owners[-1][0] if owners[-1] else 0
        ns.fi.install_plan(ns.fi.FaultPlan().add(f"fleet.replica_step.{idx}", "fail", times=2))
    stats = ns.fl.fleet_replay(fleet, _requests(ns, n=14, shared_prefix=16, gap=0.03),
                               events=[(5, kill_owner)])
    return dict(_fleet_record(fleet, stats), owners=owners)


SCENARIOS = {
    "routing_affinity": _routing_affinity,
    "kill_mid_decode": _kill_mid_decode,
    "half_open_recovers": _half_open_recovers,
    "route_fault_retried": _route_fault_retried,
    "all_down_raises": _all_down_raises,
    "swap_mapping": _swap_mapping,
    "tiered_f32_to_int8": _tiered_int8,
    "tiered_bf16": _tiered_bf16,
    "migration_fail": _migration_fail,
    "migration_corrupt": _migration_corrupt,
    "migration_perma_fault": _migration_perma_fault,
    "decode_tier_death": _decode_tier_death,
    "prefill_tier_death_then_revive": _prefill_tier_death_then_revive,
    "prefix_owner_routing": _prefix_owner_routing,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_scenario_matches_jax(pkgs, name):
    want = _observe(pkgs["jax"], SCENARIOS[name])
    got = _observe(pkgs["torch"], SCENARIOS[name])
    want.pop("_port_only", None)
    port_only = got.pop("_port_only", None)
    for key in want:
        assert got[key] == want[key], key
    assert set(got) == set(want)
    assert got["coverage"]["unobserved_faults"] == 0
    if "stats" in got:
        assert got["stats"]["lost"] == 0 and got["stats"]["duplicated"] == 0
    if name == "swap_mapping":
        # mid-rollout: a replica not yet swapped still runs on the model's
        # own tensors; a swapped one does not
        assert got["snaps"][0] != [1, 1, 1] and port_only[0] == [v == 0 for v in got["snaps"][0]]
        assert got["versions"] == [1, 1, 1]


def test_scenarios_exercise_what_they_name(pkgs):
    """The scenarios above reach the paths they are named for (so the
    equalities are not over empty runs)."""
    ns = pkgs["torch"]
    kill = _observe(ns, _kill_mid_decode)
    assert kill["evacuated"] > 0 and kill["failures"] == 2 and kill["status"][1] == "down"
    swap = _observe(ns, _swap_mapping)
    assert swap["swaps"] == 1 and swap["versions"] == [1, 1, 1]
    tiered = _observe(ns, _tiered_int8)
    assert tiered["migrations"] == 8 and tiered["fallbacks"] == 0 and tiered["prefix_routed"] > 0
    corrupt = _observe(ns, _migration_corrupt)
    assert corrupt["crc_rejects"] == 1 and corrupt["migration_failures"] == 0
    death = _observe(ns, _decode_tier_death)
    assert death["mode"] == "monolithic"
    revive = _observe(ns, _prefill_tier_death_then_revive)
    assert revive["modes"][0] == "streamed_prefill" and revive["modes"][1][0] == "disaggregated"
    owner = _observe(ns, _prefix_owner_routing)
    assert owner["prefix_routed"] > 0 and owner["evacuated"] >= 0


# ---------------------------------------------------------------------------
# C5 through the fleet: a swap mid-replay leaves the other replicas alone
# ---------------------------------------------------------------------------

def test_request_swap_mid_replay_leaves_other_replicas_untouched(pkgs):
    """While replica 0 is swapped and replica 1 is not, replica 1 still runs
    the model's own tensors (same objects, same values), the model is
    unchanged, and the ids of both packages' runs are equal."""
    tns = pkgs["torch"]
    model_state = {k: v.clone() for k, v in tns.model.state_dict().items()}
    seen = {"jax": [], "torch": [], "r1_is_model": []}

    def run(ns):
        fleet = ns.fl.ReplicaFleet(_engines(ns, 2), clock=_clock())

        step = fleet.step

        def probed_step():  # the version split after every fleet tick
            out = step()
            seen[ns.name].append([r.engine.weights_version for r in fleet.replicas])
            if ns.name == "torch":
                r1 = fleet.replicas[1].engine
                seen["r1_is_model"].append(all(r1.params[k] is v for k, v in
                                               ns.model.state_dict(keep_vars=True).items()))
            return out
        fleet.step = probed_step
        stats = ns.fl.fleet_replay(fleet, _requests(ns, n=10), events=[
            (1, lambda: fleet.request_swap(ns.weights()))])
        assert stats["lost"] == 0 and stats["swaps_completed"] == 1
        return _fleet_record(fleet)["requests"]

    assert run(tns) == run(pkgs["jax"])
    assert seen["torch"] == seen["jax"]
    split = [i for i, v in enumerate(seen["torch"]) if v == [1, 0]]
    assert split and all(seen["r1_is_model"][i] for i in split)
    for k, v in tns.model.state_dict().items():
        assert torch.equal(v, model_state[k]), k


def test_checkpoint_swap_raises_until_distributed_checkpoint(pkgs, tmp_path):
    ns = pkgs["torch"]
    eng = _engines(ns, 1)[0]
    with pytest.raises(NotImplementedError, match="item 5"):
        eng.load_weights_from_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 5"):
        eng.checkpoint_template()
    fleet = ns.fl.ReplicaFleet([eng], clock=_clock())
    fleet.request_swap(str(tmp_path))  # the idle replica drains ...
    with pytest.raises(NotImplementedError, match="item 5"):
        fleet.step()  # ... and its swap raises; the rollout aborts cleanly
    assert not fleet.swap_in_progress() and eng.weights_version == 0
    assert fleet.replicas[0].status == "healthy"


# ---------------------------------------------------------------------------
# payloads: the host-side migration format crosses between the packages
# ---------------------------------------------------------------------------

def _seeded_kv(seed=0):
    """Seeded K/V planes of a 2-layer pool of 5 pages (block 8, 2 kv heads,
    head dim 16), as numpy f32."""
    rng = np.random.RandomState(seed)
    k = [rng.randn(5, 8, 2, 16).astype(np.float32) * 3 for _ in range(2)]
    v = [rng.randn(5, 8, 2, 16).astype(np.float32) for _ in range(2)]
    return k, v


def _jax_pool(k, v, dtype):
    import jax.numpy as jnp

    pool = jkvc.BlockPool(5, 8, 2, 2, 16, dtype=dtype)
    pool.adopt([jnp.asarray(a, dtype) for a in k], [jnp.asarray(a, dtype) for a in v])
    return pool


def _port_pool(k, v, dtype):
    pool = tkvc.BlockPool(5, 8, 2, 2, 16, dtype=dtype, device="cpu")
    pool.adopt([torch.from_numpy(a).to(dtype) for a in k], [torch.from_numpy(a).to(dtype) for a in v])
    return pool


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payload_convert_and_crcs_match_jax(dtype):
    """The same pages exported by both packages: equal bytes and CRCs; the
    int8 re-encode gives equal int8 bytes and f32 scales, which also equal
    what the port's int8 pool writes for the same K/V (quantize on write)."""
    import jax.numpy as jnp

    k, v = _seeded_kv()
    jp = _jax_pool(k, v, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tp = _port_pool(k, v, getattr(torch, dtype))
    pages = [3, 1, 2]
    jpay, tpay = jkvc.export_pages(jp, pages), tkvc.export_pages(tp, pages)
    assert tkvc.payload_page_crcs(tpay) == jkvc.payload_page_crcs(jpay)
    for key in ("k", "v"):
        for a, b in zip(tpay[key], jpay[key]):
            assert a.tobytes() == np.ascontiguousarray(b).tobytes()
            if dtype == "bfloat16":
                assert a.dtype == np.uint16 and tpay["dtype"] == "bfloat16"
    jconv, tconv = jkvc.convert_payload(jpay, "int8"), tkvc.convert_payload(tpay, "int8")
    for key in ("k", "v", "k_scale", "v_scale"):
        for a, b in zip(tconv[key], jconv[key]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
    assert tkvc.payload_page_crcs(tconv) == jkvc.payload_page_crcs(jconv)
    # quantize on write: the port's int8 pool writing the same K/V
    q = tkvc.BlockPool(5, 8, 2, 2, 16, dtype=getattr(torch, dtype), kv_dtype="int8",
                       device="cpu")
    bt = torch.tensor([pages], dtype=torch.int32)
    view = q.view(bt, torch.tensor([24], dtype=torch.int32))
    pos = torch.arange(24)[None]
    for layer in range(2):
        src_k = torch.from_numpy(k[layer]).to(getattr(torch, dtype))[pages].reshape(1, 24, 2, 16)
        src_v = torch.from_numpy(v[layer]).to(getattr(torch, dtype))[pages].reshape(1, 24, 2, 16)
        view.write(layer, src_k, src_v, pos)
    written = tkvc.export_pages(q, pages)
    assert tkvc.payload_page_crcs(written) == tkvc.payload_page_crcs(tconv)
    with pytest.raises(ValueError, match="losslessly"):
        tkvc.convert_payload(tconv, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payload_imports_across_packages(dtype):
    """A JAX payload imports into a port pool, and a port payload into a
    JAX pool, with equal bytes and CRCs (bf16 crosses as 16-bit patterns;
    the JAX side views them as ml_dtypes.bfloat16)."""
    import jax.numpy as jnp

    k, v = _seeded_kv(seed=1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp, tp = _jax_pool(k, v, jdt), _port_pool(k, v, getattr(torch, dtype))
    jpay, tpay = jkvc.export_pages(jp, [1, 2]), tkvc.export_pages(tp, [3, 4])
    crcs = jkvc.payload_page_crcs(jpay)
    # JAX -> port
    dst = tkvc.BlockPool(5, 8, 2, 2, 16, dtype=getattr(torch, dtype), device="cpu")
    tkvc.import_pages(dst, [4, 2], jpay)
    assert tkvc.payload_page_crcs(tkvc.export_pages(dst, [4, 2])) == crcs
    # port -> JAX: the JAX package reads numpy arrays of its own dtype
    as_jax = dict(tpay, k=list(tpay["k"]), v=list(tpay["v"]))
    if dtype == "bfloat16":
        as_jax["k"] = [a.view(ml_dtypes.bfloat16) for a in tpay["k"]]
        as_jax["v"] = [a.view(ml_dtypes.bfloat16) for a in tpay["v"]]
    jdst = jkvc.BlockPool(5, 8, 2, 2, 16, dtype=jdt)
    jkvc.import_pages(jdst, [1, 3], as_jax)
    assert jkvc.payload_page_crcs(jkvc.export_pages(jdst, [1, 3])) == \
        tkvc.payload_page_crcs(tpay)
    # int8 payloads cross too, with their scale planes
    jq = jkvc.convert_payload(jpay, "int8")
    qdst = tkvc.BlockPool(5, 8, 2, 2, 16, dtype=getattr(torch, dtype), kv_dtype="int8",
                          device="cpu")
    tkvc.import_pages(qdst, [1, 2], jq)
    assert tkvc.payload_page_crcs(tkvc.export_pages(qdst, [1, 2])) == \
        jkvc.payload_page_crcs(jq)
    # a corrupted payload changes its CRC at the same byte in both packages
    tc = tkvc.corrupt_payload(tkvc.export_pages(qdst, [1, 2]), seed="5:1")
    jc = jkvc.corrupt_payload(jkvc.convert_payload(jpay, "int8"), seed="5:1")
    assert tkvc.payload_page_crcs(tc) == jkvc.payload_page_crcs(jc) != \
        jkvc.payload_page_crcs(jq)
    with pytest.raises(ValueError, match="convert_payload first"):
        tkvc.import_pages(dst, [1, 2], jq)


# ---------------------------------------------------------------------------
# the fleet-backed predictor
# ---------------------------------------------------------------------------

def test_fleet_backed_predictor_with_qos_matches_jax(pkgs, tmp_path):
    """enable_llm_engine(llm_replicas=2, qos=QoSConfig(...)): the predictor
    builds two engines over one model and one shared QoSPolicy; its ids
    equal the JAX package's and the single-replica predictor's."""
    from paddle_tpu.inference import qos as jqos
    from paddle_tpu_torch.inference import qos as tqos

    prefix = str(tmp_path / "tiny")
    jinf.save_llm(pkgs["jax"].model, prefix)
    rng = np.random.RandomState(4)
    lens = np.asarray([9, 3, 14, 6], np.int64)
    ids = np.zeros((4, 14), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, 1024, n)

    def run(mod, qmod, replicas, qos):
        cfg = mod.Config(prefix)
        if mod is tinf:
            cfg.disable_gpu()
        cfg.enable_llm_engine(max_new_tokens=5, llm_replicas=replicas,
                              qos=qmod.QoSConfig(max_waiting=8) if qos else None,
                              max_seq_len=64, block_size=8, max_batch=4)
        pred = mod.create_predictor(cfg)
        out = pred.run([ids, lens])[0]
        return out, pred

    want, jpred = run(jinf, jqos, 2, True)
    got, tpred = run(tinf, tqos, 2, True)
    np.testing.assert_array_equal(got, want)
    fleet = tpred.fleet()
    assert len(fleet.replicas) == 2 and isinstance(tpred.qos(), tqos.QoSPolicy)
    assert all(r.sched.qos is tpred.qos() for r in fleet.replicas)
    assert fleet.replicas[0].engine._model is fleet.replicas[1].engine._model
    single, spred = run(tinf, tqos, 1, False)
    np.testing.assert_array_equal(single, want)
    assert spred.fleet() is None and spred.qos() is None
    assert tpred.fleet().finished == []  # the predictor drops what it read back
