"""Port parity for the compile cache (compile_cache/): fingerprints, the
ledger and the cold-start report against the JAX package on the same
inputs; the store's atomic CRC-verified layout on byte payloads (a torn
entry, a corrupt payload, another topology, the chaos read site, LRU gc,
the CLI); the kernel build's restore and persist around the store; the
static Executor's ledger events, FLOP record and FLAGS_check_nan_inf; the
serving engine's cold-start marks and the telemetry route."""
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax
import jax.numpy as jnp

from paddle_tpu.compile_cache import fingerprint as jfp
from paddle_tpu.compile_cache import ledger as jledger
from paddle_tpu.compile_cache import report as jreport

import paddle_tpu_torch as ptt
from paddle_tpu_torch import compile_cache as cc
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch import telemetry as ttm
from paddle_tpu_torch.compile_cache import __main__ as cc_main
from paddle_tpu_torch.compile_cache import ledger as tledger
from paddle_tpu_torch.compile_cache import report as treport
from paddle_tpu_torch.compile_cache import store as tstore
from paddle_tpu_torch.distributed.resilience import fault_injection as tfi
from paddle_tpu_torch.ops.kernels import build as kbuild
from paddle_tpu_torch.profiler import perf_attribution as tpa


@pytest.fixture(autouse=True)
def _cpu(tmp_path, monkeypatch):
    ptt.set_device("cpu")
    monkeypatch.setenv("PADDLE_TPU_CRASH_DIR", str(tmp_path / "crash"))
    monkeypatch.delenv(tstore.ENV_DIR, raising=False)
    cc.configure(None)
    tledger.reset()
    yield
    cc.configure(None)
    tfi.install_plan(None)
    ptt.set_flags({"FLAGS_check_nan_inf": False})


TREES = [
    [np.zeros((2, 3), np.float32), (np.zeros(4, np.int32),)],
    {"b": 1, "a": [None, 2.0, np.zeros((1,), np.float16)]},
    np.zeros(3, np.float64),
    (),
    {"k": [], "j": {}},
    (np.zeros((0, 5), np.int64), True),
]


@pytest.mark.parametrize("i", range(len(TREES)))
def test_fingerprints_match_jax(i):
    """aval_signature of the same shapes and dtypes (torch tensors on the
    port's side, jax arrays on the JAX package's) is the JAX package's
    string; fingerprint_text and entry_key (under one pinned meta) too."""
    tree = TREES[i]
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, tree)

    def to_torch(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x)
        if isinstance(x, (list, tuple)):
            return type(x)(to_torch(v) for v in x)
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        return x

    want = jfp.aval_signature(jt)
    assert cc.aval_signature(to_torch(tree)) == want == cc.aval_signature(tree)
    assert cc.fingerprint_text(want) == jfp.fingerprint_text(want)
    meta = {"platform": "cuda", "device_count": 1, "world_size": 1, "i": i}
    assert cc.entry_key("ab" * 16, meta) == jfp.entry_key("ab" * 16, meta)


def _ledger_doc(events_mod):
    """A ledger history built through `events_mod` (each package's
    ledger): an engine window with a prewarm, compile events inside and
    outside it, and a counter-only hit."""
    events_mod.reset()
    t = 1000.0
    events_mod.mark("engine_load_start", t)
    events_mod.span("engine_init", t, t + 0.25)
    events_mod.span("prewarm", t + 0.3, t + 2.0)
    events_mod.mark("first_token", t + 2.6)
    evs = [("kernel_build", "flash_fwd", "miss", 0.9, t + 1.2),
           ("kernel_build", "flash_fwd", "persist", 0.05, t + 1.25),
           ("kernel_build", "paged_attn", "restore", 0.02, t + 1.5),
           ("static_executor", "replay[3ops,1feeds]", "miss", 0.2, t + 2.3),
           ("kernel_build", "rms_norm", "error", 0.0, t + 2.4),
           ("static_executor", "late", "miss", 0.5, t + 9.0)]
    doc = {"version": 1, "events": [], "marks": events_mod.marks(), "spans": events_mod.spans()}
    for k, (origin, name, outcome, sec, t_end) in enumerate(evs):
        doc["events"].append({"serial": k + 1, "origin": origin, "name": name, "outcome": outcome,
                              "seconds": sec, "fingerprint": None, "signature": None,
                              "t_end": t_end, "recorded_at": 0.0})
    return doc


def test_cold_start_report_matches_jax():
    """cold_start_report and format_report over one ledger dump (marks and
    spans recorded through each package's ledger) equal the JAX
    package's; the components sum to the window's wall."""
    tdoc, jdoc = _ledger_doc(tledger), _ledger_doc(jledger)
    assert tdoc == jdoc
    got, want = treport.cold_start_report(tdoc), jreport.cold_start_report(jdoc)
    assert got == want and got["available"] and got["consistency"] == 1.0
    assert treport.format_report(got) == jreport.format_report(want)
    for bad in ({"marks": []}, {"marks": [{"key": "engine_load_start", "t": 1.0}]}):
        assert treport.cold_start_report(bad) == jreport.cold_start_report(bad)
        assert treport.format_report(treport.cold_start_report(bad)) == \
            jreport.format_report(jreport.cold_start_report(bad))


def test_report_cli_on_a_dump(tmp_path, capsys):
    path = tmp_path / "ledger.json"
    path.write_text(json.dumps(_ledger_doc(tledger)))
    assert cc_main.main(["report", "--input", str(path), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["wall_s"] == 2.6 and rep["outcomes"] == {"miss": 2, "persist": 1, "restore": 1,
                                                        "error": 1}
    assert cc_main.main(["report", "--input", str(tmp_path / "none.json")]) == 2


def test_ledger_records_counts_and_dumps(tmp_path):
    """Outcomes land as events (hits counter-only), the summary reads the
    counter families, and dump_json/load_dump round-trip."""
    h0 = _counter("paddle_tpu_compile_cache_hits_total")
    m0 = _counter("paddle_tpu_compile_cache_misses_total")
    assert tledger.record("kernel_build", "x", "hit") is None
    ev = tledger.record("kernel_build", "x", "miss", seconds=1.5, fingerprint="f")
    assert ev["outcome"] == "miss" and tledger.record("a", "b", "bogus")["outcome"] == "error"
    tledger.record("kernel_build", "x", "restore", seconds=0.5)
    s = tledger.summary()
    assert s["events"] == 3 and s["by_origin"]["kernel_build"]["outcomes"] == {"miss": 1,
                                                                                "restore": 1}
    assert _counter("paddle_tpu_compile_cache_hits_total") - h0 == 2
    assert _counter("paddle_tpu_compile_cache_misses_total") - m0 == 2
    doc = tledger.load_dump(tledger.dump_json(str(tmp_path / "d.json")))
    assert [e["outcome"] for e in doc["events"]] == ["miss", "error", "restore"]


def _counter(name, **labels):
    fam = ttm.default_registry().get(name)
    if fam is None:
        return 0
    return sum(c.value for c in fam.children()
               if all(dict(c.labels).get(k) == v for k, v in labels.items()))


def _meta(store_root, **over):
    m = cc.make_meta("kernel_build", "lib", "f" * 32, signature="lib.so")
    m["topology"].update(over)
    return m


def test_store_roundtrip_corruption_topology_and_chaos(tmp_path):
    """Bytes in, the same bytes out; every rejection is a counted miss under
    its reason, never an exception: a torn entry (no COMPLETE), a flipped
    payload byte (CRC), unparsable meta, another topology, and the chaos
    site `compile_cache.read`. A put over a rejected entry replaces it."""
    st = cc.CompileCacheStore(str(tmp_path / "store"))
    meta = _meta(st.root)
    key = cc.entry_key("f" * 32, meta["topology"])
    payload = bytes(range(256)) * 10
    assert st.put(key, payload, meta) and st.put(key, b"other", meta)  # first write wins
    got, m = st.get(key, expect_meta=meta["topology"])
    assert got == payload and m["payload_bytes"] == len(payload)
    assert st.verify() == {"entries": 1, "corrupt": 0, "failures": {}}

    def reason_count(r):
        return _counter("paddle_tpu_compile_cache_errors_total", reason=r)

    other = dict(meta["topology"], device_name="another card")
    n = reason_count("topology_mismatch")
    assert st.get(key, expect_meta=other) is None and reason_count("topology_mismatch") == n + 1
    tfi.install_plan(tfi.FaultPlan().add("compile_cache.read", "fail"))
    n = reason_count("read_failed")
    assert st.get(key) is None and reason_count("read_failed") == n + 1
    tfi.install_plan(None)
    pay = os.path.join(st.root, key, "payload.bin")
    raw = bytearray(open(pay, "rb").read())
    raw[100] ^= 0x10
    open(pay, "wb").write(bytes(raw))
    n = reason_count("crc_mismatch")
    assert st.get(key) is None and reason_count("crc_mismatch") == n + 1
    assert st.verify()["failures"] == {key: "crc_mismatch"}
    assert st.put(key, payload, meta) and st.get(key)[0] == payload  # healed
    open(os.path.join(st.root, key, "meta.json"), "w").write("{not json")
    n = reason_count("bad_meta")
    assert st.get(key) is None and reason_count("bad_meta") == n + 1
    os.remove(os.path.join(st.root, key, "COMPLETE"))
    n = reason_count("torn_entry")
    assert st.get(key) is None and reason_count("torn_entry") == n + 1
    assert st.put(key, payload, meta) and st.get(key)[0] == payload


def test_store_gc_cli_and_shared_registry(tmp_path, capsys):
    """gc drops corrupt entries first, then the least recently used (a
    restore refreshes an entry) until the store fits; stats/verify/gc
    through the CLI; the in-process registry."""
    st = cc.CompileCacheStore(str(tmp_path / "s"))
    keys = []
    for i in range(3):
        meta = _meta(st.root)
        k = f"{i:032x}-t"
        st.put(k, bytes([i]) * 1000, meta)
        os.utime(os.path.join(st.root, k, "COMPLETE"), (100 + i, 100 + i))
        keys.append(k)
    st.get(keys[0])  # a use: now the newest
    open(os.path.join(st.root, keys[2], "payload.bin"), "ab").write(b"x")
    size = st.entry_bytes(keys[0])
    rep = st.gc(max_bytes=size + 10)
    assert [r["key"] for r in rep["removed"]] == [keys[2], keys[1]]
    assert [r["reason"] for r in rep["removed"]] == ["truncated_payload", "lru"]
    assert st.entry_keys() == [keys[0]]
    assert cc_main.main(["stats", "--dir", st.root]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["entries"] == 1 and stats["by_origin"]["kernel_build"]["entries"] == 1
    assert cc_main.main(["verify", "--dir", st.root]) == 0
    capsys.readouterr()
    assert cc_main.main(["gc", "--dir", st.root, "--max-bytes", "0"]) == 0
    assert json.loads(capsys.readouterr().out)["removed"][0]["key"] == keys[0]
    assert cc_main.main(["stats"]) == 2  # no dir
    cc.shared_put("k", 1)
    assert cc.shared_get("k") == 1
    cc.clear_shared()
    assert cc.shared_get("k") is None


def test_kernel_build_restores_and_persists_through_the_store(tmp_path, monkeypatch):
    """The kernel build's store path, without nvcc: a library persisted by
    `_persist` (the ledger's `miss` + `persist`) is restored byte for byte
    into an empty build directory (`restore`, no nvcc), and a flipped byte
    makes it a counted CRC rejection that leaves the library to build."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build1")
    kbuild.BUILD_DIR.mkdir()
    cc.configure(str(tmp_path / "cache"))
    lib = kbuild._library_path("rms_norm")
    lib.write_bytes(b"\x7fELF fake library" * 50)
    kbuild._persist("rms_norm", lib, 1.25, 3.0)
    evs = [(e["origin"], e["name"], e["outcome"]) for e in tledger.events()]
    assert evs == [("kernel_build", "rms_norm", "miss"), ("kernel_build", "rms_norm", "persist")]
    assert tledger.events()[0]["seconds"] == 1.25 and tledger.events()[0]["nvcc_s"] == 3.0

    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build2")
    kbuild.BUILD_DIR.mkdir()
    before = dict(kbuild.BUILD_STATS)
    left = kbuild._restore({"rms_norm": kbuild._library_path("rms_norm"),
                            "flash_fwd": kbuild._library_path("flash_fwd")})
    assert list(left) == ["flash_fwd"]
    assert kbuild._library_path("rms_norm").read_bytes() == lib.read_bytes()
    assert tledger.events()[-1]["outcome"] == "restore"
    assert kbuild.BUILD_STATS["restored"] == before["restored"] + 1
    assert kbuild.BUILD_STATS["nvcc_runs"] == before["nvcc_runs"]

    store = cc.active_store()
    (entry,) = store.entry_keys()
    pay = os.path.join(store.root, entry, "payload.bin")
    raw = bytearray(open(pay, "rb").read())
    raw[7] ^= 1
    open(pay, "wb").write(bytes(raw))
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build3")
    kbuild.BUILD_DIR.mkdir()
    n = _counter("paddle_tpu_compile_cache_errors_total", reason="crc_mismatch")
    assert list(kbuild._restore({"rms_norm": kbuild._library_path("rms_norm")})) == ["rms_norm"]
    assert _counter("paddle_tpu_compile_cache_errors_total", reason="crc_mismatch") == n + 1


def _matmul_program():
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [4, 8], "float32")
        lin = ptt.nn.Linear(8, 3)
        y = lin(x)
        loss = (y * y).mean()
    return main, x, y, loss, lin


def test_executor_ledger_flops_and_the_two_switches_now_work(tmp_path, monkeypatch):
    """A signature's first run is one ledger `miss` with a record whose
    counted FLOPs are the Linear's (2 * 4 * 8 * 3); later runs are hits
    (no event). PADDLE_TPU_COMPILE_CACHE_DIR set and FLAGS_check_nan_inf on
    change no result, and a NaN feed raises GuardianAnomaly naming
    static_executor with a flight-recorder dump."""
    monkeypatch.setenv(tstore.ENV_DIR, str(tmp_path / "cache"))
    cc.configure(str(tmp_path / "cache"))
    main, x, y, loss, lin = _matmul_program()
    exe = tstatic.Executor()
    feed = {"x": np.random.RandomState(0).randn(4, 8).astype(np.float32)}
    plain = [exe.run(main, feed=feed, fetch_list=[loss])[0] for _ in range(2)]
    evs = [e for e in tledger.events() if e["origin"] == "static_executor"]
    assert [e["outcome"] for e in evs] == ["miss"]
    rec = tpa.program_records(origin="static_executor")[-1]
    assert rec["flops"] == 2 * 4 * 8 * 3 and rec["compile_seconds"] == evs[0]["seconds"]
    ptt.set_flags({"FLAGS_check_nan_inf": True})
    flagged = [exe.run(main, feed=feed, fetch_list=[loss])[0] for _ in range(2)]
    assert [a.tobytes() for a in flagged] == [a.tobytes() for a in plain]
    # the Executor persists nothing: its entries are closures, not machine code
    assert not (tmp_path / "cache").exists() or os.listdir(tmp_path / "cache") == []

    # static training writes back a NaN: the compiled-state check raises
    main2 = tstatic.Program()
    with tstatic.program_guard(main2, tstatic.Program()):
        x2 = tstatic.data("x", [4, 8], "float32")
        lin2 = ptt.nn.Linear(8, 3)
        loss2 = (lin2(x2) ** 2).mean()
        ptt.optimizer.SGD(0.1, parameters=lin2.parameters()).minimize(loss2)
    rec = ptt.FlightRecorder(name="static", crash_dir=str(tmp_path / "dumps"))
    exe.run(main2, feed=feed, fetch_list=[loss2])
    bad = dict(feed, x=np.full((4, 8), np.nan, np.float32))
    with pytest.raises(ptt.GuardianAnomaly, match="static_executor") as e:
        exe.run(main2, feed=bad, fetch_list=[loss2])
    dump = json.load(open(next(p for p in e.value.dump_paths if "dumps" in p)))
    assert dump["reason"] == "compiled_state:static_executor" and rec.records()


def test_engine_cold_start_marks_and_the_route():
    """The serving engine's constructor, prewarm and first token leave the
    marks the report decomposes (prewarm's logits are not the first
    token); with no build in the window the components are the whole wall.
    /compile_cache.json serves the ledger."""
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.models import llama as tllama

    ptt.seed(0)
    model = tllama.llama_tiny().eval()
    eng = InferenceEngine(model, max_seq_len=64, block_size=16, max_batch=2)
    eng.prewarm(include_prefill=False)
    assert "first_token" not in [m["key"] for m in tledger.marks()]
    eng.generate([[1, 2, 3]], max_new_tokens=2)
    rep = cc.cold_start_report()
    assert rep["available"] and rep["prewarmed"]
    assert abs(rep["consistency"] - 1.0) < 1e-3
    srv = ttm.start_metrics_server(port=0)
    try:
        doc = json.loads(urllib.request.urlopen(srv.url + "/compile_cache.json", timeout=10).read())
    finally:
        srv.stop()
    assert [m["key"] for m in doc["marks"]] == ["engine_load_start", "first_token"]
    assert "summary" in doc and [s["key"] for s in doc["spans"]] == ["engine_init", "prewarm"]


def test_topology_meta_names_what_a_library_depends_on():
    meta = cc.topology_meta()
    assert set(meta) == set(cc.fingerprint.TOPOLOGY_KEYS)
    assert meta["torch_version"] == torch.__version__ and meta["world_size"] == 1
