"""Port parity for io/streaming (ShardPlan, ShardedDataset,
MeshDistributedBatchSampler, StreamingLoader, the paddle_tpu_input_*
stats): the plans' integer orders across epochs, seeds and dp degrees,
the streamed batches bit for bit against the JAX package's, a mid-epoch
resume (also onto another dp degree), the donation bound, the stats'
totals and starved-vs-slow verdicts on one injected clock, the guardian's
input_wait_s of a streaming-fed step, and the mesh argument that waits
for distributed. Exact throughout."""
import types

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
from paddle_tpu.io import streaming as jst
from paddle_tpu.io.streaming import stats as jstats

import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import guardian as tg
from paddle_tpu_torch.io import streaming as tst
from paddle_tpu_torch.io.streaming import stats as tstats


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")
    tstats.reset()
    yield
    tstats.reset()


class Samples(tio.Dataset):
    """Sample i: a float32 row from a seeded draw and its int64 label."""

    def __init__(self, n=50, width=3):
        self.n, self.width = n, width

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.RandomState(1000 + int(i))
        return r.standard_normal(self.width).astype(np.float32), np.int64(i)


class JSamples(Samples, paddle.io.Dataset):
    """The same samples as a JAX-package Dataset."""


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t.numpy())


PLANS = [(50, 8, 0, 0, True, False), (50, 8, 3, 2, True, True), (50, 12, 5, 1, False, False),
         (7, 12, 9, 4, True, False), (96, 24, 1, 3, True, True)]


@pytest.mark.parametrize("plan", PLANS, ids=[f"n{p[0]}g{p[1]}s{p[2]}e{p[3]}" for p in PLANS])
def test_shard_plan_orders_match_jax(plan):
    """order, n_batches, every global batch and every rank's indices for
    each dp degree that divides the global batch; the shards are disjoint
    slices of each global batch, whatever the degree."""
    n, g, seed, epoch, shuffle, drop_last = plan
    t = tst.ShardPlan(n, g, seed, epoch, shuffle=shuffle, drop_last=drop_last)
    j = jst.ShardPlan(n, g, seed, epoch, shuffle=shuffle, drop_last=drop_last)
    assert t.order.dtype == np.int64 and np.array_equal(t.order, j.order)
    assert t.n_batches == j.n_batches
    for world in [w for w in (1, 2, 3, 4, 6) if g % w == 0]:
        for rank in range(world):
            assert np.array_equal(t.rank_indices(rank, world), j.rank_indices(rank, world))
        for b in range(t.n_batches):
            joined = np.concatenate([t.rank_batch(b, r, world) for r in range(world)])
            assert np.array_equal(joined, t.global_batch(b))
    with pytest.raises(ValueError):
        t.rank_batch(0, 0, 5)


def test_sharded_dataset_and_mesh_sampler_match_jax():
    """Explicit (rank, world): the same samples and batches over 2 epochs;
    without them the port is rank 0 of 1 (no process group, no mesh)."""
    for rank in range(4):
        td = tst.ShardedDataset(Samples(), 8, rank=rank, world=4, seed=3)
        jd = jst.ShardedDataset(JSamples(), 8, rank=rank, world=4, seed=3)
        ts = tst.MeshDistributedBatchSampler(Samples(), 2, rank=rank, num_replicas=4,
                                             shuffle=True, seed=3)
        js = jst.MeshDistributedBatchSampler(JSamples(), 2, rank=rank, num_replicas=4,
                                             shuffle=True, seed=3)
        for epoch in range(2):
            for d in (td, jd, ts, js):
                d.set_epoch(epoch)
            assert np.array_equal(td.indices, jd.indices)
            assert [int(td[i][1]) for i in range(len(td))] == td.indices.tolist()
            assert list(ts) == list(js) and len(ts) == len(js)
    single = tst.ShardedDataset(Samples(10), 5)
    assert (single.rank, single.world) == (0, 1) and tst.data_shard_info() == (1, ())


def test_mesh_argument_raises_naming_distributed():
    for build in (lambda: tst.data_shard_info(object()),
                  lambda: tst.StreamingLoader(Samples(), 8, mesh=object())):
        with pytest.raises(NotImplementedError, match="Queue A item 5"):
            build()


def _stream(loader, epochs):
    out = []
    for _ in range(epochs):
        for x, y in loader:
            out.append((_np(x).copy(), _np(y).copy()))
    return out


@pytest.mark.parametrize("depth,donate", [(2, True), (0, False)])
def test_streamed_batches_are_bit_equal_to_jax(depth, donate):
    """Two epochs of a shuffled stream with a short last global batch
    wrap-padded (drop_last False): every batch's bytes, dtypes and shapes
    equal the JAX package's; the port's tensors lie on the framework
    device."""
    kw = dict(seed=4, shuffle=True, drop_last=False, dp_world=1, prefetch_depth=depth,
              donate=donate)
    t = tst.StreamingLoader(Samples(), 8, **kw)
    got = _stream(t, 2)
    want = _stream(jst.StreamingLoader(JSamples(), 8, **kw), 2)
    assert len(got) == len(want) == 14 and t.epoch == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()


def test_mid_epoch_resume_is_exact_and_reshards():
    """A state taken after 3 of 6 batches (through state_to_tensors and
    back) resumes onto the remaining batches byte for byte; the cursor is
    global, so dp 4 -> 3 re-splits the rest with no sample lost or read
    twice, as in the JAX package."""
    kw = dict(seed=2, shuffle=True, drop_last=True, prefetch_depth=2)
    full = _stream(tst.StreamingLoader(Samples(48), 8, **kw), 1)
    first = tst.StreamingLoader(Samples(48), 8, **kw)
    it = iter(first)
    head = [(_np(x).copy(), _np(y).copy()) for x, y in (next(it) for _ in range(3))]
    state = tst.tensors_to_state(tst.state_to_tensors(first.state_dict()))
    it.close()
    resumed = tst.StreamingLoader(Samples(48), 8, **kw)
    resumed.load_state_dict(state)
    tail = _stream(resumed, 1)
    assert [y.tolist() for _, y in head + tail] == [y.tolist() for _, y in full]
    assert all(a.tobytes() == b.tobytes() for (a, _), (b, _) in zip(head + tail, full))
    jstate = dict(state)
    for lib, ds in ((tst, Samples(48)), (jst, JSamples(48))):
        dp4 = lib.StreamingLoader(ds, 12, seed=2, dp_world=4, prefetch_depth=0)
        read = [int(i) for r in range(4) for b, idx, _batch in dp4.rank_view(r) if b < 2
                for i in idx]
        dp4._cursor = 2
        dp3 = lib.StreamingLoader(ds, 12, seed=2, dp_world=3, prefetch_depth=0)
        dp3.load_state_dict(dp4.state_dict())
        rest = [int(i) for r in range(3) for _b, idx, _batch in dp3.rank_view(r) for i in idx]
        assert sorted(read + rest) == list(range(48))
        jstate[lib.__name__] = sorted(rest)
    assert jstate[tst.__name__] == jstate[jst.__name__]
    with pytest.raises(ValueError, match="dataset_len"):
        tst.StreamingLoader(Samples(47), 8, **kw).load_state_dict(state)


def test_donation_bound_holds(monkeypatch):
    """donate=True: the previous batch's storage is released when the next
    one is taken, and at no step are more than prefetch_depth + 2 placed
    batches alive with their memory."""
    depth = 2
    placed = []
    real_place = tio._PinnedRing.place

    def spy(self, batch, stream=None):
        out = real_place(self, batch, stream)
        placed.append(out[0])
        return out

    monkeypatch.setattr(tio._PinnedRing, "place", spy)
    loader = tst.StreamingLoader(Samples(96, width=64), 4, prefetch_depth=depth, donate=True)
    prev, peak = None, 0
    for x, _ in loader:
        if prev is not None:
            assert prev.untyped_storage().nbytes() == 0
        live = sum(1 for t in placed if t.untyped_storage().nbytes() > 0)
        peak = max(peak, live)
        assert live <= depth + 2, live
        prev = x
    assert len(placed) == 24 and peak >= 2


def _clocked(stats_mod, monkeypatch, script):
    """Run `script` (a list of ("wait", s) / ("take", dt)) on an injected
    clock; returns the takes' results and the summary."""
    clock = types.SimpleNamespace(t=100.0)
    monkeypatch.setattr(stats_mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock.t, perf_counter=lambda: clock.t))
    stats_mod.reset()
    takes = []
    for kind, v in script:
        if kind == "wait":
            stats_mod.observe_wait(v, source="t")
            stats_mod.observe_batch(8, source="t")
        else:
            clock.t += v
            takes.append(stats_mod.take_step_wait())
    out = stats_mod.summary()
    stats_mod.reset()
    return takes, out


SCRIPTS = {
    "no_data": [("take", 1.0), ("take", 1.0)],
    "starved": [("wait", 0.0), ("take", 1.0)] + [("wait", 0.4), ("take", 1.0)] * 5,
    "input_limited": [("wait", 0.0), ("take", 1.0)] + [("wait", 0.15), ("take", 1.0)] * 5,
    "compute": [("wait", 0.0), ("take", 1.0)] + [("wait", 0.01), ("take", 1.0)] * 70,
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_stats_and_verdict_match_jax(case, monkeypatch):
    """take_step_wait's per-step waits (None before any wait), the totals,
    the 64-step window and the verdict equal the JAX package's."""
    got = _clocked(tstats, monkeypatch, SCRIPTS[case])
    want = _clocked(jstats, monkeypatch, SCRIPTS[case])
    assert got == want
    assert got[1]["verdict"] == case
    assert tstats.STARVED_FRACTION == jstats.STARVED_FRACTION
    assert tstats.LIMITED_FRACTION == jstats.LIMITED_FRACTION


def test_guardian_records_the_streamed_wait_and_perf_report_judges_it(monkeypatch):
    """A guarded step fed by a StreamingLoader records a float
    `input_wait_s` (the wait take_step_wait hands over), and
    perf_report()['input_pipeline'] carries a verdict of the three."""
    from paddle_tpu_torch.profiler import perf_attribution as tpa

    lin = ptt.nn.Linear(3, 2)
    opt = ptt.optimizer.SGD(0.1, parameters=lin.parameters())
    guard = tg.TrainingGuardian(opt, policy="skip_step", lkg_interval=0)
    for x, y in tst.StreamingLoader(Samples(24), 6, prefetch_depth=2):
        loss = lin(x).square().mean()
        loss.backward()
        assert guard.step(loss) == "ok"
        opt.clear_grad()
    steps = [r for r in guard.recorder.records() if r["kind"] == "step"]
    assert len(steps) == 4
    assert all(isinstance(r["input_wait_s"], float) and r["input_wait_s"] >= 0 for r in steps)
    pipe = tpa.perf_report()["input_pipeline"]
    assert pipe["verdict"] in ("starved", "input_limited", "compute") and pipe["steps"] == 3
