"""Port parity for io/ (the DataLoader family): the samplers' orders
under one np.random.seed, the default collate's leaves and dtypes, the
prefetch thread against the synchronous loader, errors raised by the
producer, iterable datasets, and the spawned persistent workers (their
batches, and the loud fallback of an unpicklable dataset) against the JAX
package on the same numpy data. Exact throughout: the data is integers and
small floats, and no arithmetic happens on the way."""
import warnings

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu.io as jio

import paddle_tpu_torch as ptt
import paddle_tpu_torch.io as tio
from paddle_tpu_torch import telemetry as ttm

from torch_io_data import Rows


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return x


def _leaves(batch):
    """(type tag, dtype, values) of each leaf of a collated batch."""
    if isinstance(batch, dict):
        return {k: _leaves(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)) and batch and not isinstance(batch[0], (str, bytes)):
        return [_leaves(v) for v in batch]
    if isinstance(batch, list):
        return ("list", None, list(batch))
    a = _np(batch)
    return ("array", str(a.dtype), a.tolist())


def _sampler_cases(io):
    ds = list(range(23))
    return {
        "random": lambda: list(io.RandomSampler(ds)),
        "random_replacement": lambda: list(io.RandomSampler(ds, replacement=True, num_samples=40)),
        "random_num_samples": lambda: list(io.RandomSampler(ds, num_samples=9)),
        "subset_random": lambda: list(io.SubsetRandomSampler([3, 5, 8, 13, 21])),
        "weighted": lambda: list(io.WeightedRandomSampler(np.arange(1, 24), 30)),
        "weighted_no_replacement": lambda: list(io.WeightedRandomSampler(np.arange(1, 24), 10,
                                                                         replacement=False)),
        "batch_shuffle": lambda: list(io.BatchSampler(ds, shuffle=True, batch_size=4)),
        "batch_drop_last": lambda: list(io.BatchSampler(ds, batch_size=4, drop_last=True)),
        "sequence": lambda: list(io.SequenceSampler(ds)),
        "random_split": lambda: [list(s.indices) for s in io.random_split(ds, [10, 8, 5])],
        "random_split_fractions": lambda: [list(s.indices)
                                           for s in io.random_split(ds, [0.5, 0.25, 0.25])],
    }


@pytest.mark.parametrize("case", sorted(_sampler_cases(tio)))
def test_sampler_orders_match_jax(case):
    """Each sampler draws the JAX package's order from the global np.random
    (two draws in a row: the generator state advances equally)."""
    got, want = [], []
    for io, out in ((tio, got), (jio, want)):
        np.random.seed(1234)
        fn = _sampler_cases(io)[case]
        out += [fn(), fn()]
    assert got == want
    assert got[0] != got[1] or case in ("sequence", "batch_drop_last")


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last):
    """Every rank of 3 over 3 epochs (set_epoch seeds the shuffle); with no
    process group the port defaults to rank 0 of 1."""
    for rank in range(3):
        kw = dict(batch_size=4, num_replicas=3, rank=rank, shuffle=shuffle, drop_last=drop_last)
        t, j = tio.DistributedBatchSampler(range(29), **kw), jio.DistributedBatchSampler(
            range(29), **kw)
        for epoch in range(3):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)
    single = tio.DistributedBatchSampler(range(10), batch_size=3)
    assert (single.nranks, single.local_rank) == (1, 0)
    assert list(single) == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]


def test_random_sampler_takes_a_generator():
    """A passed generator is used, not the global np.random."""
    ds = list(range(50))
    a = list(tio.RandomSampler(ds, generator=np.random.RandomState(5)))
    np.random.seed(0)
    b = list(tio.RandomSampler(ds, generator=np.random.RandomState(5)))
    assert a == b == np.random.RandomState(5).permutation(50).tolist()
    g = torch.Generator().manual_seed(3)
    assert list(tio.RandomSampler(ds, generator=g)) == torch.randperm(
        50, generator=torch.Generator().manual_seed(3)).tolist()


SAMPLES = {
    "tuple_array_int": [(np.arange(3, dtype=np.float64) * i, i) for i in range(4)],
    "float_and_uint8": [(np.full((2, 2), i, np.uint8), float(i) / 3) for i in range(3)],
    "dict": [{"x": np.ones(2, np.int32) * i, "name": f"s{i}", "y": np.int64(i)}
             for i in range(3)],
    "nested": [[np.arange(2) + i, (i, np.float32(i))] for i in range(2)],
}


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_default_collate_leaves_and_dtypes_match_jax(case):
    """default_collate_fn: the same structure, leaf types and dtypes (f64
    stacks to f32, ints to int64, strings stay lists) and values; the
    port's leaves are tensors on the framework device."""
    got = tio.default_collate_fn(SAMPLES[case])
    want = jio.default_collate_fn(SAMPLES[case])
    assert _leaves(got) == _leaves(want)
    arrays = [got] if isinstance(got, torch.Tensor) else (
        got.values() if isinstance(got, dict) else got)
    assert all(a.device.type == "cpu" for a in arrays if isinstance(a, torch.Tensor))


def _epochs(io, loader_kw, epochs=2, seed=7):
    np.random.seed(seed)
    dl = io.DataLoader(Rows(), **loader_kw)
    return [[_leaves(b) for b in dl] for _ in range(epochs)]


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_jax(workers):
    """Shuffled batches of 6 over two epochs: the prefetch thread's
    (num_workers=2) equal the synchronous loader's and the JAX package's."""
    kw = dict(batch_size=6, shuffle=True, num_workers=workers)
    got = _epochs(tio, kw)
    assert got == _epochs(jio, kw)
    assert got == _epochs(tio, dict(kw, num_workers=0))
    assert got[0] != got[1]


def test_custom_collate_output_is_kept():
    """A custom collate_fn's numpy output is yielded as it returns it, on
    both paths, as in the JAX package."""
    def collate(rows):
        return np.stack([r[0] for r in rows])

    for workers in (0, 1):
        out = list(tio.DataLoader(Rows(8), batch_size=4, collate_fn=collate, num_workers=workers))
        ref = list(jio.DataLoader(Rows(8), batch_size=4, collate_fn=collate, num_workers=workers))
        assert all(isinstance(b, np.ndarray) for b in out)
        assert [b.tolist() for b in out] == [np.asarray(b).tolist() for b in ref]


class _Broken:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 7:
            raise KeyError("sample 7 is unreadable")
        return np.zeros(2, np.float32)


@pytest.mark.parametrize("workers", [0, 1])
def test_producer_errors_propagate(workers):
    """The dataset's exception reaches the consumer after the batches before
    it, from the synchronous loader and from the prefetch thread."""
    dl = tio.DataLoader(_Broken(), batch_size=4, num_workers=workers)
    seen = []
    with pytest.raises(KeyError, match="sample 7"):
        for b in dl:
            seen.append(b.shape[0])
    assert seen == [4]


class _Stream(tio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.float32(i), np.arange(i, i + 2)


class _JStream(jio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.float32(i), np.arange(i, i + 2)


@pytest.mark.parametrize("drop_last,workers", [(False, 0), (True, 0), (False, 2)])
def test_iterable_dataset_matches_jax(drop_last, workers):
    got = [_leaves(b) for b in tio.DataLoader(_Stream(11), batch_size=4, drop_last=drop_last,
                                              num_workers=workers)]
    want = [_leaves(b) for b in jio.DataLoader(_JStream(11), batch_size=4, drop_last=drop_last,
                                               num_workers=workers)]
    assert got == want and len(got) == (2 if drop_last else 3)
    chain = [float(x) for x, _ in tio.ChainDataset([_Stream(2), _Stream(3)])]
    assert chain == [0, 1, 0, 1, 2]
    with pytest.raises(TypeError):
        len(tio.DataLoader(_Stream(3)))


def test_map_style_datasets_match_jax():
    """TensorDataset, ComposeDataset, ConcatDataset and Subset index like
    the JAX package's."""
    a, b = np.arange(10).reshape(5, 2), np.arange(5) * 3
    for io in (tio, jio):
        td = io.TensorDataset([a, b])
        cd = io.ComposeDataset([td, io.TensorDataset([b])])
        cat = io.ConcatDataset([td, io.Subset(td, [4, 0])])
        got = [len(td), len(cd), len(cat), [x.tolist() for x in cd[3]],
               [x.tolist() for x in cat[-1]], [x.tolist() for x in cat[5]]]
        if io is tio:
            port = got
    assert port == got


def test_spawned_workers_match_sync_and_fallback_warns_once():
    """persistent_workers=True with 2 spawned workers: two epochs of
    shuffled batches equal the synchronous loader's, and a second epoch
    reuses the same processes. A dataset that cannot be pickled (a local
    class) warns once, counts every fallback under
    paddle_tpu_dataloader_fallbacks_total, and loads through the thread."""
    kw = dict(batch_size=5, shuffle=True, num_workers=2)
    dl = tio.DataLoader(Rows(), persistent_workers=True, **kw)
    np.random.seed(11)
    got = [[_leaves(b) for b in dl] for _ in range(2)]
    pids = [p.pid for p in dl._mp_pool._procs]
    np.random.seed(11)
    assert got == [[_leaves(b) for b in tio.DataLoader(Rows(), **dict(kw, num_workers=0))]
                   for _ in range(2)]
    assert all(p.is_alive() for p in dl._mp_pool._procs) and len(set(pids)) == 2
    dl._shutdown_workers()
    assert not any(p.is_alive() for p in dl._mp_pool._procs)

    class Local(Rows):
        pass

    was = ttm.enabled()
    ttm.enable()
    fam = ttm.default_registry().get("paddle_tpu_dataloader_fallbacks_total")
    before = fam.labels(reason="AttributeError").value if fam is not None else 0
    try:
        local = tio.DataLoader(Local(12), batch_size=4, num_workers=2, persistent_workers=True)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            epochs = [[b[1].tolist() for b in local] for _ in range(2)]
        fam = ttm.default_registry().get("paddle_tpu_dataloader_fallbacks_total")
        assert fam.labels(reason="AttributeError").value - before == 2
    finally:
        if not was:
            ttm.disable()
    spawn_warnings = [x for x in w if "worker spawn failed" in str(x.message)]
    assert len(spawn_warnings) == 1
    assert epochs == [[[0, 1, 2, 3], [4, 5, 6, 0], [1, 2, 3, 4]]] * 2
