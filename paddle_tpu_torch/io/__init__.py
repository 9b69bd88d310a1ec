"""Data loading (counterpart of paddle_tpu/io/__init__.py).

Reference parity: python/paddle/io/: Dataset/IterableDataset/TensorDataset
(dataset.py), BatchSampler/DistributedBatchSampler (batch_sampler.py),
DataLoader with multiprocess workers (reader.py:216, dataloader_iter.py).

Workers and the prefetch thread build host numpy batches. A batch reaches
the framework device (`framework.device.current_device()`) through a ring
of pinned host buffers: each numpy leaf is copied into a pinned slot and
from there to the card with a `non_blocking` copy, and a slot is refilled
only after the CUDA event of the copy that read it has completed. On the
CPU there is no pinning (the leaves become CPU tensors). Nothing falls
back from pinned to pageable memory on CUDA: a slot that is not pinned
raises.

Random draws are the JAX package's: `RandomSampler` and friends draw from
the global `np.random`, so one `np.random.seed` gives both packages the
same order.
"""
from __future__ import annotations

import math
import queue
import threading
import time as _time

import numpy as np
import torch

from ..core.tensor import Tensor  # noqa: F401  (paddle.io.Tensor, as the JAX package's)
from ..framework import device as _device


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        n = len(tensors[0])
        assert all(len(t) == n for t in tensors)
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Split into Subsets of `lengths` (ints, or fractions summing to 1)
    along one permutation from the global `np.random`, as the JAX
    package's (which takes `generator` and ignores it)."""
    if all(isinstance(l, float) for l in lengths):
        total = len(dataset)
        lengths = [int(math.floor(total * l)) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    idx = np.random.permutation(len(dataset))
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, idx[off: off + l].tolist()))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """Indices in a random order from the global `np.random` (the JAX
    package's draw), or from `generator` (a `np.random.RandomState`, a numpy
    `Generator` or a `torch.Generator`) when one is passed."""

    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self.generator = generator

    def __iter__(self):
        n = len(self.data_source)
        rng = self.generator if self.generator is not None else np.random
        if isinstance(rng, torch.Generator):
            if self.replacement:
                return iter(torch.randint(0, n, (self.num_samples,), generator=rng).tolist())
            return iter(torch.randperm(n, generator=rng)[: self.num_samples].tolist())
        if self.replacement:
            draw = rng.randint if hasattr(rng, "randint") else rng.integers
            return iter(draw(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """Sample WITHOUT replacement from a fixed index subset
    (reference io/dataloader/sampler.py SubsetRandomSampler)."""

    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        return iter([self.indices[i] for i in np.random.permutation(len(self.indices))])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(p), self.num_samples, replace=self.replacement,
                                     p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """python/paddle/io/dataloader/batch_sampler.py parity."""

    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size


def _dist_rank_world():
    """(rank, world size) of an initialised torch.distributed process
    group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedBatchSampler(BatchSampler):
    """Per-rank sharded batches (dataloader/batch_sampler.py
    DistributedBatchSampler): pads to equal length, epoch-seeded shuffle.
    Without `num_replicas`/`rank`, torch.distributed's world size and rank
    when a process group is initialised, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        if num_replicas is None or rank is None:
            pg_rank, pg_world = _dist_rank_world()
            num_replicas = num_replicas if num_replicas is not None else pg_world
            rank = rank if rank is not None else pg_rank
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - n]
        local = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# ---------------------------------------------------------------------------
# collate
# ---------------------------------------------------------------------------

def _collate(batch, wrap):
    """One recursive collate (python/paddle/io/dataloader/collate.py parity):
    `wrap` turns a stacked numpy leaf into the output leaf type: a device
    tensor for the in-process default, identity for worker processes
    (which must never touch the card)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return wrap(_np_stack([s.detach().cpu().numpy() for s in batch]))
    if isinstance(sample, np.ndarray):
        return wrap(_np_stack(list(batch)))
    if isinstance(sample, (int, np.integer)):
        return wrap(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return wrap(np.asarray(batch, np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: _collate([b[k] for b in batch], wrap) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [_collate(list(items), wrap) for items in zip(*batch)]
    return list(batch)


def _np_stack(arrays):
    a = np.stack(arrays)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _is_array_leaf(x) -> bool:
    return isinstance(x, np.ndarray) and not x.dtype.hasobject


def _leaf_to_device(a: np.ndarray) -> torch.Tensor:
    """One numpy leaf on the framework device: a CPU tensor, or on CUDA a
    pinned copy and a non_blocking copy from it (torch's pinned host
    allocator keeps the block until that copy has completed)."""
    dev = _device.current_device()
    t = torch.from_numpy(np.ascontiguousarray(a) if a.ndim else np.array(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def default_collate_fn(batch):
    """python/paddle/io/dataloader/collate.py parity: stack leaves into
    tensors on the framework device."""
    return _collate(batch, _leaf_to_device)


def _collate_np(batch):
    """The default collate with numpy leaves: used inside worker processes
    and the prefetch thread; the consumer moves the leaves to the device
    (_PinnedRing)."""
    return _collate(batch, lambda a: a)


def _tensor_leaves_to_np(obj):
    """Pre-pickle scrub for worker-process payloads: tensors -> numpy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _tensor_leaves_to_np(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_tensor_leaves_to_np(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_tensor_leaves_to_np(v) for v in obj)
    return obj


def _map_leaves(obj, fn):
    if _is_array_leaf(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_leaves(v, fn) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_map_leaves(v, fn) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_map_leaves(v, fn) for v in obj)
    return obj


def _tensor_leaves(obj, out=None):
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensor_leaves(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensor_leaves(v, out)
    return out


# ---------------------------------------------------------------------------
# host -> device: the ring of pinned buffers
# ---------------------------------------------------------------------------

_ALIGN = 256  # bytes: each leaf's view into a slot starts aligned


class _Slot:
    __slots__ = ("buf", "event")

    def __init__(self):
        self.buf = None  # a pinned uint8 host tensor
        self.event = None  # the CUDA event of the last copy that read it


class _PinnedRing:
    """Numpy batches -> device tensors through `n_slots` pinned host
    buffers (the counterpart of the JAX package's native fixed-buffer ring,
    paddle_tpu/io/__init__.py:356-466). `place` copies a batch's numpy
    leaves into the next slot, then issues one `non_blocking` copy a leaf
    on `stream` (the caller's current stream when None) and records the
    slot's event after them. A slot is refilled only after that event has
    completed, so a host write never races the copy that reads it. On the
    CPU the leaves become CPU tensors (copies, never views of a slot).
    Non-array leaves pass through unchanged."""

    def __init__(self, device, n_slots=2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._slots = [_Slot() for _ in range(max(2, int(n_slots)))]
        self._next = 0

    def place(self, host_batch, stream=None):
        if not self.cuda:  # a copy torch owns (resizable: donation frees it)
            return _map_leaves(host_batch, lambda a: torch.from_numpy(a).clone())
        leaves = []
        _map_leaves(host_batch, lambda a: leaves.append(a) or a)
        if not leaves:
            return host_batch
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()  # the copy that read this slot has completed
        sizes = [-(-a.nbytes // _ALIGN) * _ALIGN for a in leaves]
        need = max(sum(sizes), _ALIGN)
        if slot.buf is None or slot.buf.numel() < need:
            slot.buf = torch.empty(need, dtype=torch.uint8, pin_memory=True)
        if not slot.buf.is_pinned():
            raise RuntimeError("the DataLoader's host ring must be pinned memory on CUDA")
        stream = stream if stream is not None else torch.cuda.current_stream(self.device)
        views, off = [], 0
        for a, n in zip(leaves, sizes):
            src = torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
            view = slot.buf[off: off + a.nbytes].view(src.dtype)[: src.numel()].view(a.shape)
            view.copy_(src.view(a.shape))
            views.append(view)
            off += n
        with torch.cuda.stream(stream):
            outs = [v.to(self.device, non_blocking=True) for v in views]
            slot.event = torch.cuda.Event()
            slot.event.record(stream)
        it = iter(outs)
        return _map_leaves(host_batch, lambda a: next(it))


class _StagedIter:
    """Consumer side of a prefetch thread whose producer places batches on
    a copy stream: waits on each batch's ready event on the consumer's
    stream and marks its tensors used there (`record_stream`), so the
    caching allocator never hands their memory to the copy stream while
    the consumer's kernels still read it."""

    def __init__(self, inner, device):
        self._inner = inner
        self._device = device

    def __iter__(self):
        return self

    def __next__(self):
        batch, ready = next(self._inner)
        return _accept(batch, ready, self._device)


def _accept(batch, ready, device):
    if ready is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(ready)
        for t in _tensor_leaves(batch):
            if t.is_cuda:
                t.record_stream(cur)
    return batch


def _staged(gen_fn, ring, stream):
    """Producer: host batches -> (device batch, ready event) on `stream`."""
    for batch in gen_fn():
        placed = ring.place(batch, stream=stream)
        ready = None
        if stream is not None:
            ready = torch.cuda.Event()
            ready.record(stream)
        yield placed, ready


class _PrefetchIter:
    """Background-thread prefetch: one producer thread fills a bounded
    queue (the reference's multiprocess shared-memory workers in
    dataloader_iter.py, as a thread: the host collate overlaps the device
    step); errors propagate to the consumer."""

    def __init__(self, gen_fn, depth):
        self._q = queue.Queue(maxsize=depth)
        self._done = object()
        self._exc = None

        def worker():
            try:
                for item in gen_fn():
                    self._q.put(item)
            except BaseException as e:  # propagate to consumer
                self._exc = e
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item


# ---------------------------------------------------------------------------
# spawned persistent workers
# ---------------------------------------------------------------------------

def _mp_worker_main(task_q, out_q, dataset, collate_fn, use_np_default, worker_init_fn, w):
    """Spawned persistent worker entry (module-level: must pickle). Serves
    epoch after epoch of batch-index tasks; ships numpy payloads; never
    touches the card. Custom collate_fns run here too and must stay
    numpy-only: building CUDA tensors in a worker would initialise CUDA in
    that process (the documented DataLoader contract)."""
    import pickle

    try:
        if worker_init_fn is not None:
            worker_init_fn(w)
        collate = _collate_np if use_np_default else collate_fn
        while True:
            task = task_q.get()
            if task is None:
                return
            for idxs in task:
                out = collate([dataset[i] for i in idxs])
                out_q.put(("ok", _tensor_leaves_to_np(out)))
            out_q.put(("eof", None))
    except BaseException as e:
        # mp.Queue pickles in a FEEDER THREAD: put() of an unpicklable
        # exception "succeeds" here and then dies silently over there,
        # leaving the parent waiting forever. Probe first.
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(f"{type(e).__name__}: {e}")
        out_q.put(("err", e))


class _MPWorkerPool:
    """Persistent multiprocess workers for map-style datasets: batch b of an
    epoch is built by worker b % num_workers in its own process (the
    reference's dataloader_iter.py worker design + persistent_workers
    semantics). Order is restored by round-robin consumption, one result
    queue per worker so a slow worker backpressures only itself.

    Workers are SPAWNED once per DataLoader and reused across epochs:
    forking a process that has initialised CUDA (or runs torch's threads)
    is unsafe, so fork is out; spawn pays a child interpreter + import
    cost, which persistence amortizes to once per loader."""

    def __init__(self, dataset, collate_fn, num_workers, prefetch, worker_init_fn=None,
                 timeout=0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._nw = num_workers
        self._timeout = timeout  # DataLoader(timeout=...): 0 = no limit
        self._task_qs = [ctx.Queue() for _ in range(num_workers)]
        self._out_qs = [ctx.Queue(maxsize=max(prefetch, 2)) for _ in range(num_workers)]
        use_np_default = collate_fn is default_collate_fn
        self._procs = [
            ctx.Process(
                target=_mp_worker_main,
                args=(self._task_qs[w], self._out_qs[w], dataset,
                      None if use_np_default else collate_fn, use_np_default,
                      worker_init_fn, w),
                daemon=True,
            )
            for w in range(num_workers)
        ]
        self._alive = True
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.shutdown()
            raise
        self._current = None  # the epoch iterator being served

    def run_epoch(self, batch_indices, ring):
        if self._current is not None and not self._current._clean:
            # the previous epoch's iterator was abandoned mid-way: its
            # unread batches/eof markers are still in the out queues and
            # would leak into this epoch; only safe recovery is a respawn
            self.shutdown()
            raise _PoolAbandoned
        batches = list(batch_indices)
        for w in range(self._nw):
            self._task_qs[w].put(batches[w::self._nw])
        self._current = _MPEpochIter(self, len(batches), ring)
        return self._current

    def _get(self, w):
        """out_qs[w].get with liveness watching: a worker OOM-killed or
        segfaulted in native code never enqueues anything; without this the
        training loop hangs forever (the reference's watchdog pattern)."""
        deadline = (_time.monotonic() + self._timeout) if self._timeout else None
        while True:
            try:
                return self._out_qs[w].get(timeout=2.0)
            except queue.Empty:
                if not self._procs[w].is_alive():
                    code = self._procs[w].exitcode
                    self.shutdown()
                    raise RuntimeError(
                        f"DataLoader worker {w} died unexpectedly (exit code "
                        f"{code}): killed by the OS (OOM?) or crashed in "
                        "native code"
                    )
                if deadline is not None and _time.monotonic() > deadline:
                    self.shutdown()
                    raise RuntimeError(f"DataLoader worker {w} timed out after {self._timeout}s")

    def shutdown(self):
        if not self._alive:
            return
        self._alive = False
        for q in self._task_qs:
            try:
                q.put(None)
            except Exception:
                pass
        for p in self._procs:
            if p.pid is not None:
                p.join(timeout=2)
        for p in self._procs:
            if p.pid is not None and p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q in self._task_qs + self._out_qs:
            q.close()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class _PoolAbandonedType(Exception):
    pass


_PoolAbandoned = _PoolAbandonedType()


class _MPEpochIter:
    def __init__(self, pool, n_batches, ring):
        self._pool = pool
        self._n = n_batches
        self._ring = ring
        self._next = 0
        self._clean = False  # fully consumed + eofs drained

    def __iter__(self):
        return self

    def __next__(self):
        if self._next >= self._n:
            if not self._clean:
                # pop each worker's trailing eof so its queue is clean for
                # the next epoch
                for w in range(self._pool._nw):
                    kind, payload = self._pool._get(w)
                    if kind == "err":
                        self._pool.shutdown()
                        raise payload
                self._clean = True
            raise StopIteration
        kind, payload = self._pool._get(self._next % self._pool._nw)
        if kind == "err":
            self._pool.shutdown()
            raise payload
        self._next += 1
        return self._ring.place(payload)


class DataLoader:
    """python/paddle/io/reader.py:216 parity.

    Worker modes: num_workers=0 is synchronous; num_workers>0 uses a
    prefetch thread by default; persistent_workers=True spawns persistent
    worker PROCESSES (map-style datasets only: needs a picklable
    dataset/collate_fn/worker_init_fn). If spawn fails (e.g. unpicklable
    local classes), loading falls back to the thread path with a
    UserWarning, and `worker_init_fn` does NOT run on that fallback
    (threads share the parent's state; per-worker init has no process to
    initialize).

    With the default collate, every path collates numpy and moves the
    batch through the loader's ring of pinned buffers (`_PinnedRing`); the
    prefetch thread issues its copies on a stream of its own and the
    consumer's stream waits on each batch's event. A custom collate_fn's
    output is yielded as it returns it, except from worker processes,
    whose numpy leaves always become device tensors, as in the JAX
    package. `use_shared_memory` chose the JAX package's native ring over
    its plain queue; the pinned ring has no such alternative here, so the
    flag is kept for paddle's signature and changes nothing. Worker
    processes hand batches over through `multiprocessing` queues, as the
    JAX package's do."""

    def __init__(
        self,
        dataset,
        feed_list=None,
        places=None,
        return_list=True,
        batch_sampler=None,
        batch_size=1,
        shuffle=False,
        drop_last=False,
        collate_fn=None,
        num_workers=0,
        use_buffer_reader=True,
        prefetch_factor=2,
        use_shared_memory=True,
        timeout=0,
        worker_init_fn=None,
        persistent_workers=False,
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self._worker_init_fn = worker_init_fn
        self._persistent = bool(persistent_workers)
        self._timeout = timeout or 0
        self.use_shared_memory = use_shared_memory
        self.prefetch = max(prefetch_factor, 1) if use_buffer_reader else 0
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self._ring = None
        self._copy_stream = None
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle, batch_size=batch_size,
                                              drop_last=drop_last)

    def _host_collate(self):
        return _collate_np if self.collate_fn is default_collate_fn else self.collate_fn

    def _gen(self):
        """Host batches (numpy leaves under the default collate)."""
        collate = self._host_collate()
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if self.batch_size is not None and len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield collate(batch)
            return
        for batch_idx in self.batch_sampler:
            yield collate([self.dataset[i] for i in batch_idx])

    def _depth(self):
        return self.prefetch * max(self.num_workers, 1)

    def _device_ring(self):
        dev = _device.current_device()
        if self._ring is None or self._ring.device != dev:
            self._ring = _PinnedRing(dev, self._depth() + 2)
            self._copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        return self._ring

    def _sync_iter(self):
        if self.collate_fn is not default_collate_fn:
            return self._gen()
        ring = self._device_ring()
        return (ring.place(b) for b in self._gen())

    def _prefetch_iter(self):
        """Thread prefetch: one producer thread collates; under the default
        collate it also places each batch through the pinned ring on the
        loader's copy stream."""
        depth = self._depth()
        if self.collate_fn is not default_collate_fn:
            return _PrefetchIter(self._gen, depth)
        ring = self._device_ring()
        inner = _PrefetchIter(lambda: _staged(self._gen, ring, self._copy_stream), depth)
        return _StagedIter(inner, ring.device)

    def _mp_iter(self):
        ring = self._device_ring()
        pool = getattr(self, "_mp_pool", None)
        if pool is None or not pool._alive:
            self._mp_pool = _MPWorkerPool(
                self.dataset, self.collate_fn, self.num_workers,
                self._depth(), self._worker_init_fn, self._timeout,
            )
        try:
            return self._mp_pool.run_epoch(list(self.batch_sampler), ring)
        except _PoolAbandonedType:
            # previous epoch iterator abandoned mid-way: queues are dirty,
            # pool was shut down; respawn once, clean
            self._mp_pool = _MPWorkerPool(
                self.dataset, self.collate_fn, self.num_workers,
                self._depth(), self._worker_init_fn, self._timeout,
            )
            return self._mp_pool.run_epoch(list(self.batch_sampler), ring)

    def _record_worker_fallback(self, exc) -> None:
        """Process->thread degradation accounting: warn once per loader with
        the reason, count every occurrence
        (`paddle_tpu_dataloader_fallbacks_total{reason}`)."""
        reason = type(exc).__name__
        try:
            from .. import telemetry as _tm

            if _tm.enabled():
                _tm.counter(
                    "paddle_tpu_dataloader_fallbacks_total",
                    "DataLoader worker-process spawns degraded to thread "
                    "prefetch (unpicklable dataset/collate, no mp, ...)",
                    ("reason",),
                ).labels(reason=reason).inc()
        except Exception:
            pass  # accounting must never break data loading
        if getattr(self, "_fallback_warned", False):
            return
        self._fallback_warned = True
        import warnings

        warnings.warn(
            f"DataLoader(persistent_workers=True): worker spawn failed "
            f"({reason}: {exc}); falling back to thread prefetch "
            "(worker_init_fn will NOT run)",
            stacklevel=3,
        )

    def _shutdown_workers(self):
        """Stop the persistent worker processes (as collecting the loader
        does)."""
        pool = getattr(self, "_mp_pool", None)
        if pool is not None:
            pool.shutdown()

    def __del__(self):
        try:
            self._shutdown_workers()
        except Exception:
            pass

    def __iter__(self):
        if self.prefetch and self.num_workers != 0:
            # persistent_workers -> real worker PROCESSES (the reference's
            # dataloader_iter.py + persistent_workers semantics), at a
            # one-time spawned-interpreter cost amortized over epochs.
            # Default stays the prefetch thread. Iterable datasets always
            # thread (no index sharding without worker_info).
            if self.num_workers > 0 and self._persistent and not self._iterable_mode:
                try:
                    return self._mp_iter()
                except (TypeError, AttributeError, OSError, ImportError) as e:
                    # spawn needs a picklable dataset/collate/worker_init_fn;
                    # degrade loudly, not silently: the warning fires ONCE
                    # per loader, the fallback counter every time
                    self._record_worker_fallback(e)
            return self._prefetch_iter()
        return self._sync_iter()

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)


def get_worker_info():
    return None


# the streaming data tier (sharded/resumable/device-prefetched input) lives
# in its own subpackage; imported last because its loader builds on the
# Dataset/collate/prefetch machinery above
from . import streaming  # noqa: E402,F401

__all__ = [
    "BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset", "DataLoader", "Dataset",
    "DistributedBatchSampler", "IterableDataset", "RandomSampler", "Sampler", "SequenceSampler",
    "Subset", "SubsetRandomSampler", "TensorDataset", "WeightedRandomSampler",
    "default_collate_fn", "get_worker_info", "random_split", "streaming",
]
