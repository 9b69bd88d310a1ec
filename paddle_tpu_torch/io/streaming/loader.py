"""The streaming loader: sharded, resumable, device-prefetched input
(counterpart of paddle_tpu/io/streaming/loader.py).

`StreamingLoader` is built from three layers:

1. **Sharded order**: a `ShardPlan` per epoch (epoch-seeded deterministic
   shuffle, wrap-padding to whole global batches, dp-degree-independent;
   see sharding.py). The loader assembles the GLOBAL batch each step;
   `rank_view()` exposes one dp replica's host iterator (multi-process
   loaders, tests).

2. **Background host->device prefetch**: host batches are collated on a
   prefetch thread (`io._PrefetchIter`), and a second thread copies them
   to the card from a ring of pinned host buffers (`io._PinnedRing`) on a
   `torch.cuda.Stream` of its own, so step N's H2D copy overlaps step
   N-1's compute. Each batch carries the CUDA event recorded after its
   copies; the consumer's stream waits on it, and `record_stream` keeps
   the caching allocator from handing a batch's memory back to the copy
   stream while the consumer's kernels still read it. `donate=True` frees
   the PREVIOUS yielded batch's device memory when the next one is taken
   (its storage is released, as the JAX package deletes the buffers), so
   the steady state holds at most `prefetch_depth + 2` device batches (the
   ring, one more held by the copy thread while it blocks on a full ring,
   and the one being consumed), plus up to `prefetch_depth + 1` host
   batches in the collate ring. A donated batch must not be retained
   across steps by the consumer. Abandoning an iteration early (break)
   shuts both rings down and releases their in-flight batches. On the CPU
   the ring makes CPU tensors and no stream is involved.

3. **Deterministic mid-epoch resume**: `state_dict()` captures (epoch,
   seed, cursor) where cursor counts global batches CONSUMED (batches
   sitting in the prefetch ring are not consumed: a restore re-reads them,
   so an interrupt can never skip in-flight data). The cursor is GLOBAL,
   so restoring onto a different dp degree (dp=4 -> 3) re-splits the same
   global stream with no sample lost or read twice. `state_to_tensors` /
   `tensors_to_state` adapt the state to a checkpoint of tensors.

Reader-lag observability rides every batch: wait-for-batch and H2D times,
queue depth, and samples/s land in the `paddle_tpu_input_*` family
(stats.py); the guardian picks the per-step wait up as `input_wait_s`.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import IterableDataset, _PinnedRing, _PrefetchIter, _accept, _collate_np, _tensor_leaves
from ...framework import device as _device
from . import stats as _instats
from .sharding import ShardPlan, data_shard_info, n_global_batches

_STATE_KEYS = ("version", "epoch", "cursor", "seed", "global_batch_size",
               "dataset_len", "shuffle", "drop_last")
_STATE_VERSION = 1


class StreamingLoader:
    """See module docstring. Iterating yields the REMAINDER of the current
    epoch (from the resume cursor) and then rolls the epoch, so the usual

        for epoch in range(E):
            for batch in loader: ...

    loop is resume-correct out of the box. `mesh` raises until ROADMAP
    Queue A item 5 brings one (pass `dp_world`); `shard_batch` is kept for
    the JAX package's callers and places nothing while there is no mesh.
    """

    def __init__(
        self,
        dataset,
        global_batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        collate_fn: Optional[Callable] = None,
        mesh=None,
        dp_world: Optional[int] = None,
        place: bool = True,
        shard_batch: bool = True,
        prefetch_depth: int = 2,
        donate: bool = False,
        source: str = "streaming",
    ):
        if isinstance(dataset, IterableDataset):
            raise TypeError(
                "StreamingLoader needs a map-style dataset (resume cursors "
                "index samples); wrap iterables with a materializing Dataset"
            )
        self.dataset = dataset
        self.global_batch_size = int(global_batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.collate_fn = collate_fn or _collate_np
        self.mesh = mesh
        mesh_world, mesh_axes = data_shard_info(mesh)
        self.dp_world = int(dp_world) if dp_world is not None else mesh_world
        self.batch_axes = mesh_axes
        self.place = bool(place)
        self.shard_batch = bool(shard_batch)
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.donate = bool(donate)
        self.source = source
        if self.dp_world > 1 and self.global_batch_size % self.dp_world != 0:
            raise ValueError(
                f"global_batch_size {self.global_batch_size} must divide by "
                f"the dp world {self.dp_world} (padding-consistent split)"
            )
        self.epoch = 0
        self._cursor = 0  # global batches CONSUMED in the current epoch
        self._in_flight = 0  # prefetched-not-consumed (observability only)
        self._prev_batch = None  # last yielded device batch (donation)
        self._active_iter = None
        self._ring = None
        self._copy_stream = None

    # ------------------------------------------------------------------ plan
    def _plan(self) -> ShardPlan:
        return ShardPlan(
            len(self.dataset), self.global_batch_size, self.seed, self.epoch,
            shuffle=self.shuffle, drop_last=self.drop_last,
        )

    def __len__(self):
        # arithmetic only: building the plan would re-permute the whole
        # dataset on every len() call (progress bars call it per step)
        return n_global_batches(len(self.dataset), self.global_batch_size, self.drop_last)

    def rank_view(self, rank: int, world: Optional[int] = None):
        """Host-side iterator over ONE dp replica's slice of the current
        epoch from the current cursor: yields (global_batch_index,
        sample_indices, collated host batch). The multi-process path and
        the disjointness oracle."""
        world = int(world) if world is not None else self.dp_world
        plan = self._plan()
        for b in range(self._cursor, plan.n_batches):
            idx = plan.rank_batch(b, rank, world)
            yield b, idx, self.collate_fn([self.dataset[int(i)] for i in idx])

    # ------------------------------------------------------------ placement
    def _device_ring(self) -> _PinnedRing:
        dev = _device.current_device()
        if self._ring is None or self._ring.device != dev:
            self._ring = _PinnedRing(dev, self.prefetch_depth + 2)
            self._copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        return self._ring

    def _delete_prev(self):
        """Release the previous yielded batch's device memory (the JAX
        package deletes its buffers): the storage shrinks to 0 bytes and the
        caching allocator takes the block back once the streams that used
        it (record_stream) are past it."""
        prev, self._prev_batch = self._prev_batch, None
        if prev is None:
            return
        for t in _tensor_leaves(prev):
            try:
                t.untyped_storage().resize_(0)
            except Exception:
                pass  # donation is an optimization, never a crash

    # ------------------------------------------------------------ iteration
    def _host_batches(self, plan: ShardPlan, start: int):
        for b in range(start, plan.n_batches):
            idx = plan.global_batch(b)
            yield b, self.collate_fn([self.dataset[int(i)] for i in idx])

    def _device_stream(self, host_iter, ring, stream):
        """Host batch -> (b, device batch, ready event); runs IN the copy
        thread when prefetching (the copies overlap the consumer's
        compute), inline on the consumer's stream otherwise."""
        for b, host_batch in host_iter:
            t0 = time.perf_counter()
            ready = None
            if self.place:
                placed = ring.place(host_batch, stream=stream)
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
            else:
                placed = host_batch
            _instats.observe_h2d(time.perf_counter() - t0, source=self.source)
            yield b, placed, ready

    @staticmethod
    def _stoppable(gen, stop: "threading.Event"):
        for item in gen:
            if stop.is_set():
                return
            yield item

    @staticmethod
    def _shutdown_rings(stop: "threading.Event", rings):
        """Abandoned mid-epoch (break / exception): the ring producers may
        be blocked in `q.put` on full queues, which would strand the
        threads AND pin their in-flight device batches forever. Signal the
        stop flag, then drain each ring (consumer-side first: its producer
        feeds off the host ring) until its thread exits. Best-effort with a
        per-ring deadline: the threads are daemons, so a pathologically
        slow reader can't hang teardown."""
        stop.set()
        for ring in rings:
            deadline = time.monotonic() + 5.0
            while ring._t.is_alive() and time.monotonic() < deadline:
                try:
                    ring._q.get_nowait()
                except queue.Empty:
                    ring._t.join(timeout=0.05)

    def __iter__(self):
        plan = self._plan()
        if self._cursor >= plan.n_batches:
            # defensive: a hand-restored cursor at/past epoch end must roll
            # here instead of yielding a phantom empty epoch
            self.epoch += 1
            self._cursor = 0
            plan = self._plan()
        start = self._cursor
        stop = threading.Event()
        rings = []
        ring = self._device_ring() if self.place else None
        dev = ring.device if ring is not None else None
        if self.prefetch_depth > 0:
            # two layered rings: a host collate thread feeding a prefetch
            # ring, and a copy thread feeding the device ring the consumer
            # drains
            stream = self._copy_stream
            host = _PrefetchIter(
                lambda: self._stoppable(self._host_batches(plan, start), stop),
                self.prefetch_depth,
            )
            it = _PrefetchIter(
                lambda: self._stoppable(self._device_stream(host, ring, stream), stop),
                self.prefetch_depth,
            )
            rings = [it, host]
        else:
            it = iter(self._device_stream(self._host_batches(plan, start), ring, None))
        self._active_iter = it
        finished = False
        try:
            for _ in range(start, plan.n_batches):
                t0 = time.perf_counter()
                try:
                    b, batch, ready = next(it)
                except StopIteration:  # dataset/collate raced to empty
                    break
                if ready is not None:
                    batch = _accept(batch, ready, dev)
                _instats.observe_wait(time.perf_counter() - t0, source=self.source)
                if self.prefetch_depth > 0:
                    self._in_flight = it._q.qsize()
                    _instats.set_queue_depth(self._in_flight, self.prefetch_depth,
                                             source=self.source)
                _instats.observe_batch(self.global_batch_size, source=self.source)
                if self.donate:
                    self._delete_prev()
                    self._prev_batch = batch
                self._cursor = b + 1
                if self._cursor >= plan.n_batches:
                    # roll AT the final yield, not after the loop: a
                    # consumer that breaks on the last batch (the standard
                    # max-steps pattern) would otherwise find a phantom
                    # empty epoch on its next iteration, and a checkpoint
                    # taken after that last step must resume into the NEXT
                    # epoch's start, not an exhausted cursor
                    self.epoch += 1
                    self._cursor = 0
                    self._in_flight = 0
                yield batch
            finished = True
        finally:
            self._active_iter = None
            if rings and not finished:
                self._shutdown_rings(stop, rings)

    # --------------------------------------------------------------- resume
    def state_dict(self) -> dict:
        """Plain-int state: everything needed to resume bit-identically
        (the prefetch ring's in-flight batches are NOT consumed: they are
        re-read on restore, but the fill is recorded for observability)."""
        return {
            "version": _STATE_VERSION,
            "epoch": int(self.epoch),
            "cursor": int(self._cursor),
            "seed": int(self.seed),
            "global_batch_size": int(self.global_batch_size),
            "dataset_len": int(len(self.dataset)),
            "shuffle": int(self.shuffle),
            "drop_last": int(self.drop_last),
            "prefetch_in_flight": int(self._in_flight),
            "dp_world": int(self.dp_world),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore (epoch, seed, cursor). The stream identity fields must
        match: a different dataset length or global batch silently changes
        which samples a cursor names, so that is an error, never a guess.
        `dp_world` is NOT required to match: the cursor is global and
        re-splits losslessly onto the current topology."""
        missing = [k for k in _STATE_KEYS if k not in state]
        if missing:
            raise ValueError(f"streaming state missing keys {missing}")
        if int(state["version"]) != _STATE_VERSION:
            raise ValueError(f"unknown streaming state version {state['version']}")
        for field, mine in (
            ("dataset_len", len(self.dataset)),
            ("global_batch_size", self.global_batch_size),
            ("shuffle", int(self.shuffle)),
            ("drop_last", int(self.drop_last)),
        ):
            if int(state[field]) != int(mine):
                raise ValueError(
                    f"streaming state mismatch: saved {field}="
                    f"{int(state[field])}, loader has {int(mine)}"
                )
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])
        self._in_flight = 0
        self._prev_batch = None


# ---------------------------------------------------------------------------
# checkpoint adapters: a checkpoint of tensors
# ---------------------------------------------------------------------------

def state_to_tensors(state: dict) -> dict:
    """Loader state -> {key: int64 0-d tensor on the framework device},
    embeddable in a state_dict a checkpoint saves."""
    dev = _device.current_device()
    return {k: torch.tensor(int(state[k]), dtype=torch.int64, device=dev) for k in _STATE_KEYS}


def state_template() -> dict:
    """Zero-filled template to load a checkpoint into: load into this, then
    `tensors_to_state` -> `loader.load_state_dict`."""
    dev = _device.current_device()
    return {k: torch.zeros((), dtype=torch.int64, device=dev) for k in _STATE_KEYS}


def tensors_to_state(tensors: dict) -> dict:
    return {k: int(t.item() if isinstance(t, torch.Tensor) else np.asarray(t))
            for k, t in tensors.items()}
