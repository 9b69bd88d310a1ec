"""Data sharding: which replica reads which samples (counterpart of
paddle_tpu/io/streaming/sharding.py).

The JAX package derives the data-parallel degree from its global mesh
(`data_shard_info(mesh)`). The port has no mesh yet (ROADMAP Queue A item
5, distributed): a `mesh` argument raises, and without one the split is a
single replica, `(1, ())`, unless the caller passes the dp world and rank
explicitly. A process rank defaults to torch.distributed's when a process
group is initialised.

Determinism contract (`ShardPlan`): one epoch's global sample order is a
pure function of (dataset_len, global_batch_size, seed, epoch): an
epoch-seeded permutation, padded by wrapping to a whole number of global
batches. The pad depends only on those four numbers, NEVER on the dp
degree, so a dp=4 run and a dp=3 run see byte-identical global batches
("padding-consistent") and a mid-epoch cursor can be re-split onto a
different dp degree without losing or repeating a sample. The integer math
is the JAX package's, so both packages read the same samples.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .. import BatchSampler, Dataset, _dist_rank_world


def _process_rank() -> int:
    """This process's dp rank for defaulting (rank=None): torch.distributed's
    rank when a process group is initialised, else 0."""
    return _dist_rank_world()[0]


def n_global_batches(n_samples: int, global_batch_size: int,
                     drop_last: bool = False) -> int:
    """Batches per epoch WITHOUT materializing the order (O(1) — `__len__`
    callers hit this every step)."""
    if drop_last:
        return n_samples // global_batch_size
    return int(math.ceil(n_samples / global_batch_size))


def data_shard_info(mesh=None) -> Tuple[int, Tuple[str, ...]]:
    """(dp_degree, batch_axes): (1, ()) for the single replica the port
    runs today. A device mesh is ROADMAP Queue A item 5 (distributed); a
    `mesh` argument raises until then, rather than guessing a degree."""
    if mesh is not None:
        raise NotImplementedError(
            "io.streaming: a device mesh arrives with distributed (ROADMAP Queue A "
            "item 5); pass dp_world/rank (or world/rank) explicitly instead"
        )
    return 1, ()


class ShardPlan:
    """One epoch's deterministic global order + per-rank split (pure numpy:
    the launcher-side resume math must import without a device).

    Global batch g is ``order[g*G : (g+1)*G]``; rank r of world W reads rows
    ``[r*G/W, (r+1)*G/W)`` of every global batch (requires G % W == 0 — the
    padding-consistent contract), so per-rank shards are disjoint, cover the
    epoch, and re-splitting a global cursor onto a different W is trivially
    lossless.
    """

    def __init__(self, n_samples: int, global_batch_size: int, seed: int = 0,
                 epoch: int = 0, shuffle: bool = True, drop_last: bool = False):
        if n_samples <= 0:
            raise ValueError(f"need a non-empty dataset, got n={n_samples}")
        if global_batch_size <= 0:
            raise ValueError(f"global_batch_size must be positive, got {global_batch_size}")
        self.n_samples = int(n_samples)
        self.global_batch_size = int(global_batch_size)
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        if self.shuffle:
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + self.epoch) % (2 ** 32)
            )
            order = rng.permutation(self.n_samples)
        else:
            order = np.arange(self.n_samples)
        G = self.global_batch_size
        if self.drop_last:
            n_batches = self.n_samples // G
            if n_batches == 0:
                raise ValueError(
                    f"drop_last with n={self.n_samples} < global batch {G} "
                    "yields zero batches"
                )
            order = order[: n_batches * G]
        else:
            n_batches = int(math.ceil(self.n_samples / G))
            if n_batches * G != self.n_samples:
                # wrap-pad by CYCLING the SAME epoch order (np.resize
                # repeats it as many times as needed — order[:pad] would
                # silently come up short when G > n_samples): still a pure
                # function of (n, G, seed, epoch), dp-degree independent
                order = np.resize(order, n_batches * G)
        self.order = order.astype(np.int64)
        self.n_batches = n_batches

    def global_batch(self, b: int) -> np.ndarray:
        if not 0 <= b < self.n_batches:
            raise IndexError(f"batch {b} out of range [0, {self.n_batches})")
        G = self.global_batch_size
        return self.order[b * G:(b + 1) * G]

    def rank_batch(self, b: int, rank: int, world: int) -> np.ndarray:
        G = self.global_batch_size
        if world <= 0 or G % world != 0:
            raise ValueError(
                f"global batch {G} must divide by dp world {world} "
                "(the padding-consistent per-rank split)"
            )
        if not 0 <= rank < world:
            raise IndexError(f"rank {rank} out of range [0, {world})")
        per = G // world
        return self.global_batch(b)[rank * per:(rank + 1) * per]

    def rank_indices(self, rank: int, world: int) -> np.ndarray:
        """Every sample index rank r reads this epoch, in read order."""
        return np.concatenate(
            [self.rank_batch(b, rank, world) for b in range(self.n_batches)]
        )


class ShardedDataset(Dataset):
    """Map-style view of one dp replica's shard of one epoch.

    (rank, world) default to the process rank and `data_shard_info()`'s
    degree (1 until item 5);
    `set_epoch` re-derives the epoch-seeded order. Mostly a building block
    for multi-process loaders and the disjointness tests; the
    `StreamingLoader` assembles global batches itself.
    """

    def __init__(self, dataset, global_batch_size: int, rank: Optional[int] = None,
                 world: Optional[int] = None, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = False):
        mesh_world, _ = data_shard_info()
        self.dataset = dataset
        self.world = int(world) if world is not None else mesh_world
        self.rank = int(rank) if rank is not None else _process_rank()
        self.global_batch_size = int(global_batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self._epoch = 0
        self._reindex()

    def _reindex(self):
        plan = ShardPlan(
            len(self.dataset), self.global_batch_size, self.seed, self._epoch,
            shuffle=self.shuffle, drop_last=self.drop_last,
        )
        self.plan = plan
        self.indices = plan.rank_indices(self.rank, self.world)

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)
        self._reindex()

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


class MeshDistributedBatchSampler(BatchSampler):
    """`DistributedBatchSampler` over the padding-consistent ShardPlan, so
    its shards line up with a StreamingLoader resume. (rank, world)
    default as `ShardedDataset`'s do."""

    def __init__(self, dataset, batch_size: int, rank: Optional[int] = None,
                 num_replicas: Optional[int] = None, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        mesh_world, _ = data_shard_info()
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.nranks = int(num_replicas) if num_replicas is not None else mesh_world
        # default the rank like io.DistributedBatchSampler does: the process
        # rank — defaulting to 0 would make every process of a multi-process
        # launch silently read shard 0
        self.local_rank = int(rank) if rank is not None else _process_rank()
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.seed = int(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _plan(self) -> ShardPlan:
        return ShardPlan(
            len(self.dataset), self.batch_size * self.nranks, self.seed,
            self.epoch, shuffle=self.shuffle, drop_last=self.drop_last,
        )

    def __iter__(self):
        plan = self._plan()
        for b in range(plan.n_batches):
            yield plan.rank_batch(b, self.local_rank, self.nranks).tolist()

    def __len__(self):
        # arithmetic only: building a ShardPlan here would re-permute the
        # whole dataset every time a progress bar asks for len()
        return n_global_batches(
            len(self.dataset), self.batch_size * self.nranks, self.drop_last
        )
