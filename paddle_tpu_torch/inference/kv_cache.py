"""Paged KV cache: fixed-size pages in a preallocated per-layer pool
(counterpart of paddle_tpu/inference/kv_cache.py).

Per layer the pool holds k/v pages [num_blocks, block_size, Hkv, D] on the
device; a host-side allocator hands pages out. Page 0 is reserved as the
trash page: block tables are padded with it, so masked reads land on a
valid page and padded-position writes scribble somewhere harmless.

The allocator makes the JAX package's decisions exactly: a LIFO free
list, refcounted pages, a prefix index over FULL pages keyed by the chain
digest of every token up to the page, refcount-zero indexed pages retained
and reclaimed LRU-first, and copy-on-write through `make_private`. An
int8 pool (`kv_dtype="int8"`) stores pages as int8 with per-slot-per-kv-
head f32 scale planes [N, bs, Hkv] written with the absmax rule of
quantization/observers.py.

Pool pressure exports through the telemetry registry (the JAX package's
`paddle_tpu_kv_*` families), and `owner=` charges pages to a request id
in the request traces. Cross-pool migration (the disaggregated fleet's
prefill -> decode handoff) goes through the host: `export_pages` gathers a
request's pages into a numpy payload, `convert_payload` re-encodes it for
an int8 destination with the same absmax rule the pool writes with,
`payload_page_crcs` CRCs every page's bytes, `import_pages` scatters it.
bf16 planes travel as their 16-bit patterns (`np.uint16`, the payload's
"dtype" says "bfloat16"): the card's Python has no `ml_dtypes`. A JAX
payload (`ml_dtypes.bfloat16` arrays) imports unchanged, and the CRCs of
the same page bytes are the JAX package's.
"""
from __future__ import annotations

import hashlib
import math
import random
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..framework import device as _device
from ..quantization.observers import absmax_scale, quantize_absmax
from ..telemetry import metrics as _metrics
from ..telemetry import request_trace as _rt

__all__ = ["BlockPool", "PagedCacheView", "PoolExhausted", "TRASH_PAGE", "chain_extend",
           "prefix_chain_keys", "export_pages", "convert_payload", "import_pages",
           "payload_page_crcs", "corrupt_payload"]

TRASH_PAGE = 0  # reserved: block-table padding + padded-position writes


class PoolExhausted(RuntimeError):
    """alloc() found too few free pages: the caller's cue to preempt or
    refuse admission."""


def _pool_gauge(state: str):
    return _metrics.gauge(
        "paddle_tpu_kv_pool_blocks",
        "paged KV cache pool occupancy by state",
        label_names=("state",),
    ).labels(state=state)


def _prefix_counter(event: str):
    return _metrics.counter(
        "paddle_tpu_kv_prefix_lookups_total",
        "prefix-cache admission lookups by outcome",
        label_names=("event",),
    ).labels(event=event)


def chain_extend(h: bytes, page_tokens: Sequence[int]) -> bytes:
    """The key of the page holding `page_tokens` after the page keyed `h`
    (b"" at the chain head): it commits to every token up to the page."""
    digest = hashlib.blake2b(digest_size=16)
    digest.update(h)
    digest.update(b",".join(str(int(t)).encode() for t in page_tokens))
    return digest.digest()


def prefix_chain_keys(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chain digests of every FULL page of `tokens`."""
    keys: List[bytes] = []
    h = b""
    for i in range(len(tokens) // block_size):
        h = chain_extend(h, tokens[i * block_size:(i + 1) * block_size])
        keys.append(h)
    return keys


class PagedCacheView:
    """The pool's page tensors plus one step's block tables [B, M] and
    seq_lens [B], as the model's attention layers see them.

    `write` updates the pool tensors IN PLACE (`index_put_`): the JAX
    version is functional and hands an updated copy of every page array
    back to the engine, which costs a pool copy per step where the
    compiler cannot alias it; eager PyTorch has no such copy to elide, so
    the port writes where the pages live. `write_mask` [B, S] bool sends
    masked positions' writes to the trash page (the engine's extend step
    neutralises pad queries with it)."""

    def __init__(self, k_pages: Sequence[torch.Tensor], v_pages: Sequence[torch.Tensor],
                 block_tables, seq_lens, block_size: int,
                 k_scales: Optional[Sequence[torch.Tensor]] = None,
                 v_scales: Optional[Sequence[torch.Tensor]] = None, write_mask=None):
        dev = k_pages[0].device
        self.k_pages = list(k_pages)
        self.v_pages = list(v_pages)
        self.k_scales = list(k_scales) if k_scales is not None else None
        self.v_scales = list(v_scales) if v_scales is not None else None
        self.block_tables = torch.as_tensor(block_tables, dtype=torch.int32).to(dev)
        self.seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32).to(dev)
        self.block_size = int(block_size)
        self.write_mask = (torch.as_tensor(write_mask, dtype=torch.bool).to(dev)
                           if write_mask is not None else None)

    def layer(self, idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.k_pages[idx], self.v_pages[idx]

    def scales(self, idx: int):
        """(k_scales, v_scales) of layer `idx`, or (None, None) unquantized."""
        if self.k_scales is None:
            return None, None
        return self.k_scales[idx], self.v_scales[idx]

    def write(self, idx: int, k_new: torch.Tensor, v_new: torch.Tensor, positions) -> None:
        """Scatter k_new/v_new [B, S, Hkv, D] at absolute `positions` [B, S]:
        position p of row b lands in page block_tables[b, p // bs], slot
        p % bs."""
        pos = torch.as_tensor(positions).to(self.block_tables.device).long()
        bs = self.block_size
        pages = torch.gather(self.block_tables.long(), 1, pos // bs)
        if self.write_mask is not None:
            pages = torch.where(self.write_mask, pages, TRASH_PAGE)
        slots = pos % bs
        if self.k_scales is not None:
            # int8 storage: one absmax scale per written slot and kv head,
            # so appends never requantize resident slots
            k_sc = absmax_scale(k_new, dim=-1)
            v_sc = absmax_scale(v_new, dim=-1)
            self.k_pages[idx].index_put_((pages, slots), quantize_absmax(k_new, k_sc[..., None]))
            self.v_pages[idx].index_put_((pages, slots), quantize_absmax(v_new, v_sc[..., None]))
            self.k_scales[idx].index_put_((pages, slots), k_sc)
            self.v_scales[idx].index_put_((pages, slots), v_sc)
        else:
            self.k_pages[idx].index_put_((pages, slots), k_new.to(self.k_pages[idx].dtype))
            self.v_pages[idx].index_put_((pages, slots), v_new.to(self.v_pages[idx].dtype))


class BlockPool:
    """Preallocated paged KV pool + host allocator. `num_blocks` INCLUDES
    the reserved trash page 0; usable capacity is num_blocks - 1 pages."""

    def __init__(self, num_blocks: int, block_size: int, num_layers: int, num_kv_heads: int,
                 head_dim: int, dtype=torch.float32, kv_dtype: Optional[str] = None,
                 device=None):
        if num_blocks < 2:
            raise ValueError("BlockPool needs >= 2 blocks (page 0 is reserved)")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (int8 or None)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.kv_dtype = kv_dtype
        self.dtype = torch.int8 if kv_dtype == "int8" else dtype
        self.device = _device.resolve(device)
        shape = (self.num_blocks, self.block_size, self.num_kv_heads, self.head_dim)
        new = lambda shp, dt: torch.zeros(shp, dtype=dt, device=self.device)
        self.k_pages: List[torch.Tensor] = [new(shape, self.dtype) for _ in range(self.num_layers)]
        self.v_pages: List[torch.Tensor] = [new(shape, self.dtype) for _ in range(self.num_layers)]
        if kv_dtype == "int8":
            self.k_scales: Optional[List[torch.Tensor]] = [
                new(shape[:3], torch.float32) for _ in range(self.num_layers)]
            self.v_scales: Optional[List[torch.Tensor]] = [
                new(shape[:3], torch.float32) for _ in range(self.num_layers)]
        else:
            self.k_scales = None
            self.v_scales = None
        # LIFO free list: recently freed pages hand out first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        # page -> refcount, for every page a request currently holds
        self._refs: Dict[int, int] = {}
        # refcount-zero pages kept resident for prefix reuse, LRU order
        # (oldest first); values are the index keys they serve
        self._retained: "OrderedDict[int, bytes]" = OrderedDict()
        # prefix index: chain key -> page, page -> chain key
        self._prefix: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self.cow_copies = 0
        if telemetry.enabled():
            _pool_gauge("total").set(self.num_blocks - 1)
            self._sync_gauges()

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    # ---- accounting ----
    def blocks_for_tokens(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.block_size))

    def available(self) -> int:
        """Pages alloc() can satisfy: free pages plus retained ones."""
        return len(self._free) + len(self._retained)

    def used(self) -> int:
        """Pages some request holds (refcount >= 1)."""
        return len(self._refs)

    def shared(self) -> int:
        return sum(1 for r in self._refs.values() if r >= 2)

    def retained(self) -> int:
        return len(self._retained)

    def occupancy(self) -> float:
        return self.used() / max(1, self.num_blocks - 1)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def page_bytes(self) -> int:
        """Device bytes one page costs across all layers (K + V + scales)."""
        slot = self.block_size * self.num_kv_heads
        elt = torch.empty((), dtype=self.dtype).element_size()
        data = 2 * self.num_layers * slot * self.head_dim * elt
        return data + (2 * self.num_layers * slot * 4 if self.quantized else 0)

    def pool_bytes(self) -> int:
        return self.num_blocks * self.page_bytes()

    def _sync_gauges(self) -> None:
        _pool_gauge("used").set(self.used())
        _pool_gauge("shared").set(self.shared())
        _pool_gauge("retained").set(self.retained())

    # ---- allocator ----
    def _evict_retained(self, n: int) -> int:
        """Reclaim up to `n` retained pages, LRU-first, dropping their
        index entries."""
        evicted = 0
        while evicted < n and self._retained:
            page, key = self._retained.popitem(last=False)
            self._prefix.pop(key, None)
            self._page_key.pop(page, None)
            self._free.append(page)
            evicted += 1
        if evicted and telemetry.enabled():
            _metrics.counter(
                "paddle_tpu_kv_prefix_evictions_total",
                "retained prefix pages reclaimed (LRU) to satisfy allocation",
            ).inc(evicted)
        return evicted

    def alloc(self, n: int, owner: Optional[int] = None) -> List[int]:
        """`owner` is the request id the pages are charged to (request-trace
        attribution only; the allocator itself is owner-blind)."""
        if n > len(self._free):
            self._evict_retained(n - len(self._free))
        if n > len(self._free):
            if telemetry.enabled():
                _metrics.counter(
                    "paddle_tpu_kv_pool_alloc_failures_total",
                    "paged KV pool allocations refused for lack of free pages",
                ).inc()
            if _rt.enabled():
                _rt.record_event("kv_pool", "alloc_failure", rid=owner, n=n, free=len(self._free))
            raise PoolExhausted(
                f"paged KV pool exhausted: want {n} pages, {self.available()} "
                f"reclaimable of {self.num_blocks - 1}"
            )
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        if telemetry.enabled():
            _metrics.counter("paddle_tpu_kv_pool_allocs_total",
                             "paged KV pool pages handed out").inc(n)
            self._sync_gauges()
        if _rt.enabled():
            # used-after rides every event: the occupancy-over-time curve
            _rt.record_event("kv_pool", "alloc", rid=owner, n=n, used=self.used())
        return out

    def share(self, pages: Sequence[int], owner: Optional[int] = None) -> None:
        """One more reference on resident pages; retained ones revive."""
        for p in pages:
            p = int(p)
            if p == TRASH_PAGE:
                raise ValueError("page 0 is reserved and never shared")
            if p in self._refs:
                self._refs[p] += 1
            elif p in self._retained:
                self._retained.pop(p)
                self._refs[p] = 1
            else:
                raise ValueError(f"share of page {p} that is not resident")
        if telemetry.enabled() and pages:
            self._sync_gauges()
        if _rt.enabled() and pages:
            _rt.record_event("kv_pool", "share", rid=owner, n=len(pages), used=self.used())

    def free(self, pages: Sequence[int], owner: Optional[int] = None,
             retain: bool = True) -> None:
        """Drop one reference per page. At refcount zero an indexed page is
        retained when `retain` (completion), else (preemption) its index
        entry drops and it returns to the free list."""
        for p in pages:
            p = int(p)
            if p == TRASH_PAGE:
                raise ValueError("page 0 is reserved and never allocated")
            ref = self._refs.get(p)
            if ref is None:
                raise ValueError(f"double free of page {p}")
            if ref > 1:
                # another holder keeps the page and its index entry valid
                self._refs[p] = ref - 1
                continue
            del self._refs[p]
            key = self._page_key.get(p)
            if retain and key is not None:
                self._retained[p] = key  # MRU end
            else:
                if key is not None:
                    self._page_key.pop(p, None)
                    self._prefix.pop(key, None)
                self._free.append(p)
        if telemetry.enabled() and pages:
            _metrics.counter("paddle_tpu_kv_pool_frees_total",
                             "paged KV pool pages returned").inc(len(pages))
            self._sync_gauges()
        if _rt.enabled() and pages:
            _rt.record_event("kv_pool", "free", rid=owner, n=len(pages), used=self.used())

    def reset(self) -> None:
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._refs.clear()
        self._retained.clear()
        self._prefix.clear()
        self._page_key.clear()
        if telemetry.enabled():
            self._sync_gauges()

    def note_fragmentation(self, active_tokens: int) -> None:
        """Internal fragmentation: allocated slots minus live tokens."""
        if telemetry.enabled():
            _metrics.gauge(
                "paddle_tpu_kv_pool_frag_slots",
                "allocated-but-unwritten KV slots (internal fragmentation)",
            ).set(self.used() * self.block_size - int(active_tokens))

    # ---- prefix index ----
    def register_prefix(self, key: bytes, page: int) -> bool:
        """Publish a FULL, committed, held page under its chain key; the
        first registration of a key wins."""
        page = int(page)
        if page == TRASH_PAGE:
            raise ValueError("page 0 is reserved and never enters the prefix index")
        if page not in self._refs:
            raise ValueError(f"page {page} is not actively held — only live pages register")
        if key in self._prefix or page in self._page_key:
            return False
        self._prefix[key] = page
        self._page_key[page] = key
        return True

    def acquire_prefix(self, keys: Sequence[bytes], owner: Optional[int] = None) -> List[int]:
        """Longest resident prefix of `keys`, each page shared; may be [].
        Counts hit/miss lookups and cached tokens."""
        pages: List[int] = []
        for key in keys:
            page = self._prefix.get(key)
            if page is None or (page not in self._refs and page not in self._retained):
                break
            pages.append(page)
        if pages:
            self.share(pages, owner=owner)
        if telemetry.enabled():
            _prefix_counter("hit" if pages else "miss").inc()
            if pages:
                _metrics.counter(
                    "paddle_tpu_kv_prefix_cached_tokens_total",
                    "prompt tokens served from shared prefix pages instead of recomputed",
                ).inc(len(pages) * self.block_size)
        return pages

    def prefix_index_size(self) -> int:
        return len(self._prefix)

    def invalidate_prefix(self) -> int:
        """Drop every index entry and free the retained pages (after a
        weight swap the cached K/V is stale). Returns entries dropped."""
        n = len(self._prefix)
        self._prefix.clear()
        self._page_key.clear()
        while self._retained:
            page, _ = self._retained.popitem(last=False)
            self._free.append(page)
        if telemetry.enabled():
            if n:
                _metrics.counter(
                    "paddle_tpu_kv_prefix_invalidations_total",
                    "prefix-index entries dropped wholesale (weight swap)",
                ).inc(n)
            self._sync_gauges()
        return n

    def is_indexed(self, page: int) -> bool:
        return int(page) in self._page_key

    # ---- copy-on-write ----
    def make_private(self, page: int, owner: Optional[int] = None) -> int:
        """Clone `page` into a fresh exclusive page (K/V and scales on every
        layer) and drop the caller's reference on the original."""
        page = int(page)
        if page == TRASH_PAGE:
            raise ValueError("page 0 is reserved; writes there are scribbles")
        if page not in self._refs:
            raise ValueError(f"make_private of page {page} that is not held")
        (new,) = self.alloc(1, owner=owner)
        with torch.inference_mode():
            for t in self._planes():
                t[new].copy_(t[page])
        # the clone is not index-shareable: its writes will diverge
        self.free([page], owner=owner, retain=True)
        self.cow_copies += 1
        if telemetry.enabled():
            _metrics.counter(
                "paddle_tpu_kv_pool_cow_copies_total",
                "shared pages cloned copy-on-write before a divergent write",
            ).inc()
        if _rt.enabled():
            _rt.record_event("kv_pool", "cow", rid=owner, src=page, dst=new, used=self.used())
        return new

    def _planes(self) -> List[torch.Tensor]:
        return self.k_pages + self.v_pages + (self.k_scales or []) + (self.v_scales or [])

    # ---- device views ----
    def view(self, block_tables, seq_lens, write_mask=None) -> PagedCacheView:
        return PagedCacheView(self.k_pages, self.v_pages, block_tables, seq_lens,
                              self.block_size, k_scales=self.k_scales, v_scales=self.v_scales,
                              write_mask=write_mask)

    def device_state(self) -> Dict[str, List[torch.Tensor]]:
        """The pool's page tensors as one dict (scale planes when
        quantized); steps update them in place, so this is a view."""
        state = {"k": list(self.k_pages), "v": list(self.v_pages)}
        if self.k_scales is not None:
            state["k_scale"] = list(self.k_scales)
            state["v_scale"] = list(self.v_scales)
        return state

    def adopt_state(self, state: Dict[str, List[torch.Tensor]]) -> None:
        self.adopt(state["k"], state["v"])
        if self.k_scales is not None:
            if "k_scale" not in state:
                raise ValueError("quantized pool state is missing scale planes")
            self.k_scales = list(state["k_scale"])
            self.v_scales = list(state["v_scale"])

    def adopt(self, k_pages: Sequence[torch.Tensor], v_pages: Sequence[torch.Tensor]) -> None:
        """Install page tensors into the pool."""
        if len(k_pages) != self.num_layers or len(v_pages) != self.num_layers:
            raise ValueError("page-array layer count does not match the pool")
        self.k_pages = list(k_pages)
        self.v_pages = list(v_pages)

    def padded_table(self, pages: Sequence[int], n_cols: int) -> List[int]:
        """One sequence's block-table row padded with the trash page."""
        row = list(pages)[:n_cols]
        return row + [TRASH_PAGE] * (n_cols - len(row))


# ---------------------------------------------------------------------------
# cross-pool page migration (the disaggregated fleet's prefill -> decode
# handoff), through the host as in the JAX package: gather the pages, re-
# encode for the destination's kv_dtype, CRC every page, scatter. The
# receiver re-exports what landed and compares CRCs before it commits.
# ---------------------------------------------------------------------------

_PAYLOAD_KEYS = ("k", "v", "k_scale", "v_scale")


def _host(t: torch.Tensor) -> np.ndarray:
    """A plane on the host: bf16 as its 16-bit patterns (np.uint16)."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _plane_dtype(arr: np.ndarray, stated: Optional[str]) -> torch.dtype:
    """The torch dtype a payload plane holds: bf16 when the payload says so
    (16-bit patterns) or the array is an ml_dtypes.bfloat16 one."""
    if arr.dtype.name == "bfloat16" or (stated == "bfloat16" and arr.dtype == np.uint16):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, arr.dtype)).dtype


def _device_plane(arr: np.ndarray, stated: Optional[str]) -> torch.Tensor:
    """A payload plane as a CPU torch tensor of the dtype it holds."""
    if _plane_dtype(arr, stated) == torch.bfloat16:
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def export_pages(pool: BlockPool, pages: Sequence[int]) -> Dict:
    """Gather `pages`' K/V (plus scale planes on a quantized pool) into a
    host payload; entry j of every plane is the content of pages[j]."""
    idx = torch.as_tensor(list(pages), dtype=torch.long, device=pool.device)
    with torch.inference_mode():
        payload: Dict = {
            "kv_dtype": pool.kv_dtype,
            "dtype": str(pool.dtype).replace("torch.", ""),
            "k": [_host(a.index_select(0, idx)) for a in pool.k_pages],
            "v": [_host(a.index_select(0, idx)) for a in pool.v_pages],
        }
        if pool.quantized:
            payload["k_scale"] = [_host(a.index_select(0, idx)) for a in pool.k_scales]
            payload["v_scale"] = [_host(a.index_select(0, idx)) for a in pool.v_scales]
    return payload


def convert_payload(payload: Dict, kv_dtype: Optional[str]) -> Dict:
    """Re-encode a payload for a pool storing `kv_dtype`. Unquantized ->
    int8 quantizes every slot with the absmax rule the destination's own
    writes use, so the pages are byte-identical to what it would have
    written; int8 -> unquantized is refused (lossy: recompute instead)."""
    src = payload["kv_dtype"]
    if src == kv_dtype:
        return payload
    if src is None and kv_dtype == "int8":
        out: Dict = {"kv_dtype": "int8", "dtype": "int8", "k": [], "v": [], "k_scale": [],
                     "v_scale": []}
        stated = payload.get("dtype")
        for plane, scale_key in (("k", "k_scale"), ("v", "v_scale")):
            for arr in payload[plane]:
                x = _device_plane(arr, stated)
                sc = absmax_scale(x, dim=-1)  # [n, bs, Hkv] f32
                out[plane].append(quantize_absmax(x, sc[..., None]).numpy())
                out[scale_key].append(sc.numpy())
        return out
    raise ValueError(
        f"unsupported KV migration {src!r} -> {kv_dtype!r} "
        "(int8 pages cannot re-expand losslessly; recompute instead)")


def payload_page_crcs(payload: Dict) -> List[int]:
    """Per-page CRC32 over every byte the payload writes (K, V and scale
    planes across all layers)."""
    n = payload["k"][0].shape[0] if payload["k"] else 0
    crcs: List[int] = []
    for j in range(n):
        c = 0
        for key in _PAYLOAD_KEYS:
            for arr in payload.get(key) or ():
                c = zlib.crc32(np.ascontiguousarray(arr[j]).tobytes(), c)
        crcs.append(c)
    return crcs


def import_pages(pool: BlockPool, pages: Sequence[int], payload: Dict) -> None:
    """Scatter a (converted) payload into already-allocated `pages` of
    `pool`; its kv_dtype must be the pool's (convert first)."""
    if payload["kv_dtype"] != pool.kv_dtype:
        raise ValueError(
            f"payload kv_dtype {payload['kv_dtype']!r} does not match the destination pool's "
            f"{pool.kv_dtype!r} — convert_payload first")
    idx = torch.as_tensor(list(pages), dtype=torch.long, device=pool.device)
    stated = payload.get("dtype")
    planes = [(pool.k_pages, "k", pool.dtype), (pool.v_pages, "v", pool.dtype)]
    if pool.quantized:
        planes += [(pool.k_scales, "k_scale", torch.float32),
                   (pool.v_scales, "v_scale", torch.float32)]
    with torch.inference_mode():
        for dst, key, dt in planes:
            for layer in range(pool.num_layers):
                src = _device_plane(payload[key][layer], stated if key in ("k", "v") else None)
                dst[layer].index_copy_(0, idx, src.to(device=pool.device, dtype=dt))


def corrupt_payload(payload: Dict, seed=0) -> Dict:
    """Flip ONE deterministic byte of the payload's first K plane in place
    (a torn transfer); x ^ 0xFF never equals x, so the readback CRC must
    catch it."""
    rng = random.Random(seed)
    arr = np.ascontiguousarray(payload["k"][0])
    raw = bytearray(arr.tobytes())
    pos = rng.randrange(len(raw))
    raw[pos] ^= 0xFF
    payload["k"][0] = np.frombuffer(bytes(raw), dtype=arr.dtype).reshape(arr.shape)
    return payload
