"""KV caches for continuous batching: the slot-contiguous cache and the
paged one, each a device cache with its host-side allocator.

Counterpart of ``horovod_tpu/serving/cache.py``.  The slot-contiguous
cache (:class:`SlotCache`, the engine's ``paged=False``, the A/B
baseline) is the transformer's static cache with ``batch = S`` and a
per-slot ``pos``: every slot reserves ``max_len`` positions, admission
lands a prefilled block at position 0 of its slot
(:func:`insert_prefill_batch`) and the decode tick writes each slot at
its own position.  In the paged cache K/V
live in a pool of fixed-size pages (PagedAttention, Kwon et al., SOSP
2023); each slot owns an int32 page-table row that the decode tick
resolves on the device, so the live set and the allocation pattern are
data.  Physical page 0 is the reserved NULL page: never granted, the
target of inactive rows' writes and of bucket-padding positions.

Pages are refcounted for prefix sharing: a registered prefix's pages are
pinned by the engine (:meth:`PagedSlotCache.grant_raw`) and attached to
every slot whose prompt starts with it (:meth:`PagedSlotCache.attach`);
a slot about to write into a shared page first copies it
(:meth:`PagedSlotCache.cow`).

Freed pages are not scrubbed: a page's next owner writes every position
before first attending it (prefill landing covers the prompt; decode
writes position ``p`` in the tick that first attends it).

Both caches are updated in place (the JAX package returns a new cache
and donates the old one): the captured decode tick and the captured
admission graphs read them by address, so no operation here rebinds a
cache tensor, the copy-on-write and the restart's reset included.
Landing is split for the graphs: :meth:`PagedSlotCache.landing` builds
the indices on the host, and :func:`paged_insert` (inside a graph, or
:meth:`PagedSlotCache.land` eagerly) scatters the block.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.serving.graph import upload
from horovod_tpu_torch.serving.scheduler import CacheOutOfPagesError

__all__ = ["NULL_PAGE", "PagedSlotCache", "SlotCache", "copy_page",
           "gather_prefix_pages", "init_page_pool", "init_slot_cache",
           "insert_prefill", "insert_prefill_batch", "pad_pages",
           "paged_insert", "resolve_kv_dtype"]


# --- the slot-contiguous layout ----------------------------------------------


def init_slot_cache(cfg: T.TransformerConfig, n_slots: int,
                    max_len: int = 0, *, device=None) -> Dict:
    """``k``/``v`` ``(L, S, H_kv, T, Dh)`` in ``cfg.dtype``, as
    :func:`~horovod_tpu_torch.models.transformer.init_cache` lays them out
    for ``batch = S``, and ``pos`` ``(S,)`` int32: one write position a
    slot."""
    base = T.init_cache(cfg, n_slots, max_len, device=device)
    return {"k": base["k"], "v": base["v"],
            "pos": torch.zeros((n_slots,), dtype=torch.int32,
                               device=base["k"].device)}


def insert_prefill(cache: Dict, slot, prefilled: Dict) -> Dict:
    """Land a batch-1 prefilled cache (``k``/``v`` ``(L, 1, H_kv, T_pre,
    Dh)``, ``T_pre <= T``, a scalar ``pos``) at position 0 of slot
    ``slot``, in place, and adopt its position."""
    t_pre = prefilled["k"].shape[3]
    cache["k"][:, slot, :, :t_pre] = prefilled["k"][:, 0].to(cache["k"].dtype)
    cache["v"][:, slot, :, :t_pre] = prefilled["v"][:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = torch.as_tensor(prefilled["pos"], dtype=torch.int32)
    return cache


def insert_prefill_batch(cache: Dict, slots, prefilled: Dict) -> Dict:
    """Land a batch-K prefilled cache (per-row ``true_len``: ``k``/``v``
    ``(L, K, H_kv, T_pre, Dh)``, ``pos`` ``(K,)``) in K slots with one
    scatter a tensor, in place: row ``i`` lands at position 0 of slot
    ``slots[i]`` (a ``(K,)`` index tensor, or a sequence) and the slot
    adopts ``pos[i]``."""
    slots = torch.as_tensor(slots, dtype=torch.long,
                            device=cache["k"].device)
    t_pre = prefilled["k"].shape[3]
    cache["k"][:, slots, :, :t_pre] = prefilled["k"].to(cache["k"].dtype)
    cache["v"][:, slots, :, :t_pre] = prefilled["v"].to(cache["v"].dtype)
    cache["pos"][slots] = torch.as_tensor(
        prefilled["pos"], device=slots.device).to(torch.int32)
    return cache


class SlotCache:
    """Host-side slot allocator over one device slot cache
    (:attr:`cache`, :func:`init_slot_cache`): slots are handed out
    lowest index first (a heap), freed at retirement, and exported as the
    tick's ``(S,)`` active mask.  A freed slot is not scrubbed: decode
    writes position ``p`` in the tick that first attends it, so a
    previous tenant's K/V is overwritten before the next one can read
    it."""

    def __init__(self, cfg: T.TransformerConfig, n_slots: int,
                 max_len: int = 0, *, device=None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.cfg = cfg
        self.device = T.resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len or cfg.max_seq
        self.cache = init_slot_cache(cfg, n_slots, self.max_len,
                                     device=self.device)
        self._active = np.zeros(n_slots, bool)
        self._free: List[int] = list(range(n_slots))  # heap (sorted)

    # -- allocation ---------------------------------------------------------

    def alloc(self) -> Optional[int]:
        """Lowest free slot index, or None when every slot is busy."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._active[slot] = True
        return slot

    def free(self, slot: int) -> None:
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self._active[slot] = False
        heapq.heappush(self._free, slot)

    def release_all(self) -> None:
        """Host-side reset: every slot freed, the device K/V left where
        it is (write before attend makes scrubbing unnecessary)."""
        self._active[:] = False
        self._free = list(range(self.n_slots))

    def reset(self) -> None:
        """A fresh cache in place (the supervised restart): the host
        reset of :meth:`release_all`, then K/V and positions zeroed where
        they lie, so the captured tick and admission graphs keep reading
        the tensors they captured."""
        self.release_all()
        for t in self.cache.values():
            t.zero_()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def occupancy(self) -> float:
        return self.active_count / self.n_slots

    def active_mask(self) -> np.ndarray:
        """(S,) bool — a copy."""
        return self._active.copy()

    def positions(self) -> np.ndarray:
        """Each slot's device write position (a host sync)."""
        return self.cache["pos"].cpu().numpy()

    # -- device ops ---------------------------------------------------------

    def insert(self, slot: int, prefilled: Dict) -> None:
        """Write a batch-1 prefilled cache into allocated ``slot`` and
        adopt its position."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        insert_prefill(self.cache, slot, prefilled)

    def insert_batch(self, slots: Sequence[int], prefilled: Dict) -> None:
        """Write a batch-K prefilled cache into K allocated slots, row
        ``i`` into ``slots[i]``, with one scatter a tensor."""
        for s in slots:
            if not self._active[s]:
                raise ValueError(f"slot {s} is not allocated")
        insert_prefill_batch(
            self.cache, upload(np.asarray(slots, np.int64), self.device),
            prefilled)


# --- the paged layout --------------------------------------------------------


NULL_PAGE = 0

_KV_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
              "f32": torch.float32, "float32": torch.float32,
              "int8": torch.int8}


def resolve_kv_dtype(cfg: T.TransformerConfig, kv_dtype):
    """``(storage dtype, quantized?)`` for a ``kv_dtype`` spec: None =
    the model's dtype, "bf16"/"f32", or "int8" (per-vector scales ride
    alongside, dequantized on attend)."""
    if kv_dtype is None:
        return cfg.dtype, False
    if isinstance(kv_dtype, str):
        if kv_dtype not in _KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected "
                             f"one of {sorted(_KV_DTYPES)} or None")
        kv_dtype = _KV_DTYPES[kv_dtype]
    return kv_dtype, kv_dtype == torch.int8


def init_page_pool(cfg: T.TransformerConfig, n_slots: int, n_pages: int,
                   page_size: int, kv_dtype=None, *, device=None,
                   sharding=None) -> Dict:
    """``k``/``v`` ``(L, P, H_kv, page, Dh)`` page pools (``P`` counts
    the NULL page), per-slot ``pos`` ``(S,)`` int32, and for int8
    storage ``k_scale``/``v_scale`` ``(L, P, H_kv, page)`` f32.  With a
    tp ``sharding`` (:class:`~horovod_tpu_torch.serving.sharding.
    ServingSharding`) the payload and scales are lists, one pool a local
    shard at its ``H_kv / tp`` heads, each its own contiguous storage
    (K4 refuses a strided pool); ``pos`` is shared."""
    device = T.resolve_device(device)
    dt, quant = resolve_kv_dtype(cfg, kv_dtype)
    heads = ([cfg.kv_heads] if sharding is None
             else sharding.local_sizes(cfg.kv_heads))

    def zeros(hkv, dtype, scale=False):
        shape = (cfg.n_layers, n_pages, hkv, page_size, cfg.head_dim)
        return torch.zeros(shape[:-1] if scale else shape, dtype=dtype,
                           device=device)

    names = [("k", dt, False), ("v", dt, False)]
    if quant:
        names += [("k_scale", torch.float32, True),
                  ("v_scale", torch.float32, True)]
    pool = {}
    for name, dtype, scale in names:
        ts = [zeros(h, dtype, scale) for h in heads]
        pool[name] = ts if sharding is not None else ts[0]
    pool["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    return pool


def _listed(x) -> list:
    """A pool entry as its list of local shards (an unsharded pool's
    tensor is its one shard)."""
    return x if isinstance(x, list) else [x]


def _pool_tensors(pool: Dict) -> list:
    """Every tensor of a pool or cache, shards included."""
    return [t for v in pool.values() if torch.is_tensor(v) or
            isinstance(v, list) for t in _listed(v)]


def paged_insert(pool: Dict, slots, new_pos, phys, off, prefilled_k,
                 prefilled_v) -> Dict:
    """Land a prefilled K/V block ``(L, K, H_kv, Tb, Dh)`` in pages, in
    place: position ``t`` of row ``i`` goes to ``(page phys[i, t],
    offset off[i, t])``; bucket padding points at the NULL page, where
    duplicate targets are harmless because nothing attends it.  ``slots``
    adopt ``new_pos`` (``slots`` None for a slotless landing, prefix
    registration).  int8 pools quantize per vector on the way in.  A
    sharded pool takes a block a local shard (lists), each landing in its
    own shard."""
    quant = "k_scale" in pool
    for i, (k, v) in enumerate(zip(_listed(prefilled_k),
                                   _listed(prefilled_v))):
        sp = {n: _listed(t)[i] for n, t in pool.items() if n != "pos"}
        if quant:
            qk, sk = T.kv_quantize(k)
            qv, sv = T.kv_quantize(v)
            sp["k"][:, phys, :, off] = qk.permute(1, 3, 0, 2, 4)
            sp["v"][:, phys, :, off] = qv.permute(1, 3, 0, 2, 4)
            sp["k_scale"][:, phys, :, off] = sk.permute(1, 3, 0, 2)
            sp["v_scale"][:, phys, :, off] = sv.permute(1, 3, 0, 2)
        else:
            dt = sp["k"].dtype
            sp["k"][:, phys, :, off] = k.to(dt).permute(1, 3, 0, 2, 4)
            sp["v"][:, phys, :, off] = v.to(dt).permute(1, 3, 0, 2, 4)
    if slots is not None:
        pool["pos"][slots] = new_pos.to(torch.int32)
    return pool


def copy_page(pool: Dict, src: int, dst: int) -> None:
    """Copy one physical page (every layer, payload and scales, every
    local shard) inside the pool tensors: the copy-on-write primitive,
    enqueued on the current stream like the tick that reads the
    result."""
    for name in ("k", "v", "k_scale", "v_scale"):
        for t in _listed(pool.get(name, [])):
            t[:, dst].copy_(t[:, src])


def pad_pages(pages: Sequence[int]) -> List[int]:
    """A prefix's page ids NULL-padded to a power-of-two count (the JAX
    engine's ``_gather_landed``): the gather and the suffix prefill then
    meet a bounded set of page counts, one CUDA graph per count serving
    every prefix length that fits it.  The padding's positions lie past
    the prefix length and are never attended."""
    n = 1
    while n < len(pages):
        n *= 2
    return [int(p) for p in pages] + [NULL_PAGE] * (n - len(pages))


def gather_prefix_pages(pool: Dict, pages):
    """``pages`` (an ``(n,)`` index tensor) as contiguous ``(k, v)`` of
    shape ``(L, H_kv, n * page, Dh)``: the shared-prefix K/V handed to
    :func:`~horovod_tpu_torch.models.transformer.prefill_with_prefix`.
    int8 pools dequantize here, to f32.  A sharded pool gives lists, a
    pair a local shard."""
    if isinstance(pool["k"], list):  # a sharded pool: a pair a shard
        ks, vs = zip(*(gather_prefix_pages(sp, pages)
                       for sp in T._local(pool, len(pool["k"]))))
        return list(ks), list(vs)
    k = pool["k"][:, pages]                   # (L, n, H_kv, ps, Dh)
    v = pool["v"][:, pages]
    L, n, Hkv, ps, Dh = k.shape
    k = k.movedim(1, 2).reshape(L, Hkv, n * ps, Dh)
    v = v.movedim(1, 2).reshape(L, Hkv, n * ps, Dh)
    if "k_scale" in pool:
        ks = pool["k_scale"][:, pages].movedim(1, 2).reshape(L, Hkv, n * ps)
        vs = pool["v_scale"][:, pages].movedim(1, 2).reshape(L, Hkv, n * ps)
        k = T.kv_dequantize(k, ks, torch.float32)
        v = T.kv_dequantize(v, vs, torch.float32)
    return k, v


class PagedSlotCache:
    """Host-side page allocator + slot bookkeeping over one device page
    pool: per-slot page tables (:attr:`table`, uploaded as tick data;
    :attr:`table_version` bumps on every change so the engine uploads
    only then), a heap of free pages, refcounts (a page returns to the
    heap when its count reaches 0) for prefix sharing (:meth:`attach`,
    :meth:`grant_raw`), and copy-on-write (:meth:`cow`), so that a
    shared page is copied only when a slot must write into it."""

    def __init__(self, cfg: T.TransformerConfig, n_slots: int,
                 max_len: int = 0, *, page_size: int = 16,
                 n_pages: int = 0, kv_dtype=None, device=None,
                 sharding=None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.cfg = cfg
        self.device = T.resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len or cfg.max_seq
        self.page_size = page_size
        self.max_pages = -(-self.max_len // page_size)
        # 0 = capacity parity: every slot can grow to max_len.
        self.n_pages = n_pages or n_slots * self.max_pages
        self._storage_dtype, self.quantized = resolve_kv_dtype(cfg, kv_dtype)
        # Tensor-parallel serving: the pool is split by kv head into this
        # process's shards; everything host-side here (tables, grants,
        # refcounts, copy-on-write) is the same, since pages are split
        # by head, never by page id.
        self.sharding = sharding
        self.cache = init_page_pool(cfg, n_slots, self.n_pages + 1,
                                    page_size, kv_dtype, device=self.device,
                                    sharding=sharding)
        self.table = np.zeros((n_slots, self.max_pages), np.int32)
        self.table_version = 0
        self._ref = np.zeros(self.n_pages + 1, np.int64)
        self._ref[NULL_PAGE] = 1  # never granted
        self._free_pages: List[int] = list(range(1, self.n_pages + 1))
        self._min_free = self.n_pages
        self._active = np.zeros(n_slots, bool)
        self._free: List[int] = list(range(n_slots))  # heap (sorted)

    # -- slots --------------------------------------------------------------

    def alloc(self) -> Optional[int]:
        """Lowest free slot index, or None when every slot is busy."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._active[slot] = True
        return slot

    def acquire(self, slot: int) -> None:
        """Mark a given slot active: a draft model's pool mirrors the
        target pool slot for slot (same ids, same retirement), so its
        allocator follows the target's choice instead of making its own.
        :meth:`free` releases it as usual."""
        if self._active[slot]:
            raise ValueError(f"slot {slot} is already active")
        self._free.remove(slot)
        heapq.heapify(self._free)
        self._active[slot] = True

    def free(self, slot: int) -> None:
        """Retire a slot: every page its table references is
        dereferenced."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self._active[slot] = False
        heapq.heappush(self._free, slot)
        for pg in self.table[slot]:
            self._decref(int(pg))
        self.table[slot, :] = NULL_PAGE
        self.table_version += 1

    def release_all(self) -> None:
        """Host-side reset of slots and pages (the failure path).  The
        prefix registry's pins die with it: the engine invalidates its
        registry whenever it resets the cache."""
        self._active[:] = False
        self._free = list(range(self.n_slots))
        self.table[:, :] = NULL_PAGE
        self.table_version += 1
        self._ref[:] = 0
        self._ref[NULL_PAGE] = 1
        self._free_pages = list(range(1, self.n_pages + 1))

    def reset(self) -> None:
        """A fresh cache in place (the supervised restart): the host
        reset of :meth:`release_all`, then every pool tensor zeroed
        where it lies.  The JAX engine builds a new cache instead; here
        the captured decode tick reads the pool by address, so the
        tensors must stay the ones it captured.  The zeroing is enqueued
        on the current stream, behind any tick still in flight."""
        self.release_all()
        for t in _pool_tensors(self.cache):
            t.zero_()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def occupancy(self) -> float:
        return self.active_count / self.n_slots

    def active_mask(self) -> np.ndarray:
        """(S,) bool — a copy."""
        return self._active.copy()

    # -- pages --------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def pages_shared(self) -> int:
        """Pages referenced more than once (prefix sharing in effect)."""
        return int((self._ref[1:] > 1).sum())

    @property
    def pages_high_water(self) -> int:
        """Most pages ever simultaneously allocated."""
        return self.n_pages - self._min_free

    @property
    def bytes_per_token(self) -> int:
        """KV bytes one token costs in this process's pool: k+v payload
        across layers and the local kv heads (all of them unless the pool
        is tp-sharded), plus the per-vector scales for int8."""
        elem = torch.empty((), dtype=self._storage_dtype).element_size()
        heads = (self.cfg.kv_heads if self.sharding is None
                 else sum(self.sharding.local_sizes(self.cfg.kv_heads)))
        n = self.cfg.n_layers * heads
        b = 2 * n * self.cfg.head_dim * elem
        if self.quantized:
            b += 2 * n * 4
        return b

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size) if n_tokens > 0 else 0

    def _pop_page(self) -> int:
        if not self._free_pages:
            raise CacheOutOfPagesError(
                f"page pool exhausted ({self.n_pages} pages)")
        pg = heapq.heappop(self._free_pages)
        self._min_free = min(self._min_free, len(self._free_pages))
        return pg

    def _decref(self, pg: int) -> None:
        if pg == NULL_PAGE:
            return
        self._ref[pg] -= 1
        if self._ref[pg] == 0:
            heapq.heappush(self._free_pages, pg)
        elif self._ref[pg] < 0:  # pragma: no cover - allocator invariant
            raise AssertionError(f"page {pg} refcount underflow")

    def grant(self, slot: int, idx: int) -> int:
        """Grant a fresh private page at table index ``idx``; raises
        :class:`CacheOutOfPagesError` on an empty pool."""
        if self.table[slot, idx] != NULL_PAGE:
            raise ValueError(
                f"slot {slot} already has page {self.table[slot, idx]} "
                f"at index {idx}")
        pg = self._pop_page()
        self._ref[pg] = 1
        self.table[slot, idx] = pg
        self.table_version += 1
        return pg

    def grant_raw(self, n: int) -> List[int]:
        """``n`` pages owned by the caller (the prefix registry's pin),
        refcount 1 each, bound to no slot.  All or nothing."""
        if len(self._free_pages) < n:
            raise CacheOutOfPagesError(
                f"need {n} pages for prefix registration, "
                f"{len(self._free_pages)} free of {self.n_pages}")
        pages = []
        for _ in range(n):
            pg = self._pop_page()
            self._ref[pg] = 1
            pages.append(pg)
        return pages

    def release_raw(self, pages: Sequence[int]) -> None:
        """Drop a :meth:`grant_raw` pin (prefix unregistration)."""
        for pg in pages:
            self._decref(int(pg))

    def attach(self, slot: int, pages: Sequence[int]) -> None:
        """Reference shared pages from table indices ``0..len-1``:
        prefix sharing, a refcount each, no copy."""
        for i, pg in enumerate(pages):
            if self.table[slot, i] != NULL_PAGE:
                raise ValueError(f"slot {slot} index {i} already mapped")
            self.table[slot, i] = pg
            self._ref[pg] += 1
        self.table_version += 1

    def cow(self, slot: int, idx: int) -> int:
        """Copy-on-write: make the page at table index ``idx`` private to
        ``slot``.  A no-op if it already is; otherwise a fresh page is
        granted, the shared page copied into it inside the pool tensors
        (:func:`copy_page`: no tensor is rebound, so the captured tick
        keeps its addresses), the table repointed and the shared page
        dereferenced.  Called before any write can target a shared page:
        a suffix landing in a prefix's partial last page, or decode
        growing into it."""
        src = int(self.table[slot, idx])
        if src == NULL_PAGE:
            raise ValueError(f"slot {slot} has no page at index {idx}")
        if self._ref[src] <= 1:
            return src
        dst = self._pop_page()
        self._ref[dst] = 1
        copy_page(self.cache, src, dst)
        self.table[slot, idx] = dst
        self._decref(src)
        self.table_version += 1
        return dst

    # -- device ops ---------------------------------------------------------

    def _phys_off(self, rows: Sequence[Sequence[int]], start: int,
                  true_lens, bucket: int):
        """Host-built landing indices: row ``i``'s position ``start + t``
        maps through its page table unless past ``start + true_lens[i]``
        (bucket padding), which routes to the NULL page."""
        ps = self.page_size
        logical = start + np.arange(bucket)
        idxs = np.clip(logical // ps, 0, self.max_pages - 1)
        phys = np.zeros((len(rows), bucket), np.int64)
        for i, row in enumerate(rows):
            p = np.asarray(row, np.int64)[idxs]
            phys[i] = np.where(logical < start + int(true_lens[i]), p,
                               NULL_PAGE)
        off = np.broadcast_to(logical % ps, phys.shape)
        return phys, off

    def landing(self, slots: Sequence[int], true_lens, start: int = 0, *,
                bucket: int):
        """Landing indices, built on the host, of a ``bucket``-wide block
        prefilled for ``slots`` -> ``(new_pos (K,), phys (K, bucket), off
        (K, bucket))`` int64: row ``i``'s column ``t`` is logical position
        ``start + t`` of its slot, through its page table, and the slot's
        position becomes ``start + true_lens[i]``.  ``start`` is 0 for
        whole prompts, the landed length for a suffix or a chunk.  The
        engine uploads them as a graph's static inputs; :meth:`land`
        scatters eagerly."""
        for s in slots:
            if not self._active[s]:
                raise ValueError(f"slot {s} is not allocated")
        phys, off = self._phys_off([self.table[s] for s in slots], start,
                                   true_lens, bucket)
        return start + np.asarray(true_lens, np.int64), phys, off

    def landing_raw(self, pages: Sequence[int], true_len: int, *,
                    bucket: int):
        """Slotless landing indices (prefix registration): the block
        fills ``pages`` in order -> ``(phys, off)``."""
        row = list(pages) + [NULL_PAGE] * max(0, self.max_pages - len(pages))
        return self._phys_off([row], 0, [true_len], bucket)

    def _insert(self, slots, new_pos, phys, off, prefilled: Dict) -> None:
        dev = self.device
        if slots is not None:
            slots = upload(np.asarray(slots, np.int64), dev)
            new_pos = upload(np.asarray(new_pos, np.int64), dev)
        paged_insert(self.cache, slots, new_pos, upload(phys, dev),
                     upload(np.array(off), dev), prefilled["k"],
                     prefilled["v"])

    def land(self, slots: Sequence[int], prefilled: Dict, true_lens,
             start: int = 0) -> None:
        """Land a prefilled (or suffix-prefilled) K/V block eagerly into
        the slots' granted pages with one scatter, and set each slot's
        position (:meth:`landing`).  The indices go up through pinned
        memory: no wait for the device."""
        new_pos, phys, off = self.landing(slots, true_lens, start,
                                          bucket=prefilled["k"].shape[3])
        self._insert(slots, new_pos, phys, off, prefilled)

    def land_raw(self, pages: Sequence[int], prefilled: Dict,
                 true_len: int) -> None:
        """Slotless eager landing into raw pages (:meth:`landing_raw`);
        no slot's position changes."""
        phys, off = self.landing_raw(pages, true_len,
                                     bucket=prefilled["k"].shape[3])
        self._insert(None, None, phys, off, prefilled)

    def set_pos(self, slots: Sequence[int], vals: Sequence[int]) -> None:
        """Set positions without landing anything (attach-only admission:
        the whole prompt already lies in shared pages)."""
        dev = self.device
        self.cache["pos"][upload(np.asarray(slots, np.int64), dev)] = \
            upload(np.asarray(vals, np.int32), dev)

    def gather_prefix(self, pages: Sequence[int]):
        """Contiguous ``(k, v)`` of ``pages`` (:func:`gather_prefix_pages`:
        ``(L, H_kv, len(pages) * page, Dh)``, f32 for an int8 pool)."""
        return gather_prefix_pages(
            self.cache, upload(np.asarray(pages, np.int64), self.device))
