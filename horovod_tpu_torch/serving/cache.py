"""Paged KV cache: the device page pool and its host-side allocator.

Counterpart of the paged half of ``horovod_tpu/serving/cache.py``.  K/V
live in a pool of fixed-size pages (PagedAttention, Kwon et al., SOSP
2023); each slot owns an int32 page-table row that the decode tick
resolves on the device, so the live set and the allocation pattern are
data.  Physical page 0 is the reserved NULL page: never granted, the
target of inactive rows' writes and of bucket-padding positions.

Freed pages are not scrubbed: a page's next owner writes every position
before first attending it (prefill landing covers the prompt; decode
writes position ``p`` in the tick that first attends it).

The pool is updated in place (the JAX package returns a new pool and
donates the old one).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.serving.graph import upload
from horovod_tpu_torch.serving.scheduler import CacheOutOfPagesError

__all__ = ["NULL_PAGE", "PagedSlotCache", "init_page_pool", "paged_insert",
           "resolve_kv_dtype"]

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
                   page_size: int, kv_dtype=None, *, device=None) -> Dict:
    """``k``/``v`` ``(L, P, H_kv, page, Dh)`` page pools (``P`` counts
    the NULL page), per-slot ``pos`` ``(S,)`` int32, and for int8
    storage ``k_scale``/``v_scale`` ``(L, P, H_kv, page)`` f32."""
    device = T.resolve_device(device)
    dt, quant = resolve_kv_dtype(cfg, kv_dtype)
    shape = (cfg.n_layers, n_pages, cfg.kv_heads, page_size, cfg.head_dim)
    pool = {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }
    if quant:
        for name in ("k_scale", "v_scale"):
            pool[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device)
    return pool


def paged_insert(pool: Dict, slots, new_pos, phys, off, prefilled_k,
                 prefilled_v) -> Dict:
    """Land a prefilled K/V block ``(L, K, H_kv, Tb, Dh)`` in pages, in
    place: position ``t`` of row ``i`` goes to ``(page phys[i, t],
    offset off[i, t])``; bucket padding points at the NULL page, where
    duplicate targets are harmless because nothing attends it.  ``slots``
    adopt ``new_pos``.  int8 pools quantize per vector on the way in."""
    k, v = prefilled_k, prefilled_v
    if "k_scale" in pool:
        qk, sk = T.kv_quantize(k)
        qv, sv = T.kv_quantize(v)
        pool["k"][:, phys, :, off] = qk.permute(1, 3, 0, 2, 4)
        pool["v"][:, phys, :, off] = qv.permute(1, 3, 0, 2, 4)
        pool["k_scale"][:, phys, :, off] = sk.permute(1, 3, 0, 2)
        pool["v_scale"][:, phys, :, off] = sv.permute(1, 3, 0, 2)
    else:
        dt = pool["k"].dtype
        pool["k"][:, phys, :, off] = k.to(dt).permute(1, 3, 0, 2, 4)
        pool["v"][:, phys, :, off] = v.to(dt).permute(1, 3, 0, 2, 4)
    pool["pos"][slots] = new_pos.to(torch.int32)
    return pool


class PagedSlotCache:
    """Host-side page allocator + slot bookkeeping over one device page
    pool: per-slot page tables (:attr:`table`, uploaded as tick data;
    :attr:`table_version` bumps on every change so the engine uploads
    only then), a heap of free pages, and refcounts (a page returns to
    the heap when its count reaches 0)."""

    def __init__(self, cfg: T.TransformerConfig, n_slots: int,
                 max_len: int = 0, *, page_size: int = 16,
                 n_pages: int = 0, kv_dtype=None, device=None):
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
        self.cache = init_page_pool(cfg, n_slots, self.n_pages + 1,
                                    page_size, kv_dtype, device=self.device)
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
        """Host-side reset of slots and pages (the failure path)."""
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

    # -- pages --------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def pages_high_water(self) -> int:
        """Most pages ever simultaneously allocated."""
        return self.n_pages - self._min_free

    @property
    def bytes_per_token(self) -> int:
        """KV bytes one token costs: k+v payload across layers, plus the
        per-vector scales for int8."""
        elem = torch.empty((), dtype=self._storage_dtype).element_size()
        n = self.cfg.n_layers * self.cfg.kv_heads
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

    # -- device ops ---------------------------------------------------------

    def _phys_off(self, rows: Sequence[Sequence[int]], true_lens,
                  bucket: int):
        """Host-built landing indices: position ``t`` of row ``i`` maps
        through its page table unless past ``true_lens[i]`` (bucket
        padding), which routes to the NULL page."""
        ps = self.page_size
        logical = np.arange(bucket)
        idxs = np.clip(logical // ps, 0, self.max_pages - 1)
        phys = np.zeros((len(rows), bucket), np.int64)
        for i, row in enumerate(rows):
            p = np.asarray(row, np.int64)[idxs]
            phys[i] = np.where(logical < int(true_lens[i]), p, NULL_PAGE)
        off = np.broadcast_to(logical % ps, phys.shape)
        return phys, off

    def land(self, slots: Sequence[int], prefilled: Dict, true_lens) -> None:
        """Land a prefilled K/V block into the slots' granted pages with
        one scatter and adopt the per-row positions (the indices go up
        through pinned memory: no wait for the device)."""
        for s in slots:
            if not self._active[s]:
                raise ValueError(f"slot {s} is not allocated")
        bucket = prefilled["k"].shape[3]
        phys, off = self._phys_off([self.table[s] for s in slots],
                                   true_lens, bucket)
        dev = self.device
        paged_insert(self.cache, upload(np.asarray(slots, np.int64), dev),
                     upload(np.asarray(true_lens, np.int64), dev),
                     upload(phys, dev), upload(np.array(off), dev),
                     prefilled["k"], prefilled["v"])
