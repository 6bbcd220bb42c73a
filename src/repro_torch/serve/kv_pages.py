"""Paged KV block pool: block-table-indexed cache memory for serving.

The port of the JAX package's ``serve/kv_pages.py``.  A shared pool of
fixed-size pages plus a per-slot *block table* replaces the dense per-slot
``(n_slots, max_seq)`` KV layout — the vLLM PagedAttention memory model.

* :class:`PagePool` — host-side allocator (numpy): LIFO free list, per-slot
  block tables, per-page refcounts, copy-on-write, ``version`` and
  ``stats()``; the same code as the reference, so both allocate alike.
* :class:`PagedBatchState` — the engine-facing device state: the model's
  "k"/"v" leaves re-laid-out as ``(L, n_pages, page_size, KV, D)`` pools
  (int8 / fp8 with ``(L, n_pages, KV)`` float32 scale siblings when
  quantized) and the device mirror of the block tables.  Leaves the model
  does not list in ``paged_cache_keys()`` stay dense slot rows: an SSM's
  state and conv window pool nothing, and its block tables serve the page
  accounting only, as in the reference.
* :func:`write_prefill_pages` — scatter a freshly prefilled sub-cache into
  the pages of each admitted slot's table row, in place.

Page 0 is the reserved **parking page**: it is never allocated, and every
unallocated or freed block-table entry points at it.  The decode kernel
therefore always reads a valid page (its keys lie past every slot's
position and are masked), and a *frozen* slot — finished on device but
still riding the decode loop — keeps re-writing its parked token through
its table into page 0, which no live request reads.

**Quantized pools** (``kv_dtype``): one absmax scale per (page, KV head).
Writers quantize (:func:`write_prefill_pages` per prefilled page;
``models.common.paged_cache_write_quant`` per decode token, widening the
page's scale monotonically); the decode kernel dequantizes after its load,
so device memory moves one byte per value.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.common import to_device, upload
from .batch_state import cache_bytes, slot_vectors

# kv_dtype name -> (storage dtype, qmax): int8 uses the full symmetric grid,
# fp8-e4m3 its max finite (448)
KV_DTYPES: Dict[str, Tuple[torch.dtype, float]] = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
}

# names that mean "store the compute dtype, no scales"
_UNQUANTIZED = (None, "none", "bf16", "fp16", "float32")


def resolve_kv_dtype(kv_dtype):
    """Map a ``kv_dtype`` name to ``(storage_dtype, qmax)`` or ``None`` for
    the unquantized path.  Raises on unknown names."""
    if kv_dtype in _UNQUANTIZED:
        return None
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected one of "
                         f"{sorted(KV_DTYPES)} or bf16/none")
    return KV_DTYPES[kv_dtype]


def kv_dtype_bytes(kv_dtype, dtype_bytes: int = 2) -> int:
    """Bytes per stored KV element under ``kv_dtype`` (``dtype_bytes`` for
    the unquantized path)."""
    info = resolve_kv_dtype(kv_dtype)
    return dtype_bytes if info is None else info[0].itemsize


def scale_key(key: str) -> str:
    """Name of the per-page scale leaf that travels with pool leaf ``key``
    through the cache dict."""
    return f"{key}_scale"


def quantize_to(x: torch.Tensor, scale: torch.Tensor, dtype,
                qmax: float) -> torch.Tensor:
    """Quantize ``x`` by broadcastable ``scale`` into ``dtype``.

    Integer targets round to nearest (ties to even, as ``jnp.round``) then
    clip to the symmetric grid; float8 targets clip to the max finite and
    let the cast round.
    """
    y = x.float() / scale
    if not dtype.is_floating_point:
        y = torch.round(y)
    return torch.clamp(y, -qmax, qmax).to(dtype)


class PagePool:
    """Host-side page allocator with per-slot block tables."""

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_blocks: int):
        if n_pages < 2 or page_size < 1:
            raise ValueError(f"bad pool geometry ({n_pages=}, {page_size=});"
                             f" need >= 2 pages (page 0 is parking)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.max_blocks = max_blocks
        # LIFO free list: freed pages are reused first (warm in cache);
        # page 0 is the reserved parking page and is never handed out
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        # per-page reference counts: 0 = free (or parking), 1 = exclusive
        # (writable), > 1 = shared read-only (slots + radix-tree nodes)
        self.refcounts = np.zeros(n_pages, np.int32)
        # unallocated entries hold the parking page
        self.tables = np.zeros((n_slots, max_blocks), np.int32)
        self.n_blocks = np.zeros(n_slots, np.int32)     # allocated per slot
        self.used_tokens = np.zeros(n_slots, np.int64)  # capacity actually
        #                                               # needed (frag stat)
        self._peak_allocated = 0    # high-water mark of allocated pages
        self.cow_copies = 0         # copy-on-write page copies resolved
        self.evictions = 0          # tree-only pages reclaimed by evictors
        # bumped whenever the block-table map changes (allocate / free /
        # CoW swap); device-table mirrors compare against it to skip
        # redundant host->device uploads.  Pure refcount motion (retain /
        # release of a page that stays mapped) does NOT bump it — the
        # tables are unchanged, so the dirty-flag fast path holds.
        self.version = 0

    # -- allocator --------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    def allocate(self, slot: int, n_tokens: int,
                 shared: Sequence[int] = ()) -> bool:
        """Reserve pages covering ``n_tokens`` positions for ``slot``.

        ``shared`` splices already-resident pages (a radix-cache prefix
        match) into the head of the slot's block table: each is retained
        (refcount + 1) instead of drawn from the free list, so only the
        uncached tail consumes fresh pages.  Returns False (allocating
        and retaining nothing) when the pool cannot cover the request —
        the caller defers admission.  A slot must be freed before it can
        be re-allocated.
        """
        if self.n_blocks[slot]:
            raise ValueError(f"slot {slot} already holds pages")
        need = max(-(-int(n_tokens) // self.page_size), 1)
        if need > self.max_blocks:
            raise ValueError(f"request needs {need} blocks > table width "
                             f"{self.max_blocks}")
        shared = [int(p) for p in shared]
        if len(shared) > need:
            raise ValueError(f"{len(shared)} shared pages exceed the "
                             f"request's {need}-page reservation")
        if len(set(shared)) != len(shared) \
                or any(not 0 < p < self.n_pages for p in shared):
            raise ValueError(f"bad shared page list {shared}")
        if any(self.refcounts[p] < 1 for p in shared):
            raise ValueError("shared pages must be live (refcount >= 1)")
        fresh = need - len(shared)
        if fresh > len(self._free):
            return False
        # all-or-nothing: the checks above ran before any refcount moved,
        # so a False return leaks no retains
        for p in shared:
            self.refcounts[p] += 1
        pages = shared + [self._free.pop() for _ in range(fresh)]
        for p in pages[len(shared):]:
            self.refcounts[p] = 1
        self.tables[slot, :need] = pages
        self.tables[slot, need:] = 0
        self.n_blocks[slot] = need
        self.used_tokens[slot] = int(n_tokens)
        self._peak_allocated = max(self._peak_allocated,
                                   self.n_pages - 1 - len(self._free))
        self.version += 1
        return True

    def free(self, slot: int) -> None:
        """Release a slot's pages: every refcount drops by one, and only
        pages nobody else holds (no other slot, no radix-tree node)
        return to the free list."""
        n = int(self.n_blocks[slot])
        if n == 0:
            raise ValueError(f"slot {slot} holds no pages")
        for p in self.tables[slot, :n]:
            self.release_page(int(p))
        self.tables[slot, :] = 0
        self.n_blocks[slot] = 0
        self.used_tokens[slot] = 0
        self.version += 1

    def retain_page(self, page: int) -> None:
        """Add a reference to a live page (radix-tree adoption).  Pure
        refcount motion: the block-table map is untouched, so ``version``
        stays put and device mirrors skip the re-upload."""
        if not 0 < page < self.n_pages:
            raise ValueError(f"page {page} out of range (parking page 0 "
                             f"is never retained)")
        if self.refcounts[page] < 1:
            raise ValueError(f"page {page} is free; retain needs a live "
                             f"page")
        self.refcounts[page] += 1

    def release_page(self, page: int) -> None:
        """Drop one reference; the page returns to the free list at zero.

        Releasing an already-free page raises — a double release (e.g.
        requeue-at-head backpressure replaying a partial splice) must
        fail loudly instead of planting a duplicate free-list entry that
        the allocator would later hand to two slots at once.
        """
        if not 0 < page < self.n_pages:
            raise ValueError(f"page {page} out of range")
        if self.refcounts[page] < 1:
            raise ValueError(f"double release of page {page} "
                             f"(refcount already 0)")
        self.refcounts[page] -= 1
        if self.refcounts[page] == 0:
            self._free.append(int(page))

    def evict_page(self, page: int) -> None:
        """Evictor entry point: reclaim a page only the radix tree still
        holds.  Refcount must be exactly 1 — evicting a page a slot is
        reading raises instead of yanking live KV."""
        if self.refcounts[page] != 1:
            raise ValueError(f"page {page} refcount "
                             f"{int(self.refcounts[page])}: only "
                             f"refcount-1 (tree-only) pages are evictable")
        self.release_page(page)
        self.evictions += 1

    def cow(self, slot: int, block: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write ``slot``'s ``block`` ahead of a divergent write.

        A shared page (refcount > 1) is swapped for a fresh exclusive
        one; returns ``(old, new)`` so the caller copies payload + scale
        rows on device.  An already-exclusive page returns None (write in
        place).  Raises when no free page is available — the caller
        evicts or defers.
        """
        if block >= int(self.n_blocks[slot]):
            raise ValueError(f"slot {slot} block {block} not allocated")
        old = int(self.tables[slot, block])
        if self.refcounts[old] <= 1:
            return None
        if not self._free:
            raise RuntimeError("copy-on-write needs a free page; evict or "
                               "defer the write")
        new = self._free.pop()
        self.refcounts[new] = 1
        self.refcounts[old] -= 1        # was > 1: never reaches zero here
        self.tables[slot, block] = new
        self.cow_copies += 1
        self._peak_allocated = max(self._peak_allocated,
                                   self.n_pages - 1 - len(self._free))
        self.version += 1
        return old, new

    # -- accounting -------------------------------------------------------
    def stats(self) -> Dict:
        """Occupancy + internal fragmentation (allocated-but-unneeded
        token capacity; pages are fixed-size, so there is no external
        fragmentation by construction).  ``allocated_pages`` counts
        *distinct* live pages (a shared prefix page counts once however
        many block tables map it); ``peak_allocated_pages`` is the
        lifetime high-water mark — the number capacity claims cite.
        ``shared_pages`` / ``cow_copies`` / ``evictions`` expose the
        prefix-cache life cycle: pages currently mapped by more than one
        holder, divergent writes resolved by page copy, and tree-only
        pages reclaimed under pool pressure."""
        allocated = self.n_pages - 1 - len(self._free)
        cap = allocated * self.page_size
        used = int(self.used_tokens.sum())
        frag = max(cap - used, 0)       # shared pages can push used > cap
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "allocated_pages": allocated, "free_pages": self.n_free,
                "peak_allocated_pages": self._peak_allocated,
                "used_tokens": used,
                "shared_pages": int((self.refcounts > 1).sum()),
                "cow_copies": self.cow_copies,
                "evictions": self.evictions,
                "internal_frag_tokens": frag,
                "internal_frag_frac": frag / cap if cap else 0.0}


class PagedBatchState:
    """Device-side state of the slot pool with paged KV leaves.

    Duck-types :class:`~repro_torch.serve.batch_state.BatchState` for the
    engine (``cache``, ``slot_vectors`` and its rows ``tokens`` / ``pos`` /
    ``remaining``, ``clear``),
    adding the page pool, the block tables' device mirror (a fixed
    ``(n_slots, max_blocks)`` tensor, rewritten in place), and memory
    accounting.
    """

    def __init__(self, model, n_slots: int, max_seq: int,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None):
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.kv_dtype = kv_dtype if kv_dtype is not None else "none"
        self.quant = resolve_kv_dtype(kv_dtype)
        self.paged_keys = list(model.paged_cache_keys())
        self.device = model.device
        max_blocks = max(-(-max_seq // page_size), 1)
        if n_pages is None:
            # default: same usable token capacity as the dense layout
            # (+1 for the reserved parking page)
            n_pages = n_slots * max_blocks + 1
        self.pool = PagePool(n_pages, page_size, n_slots, max_blocks)

        dense = model._cache_struct(n_slots, max_seq)
        cache = {}
        for key, s in dense.items():
            if key in self.paged_keys:
                # (L, n_slots, max_seq, KV, D) -> (L, n_pages, page, KV, D)
                shape = (s.shape[0], n_pages, page_size) + tuple(s.shape[3:])
                dtype = s.dtype if self.quant is None else self.quant[0]
                cache[key] = torch.zeros(shape, dtype=dtype,
                                         device=self.device)
                if self.quant is not None:
                    # one scale per (page, KV head); writers re-derive the
                    # absmax, never divide by a stored scale
                    cache[scale_key(key)] = torch.zeros(
                        (s.shape[0], n_pages, s.shape[3]),
                        dtype=torch.float32, device=self.device)
            else:
                cache[key] = torch.zeros(s.shape, dtype=s.dtype,
                                         device=self.device)
        self.cache = cache
        self.slot_vectors, self.tokens, self.pos, self.remaining = \
            slot_vectors(n_slots, self.device)
        self.tables_dev = torch.tensor(self.pool.tables, device=self.device)
        self._synced_version = self.pool.version

    def clear(self) -> None:
        """Back to the state of a fresh pool, in place: a new host
        allocator, and every device tensor zeroed (all block-table entries
        on the parking page)."""
        pool = self.pool
        self.pool = PagePool(pool.n_pages, pool.page_size, pool.n_slots,
                             pool.max_blocks)
        for t in (self.slot_vectors, self.tables_dev, *self.cache.values()):
            t.zero_()
        self._synced_version = self.pool.version

    def sync_tables(self) -> None:
        """Refresh the device mirror after host-side (de)allocations, in
        place; a no-op while the pool's allocation ``version`` has not
        moved."""
        if self._synced_version == self.pool.version:
            return
        upload(self.tables_dev, self.pool.tables)
        self._synced_version = self.pool.version

    def kv_hbm_bytes(self) -> int:
        """Bytes of the paged attention-KV pools (payload + scale leaves)."""
        keys = set(self.paged_keys) | {scale_key(k) for k in self.paged_keys}
        return cache_bytes(self.cache, keys)

    def cache_hbm_bytes(self) -> int:
        """Bytes of every cache leaf."""
        return cache_bytes(self.cache)


def write_prefill_pages(pool_leaf: torch.Tensor, sub_leaf: torch.Tensor,
                        tables_sub, scales: Optional[torch.Tensor] = None,
                        qmax: float = 0.0):
    """Scatter an admitted batch's prefilled KV into its pages, in place.

    pool_leaf: (L, P, page, KV, D); sub_leaf: (L, N, S, KV, D) with S a
    multiple of page; tables_sub: host (N, S // page) page ids per admitted
    row.  Ids >= P (dummy admissions, unallocated tail blocks) are skipped,
    as the reference drops them.

    With ``scales`` (L, P, KV) the pool is quantized: each written page
    gets a fresh per-(page, KV-head) absmax scale (right-padding inside a
    partly filled page counts in the absmax — it only widens the scale) and
    the call returns ``(pool_leaf, scales)`` instead of the bare leaf.
    """
    L, N, S = sub_leaf.shape[:3]
    P, page = pool_leaf.shape[1], pool_leaf.shape[2]
    nb = S // page
    flat = np.asarray(tables_sub).reshape(N * nb)
    rows = np.nonzero(flat < P)[0]
    idx = to_device(np.stack([flat[rows].astype(np.int64), rows]),
                    pool_leaf.device)
    ids = idx[0]
    blocks = sub_leaf.reshape((L, N * nb, page) + tuple(sub_leaf.shape[3:]))
    blocks = blocks.index_select(1, idx[1])
    if scales is None:
        pool_leaf[:, ids] = blocks.to(pool_leaf.dtype)
        return pool_leaf
    absmax = blocks.float().abs().amax(dim=(2, 4))           # (L, n, KV)
    new_scale = torch.clamp(absmax / qmax, min=1e-8)
    pool_leaf[:, ids] = quantize_to(blocks, new_scale[:, :, None, :, None],
                                    pool_leaf.dtype, qmax)
    scales[:, ids] = new_scale
    return pool_leaf, scales
