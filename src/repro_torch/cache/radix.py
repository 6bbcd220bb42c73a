"""Radix prefix index over the paged-KV pool: the port's own copy of the JAX
package's ``cache/radix.py`` (numpy only), so that both trees match,
adopt and evict alike on the same operations (the seeded-LRU salt comes
from ``np.random.default_rng(seed)`` in the same order).

Production traffic shares prefixes — system prompts, few-shot templates,
per-tenant preambles — so the K/V a prefill writes for one request is
byte-reusable by the next request carrying the same leading tokens:
under causal masking (with ``prompt_lens`` masking the right-padding)
position ``i``'s K/V depends only on tokens ``0..i``, so identical
prefixes produce identical pages whatever follows them.  The
:class:`RadixCache` indexes finished prefills by their token ids at
**page granularity**: a trie whose edges are ``page_size``-token chunks
and whose nodes each own exactly one resident page of the
:class:`~repro_torch.serve.kv_pages.PagePool`.

* **Adoption** (:meth:`insert`) — after a prefill completes, every fully
  valid page of the prompt is offered to the tree.  New paths retain the
  page (``pool.retain_page``: refcount + 1, no block-table change, so
  the device-mirror dirty flag stays clean); already-known chunks keep
  their existing page and the caller's duplicate stays slot-private.
* **Lookup** (:meth:`match`) — the longest chunk-aligned walk from the
  root returns the shared pages a new request can splice into its block
  table instead of re-prefilling; an optional *tail* probe additionally
  finds a child sharing a partial chunk (≥ 1 leading token) — the
  copy-on-write case, since the requester will write the divergent rest
  of that page.
* **Eviction** (:meth:`evict`) — under pool pressure the evictor
  reclaims **only pages the tree alone still references** (pool
  refcount 1; a page any slot is reading is never yanked), cascading
  leaf-upward in seeded-LRU order: coldest leaves go first, interior
  nodes become reclaimable once their (necessarily colder-or-equal)
  subtrees are gone.  Ties on the access clock break by a per-node salt
  drawn from the cache's seeded RNG, keeping multi-replica simulations
  reproducible.

Namespaces isolate requests whose K/V depends on more than the token
ids: encoder-decoder requests (cross-attention and self-K/V depend on
the encoder frames) and vision requests (patch rows occupy cache
positions and shift everything behind them) key their sub-trie by a
fingerprint of the extra conditioning (:func:`extras_namespace`), so
only requests with bit-identical extras can share pages.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RadixCache", "extras_namespace"]


def extras_namespace(extras: Optional[Dict]) -> int:
    """Deterministic fingerprint of a request's non-token conditioning.

    Hashes every extra leaf's name, shape, dtype and raw bytes; requests
    with no extras share namespace 0.  Two requests land in the same
    namespace (and may share prefix pages) only when their conditioning
    is bit-identical — the conservative rule that keeps encoder-decoder
    and vision-prefixed caches sound.
    """
    if not extras:
        return 0
    h = hashlib.blake2b(digest_size=8)
    for k in sorted(extras):
        v = np.asarray(extras[k])
        h.update(k.encode())
        h.update(repr((v.shape, str(v.dtype))).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return 1 + int.from_bytes(h.digest(), "big")


class _Node:
    """One resident page: the chunk of token ids that fills it, the page
    id backing it, and LRU bookkeeping."""

    __slots__ = ("chunk", "page", "parent", "children", "last_used",
                 "salt")

    def __init__(self, chunk, page: int, parent: Optional["_Node"],
                 salt: float = 0.0):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0
        self.salt = salt


class RadixCache:
    """Page-granular radix index with refcount-guarded seeded-LRU
    eviction (see module docstring)."""

    def __init__(self, page_size: int, seed: int = 0):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self._roots: Dict[int, _Node] = {}
        self._rng = np.random.default_rng(seed)
        self._clock = 0
        self.n_nodes = 0
        self.hits = 0           # lookups that matched >= 1 token
        self.misses = 0
        self.hit_tokens = 0     # tokens served from the tree
        self.lookup_tokens = 0  # tokens asked of the tree

    # -- helpers ---------------------------------------------------------
    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def _chunk(self, tokens: Sequence[int], i: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in
                     tokens[i * self.page_size:(i + 1) * self.page_size])

    # -- lookup ----------------------------------------------------------
    def match(self, tokens: Sequence[int], ns: int = 0,
              tail: bool = False, touch: bool = True
              ) -> Tuple[List[int], int, Optional[Tuple[int, int]]]:
        """Longest cached prefix of ``tokens``.

        Returns ``(pages, matched_tokens, tail_hit)``: the chunk-aligned
        shared pages, the token count they cover, and — with ``tail`` —
        an optional ``(page, k)`` for a child whose chunk shares ``k``
        leading tokens with the unmatched remainder (the copy-on-write
        splice).  ``touch=False`` makes the lookup a pure probe (router
        scoring): no LRU motion, no hit/miss accounting.
        """
        root = self._roots.get(int(ns))
        toks = [int(t) for t in tokens]
        pages: List[int] = []
        matched = 0
        tail_hit: Optional[Tuple[int, int]] = None
        node = root
        if node is not None:
            while matched + self.page_size <= len(toks):
                child = node.children.get(
                    self._chunk(toks, matched // self.page_size))
                if child is None:
                    break
                pages.append(child.page)
                matched += self.page_size
                node = child
                if touch:
                    self._touch(child)
            if tail and matched < len(toks):
                rem = toks[matched:]
                best_k, best = 0, None
                for chunk, child in sorted(node.children.items()):
                    k = 0
                    for a, b in zip(rem, chunk):
                        if a != b:
                            break
                        k += 1
                    if k > best_k:
                        best_k, best = k, child
                if best is not None:
                    tail_hit = (best.page, best_k)
                    if touch:
                        self._touch(best)
        if touch:
            got = matched + (tail_hit[1] if tail_hit else 0)
            self.hits += 1 if got else 0
            self.misses += 0 if got else 1
            self.hit_tokens += got
            self.lookup_tokens += len(toks)
        return pages, matched, tail_hit

    # -- adoption --------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int], pool,
               ns: int = 0) -> int:
        """Adopt a finished prefill's fully-valid pages.

        ``pages[i]`` must back ``tokens[i*page : (i+1)*page]`` — callers
        pass only pages every position of which holds valid prompt K/V.
        New chunks are retained in the pool; chunks already in the tree
        keep their incumbent page (the caller's copy stays slot-private
        and dies with the slot).  Returns the number of pages adopted.
        """
        node = self._roots.setdefault(
            int(ns), _Node(None, -1, None))
        toks = [int(t) for t in tokens]
        adopted = 0
        for i, page in enumerate(pages):
            chunk = self._chunk(toks, i)
            if len(chunk) < self.page_size:
                break
            child = node.children.get(chunk)
            if child is None:
                pool.retain_page(int(page))
                child = _Node(chunk, int(page), node,
                              salt=float(self._rng.random()))
                node.children[chunk] = child
                self.n_nodes += 1
                adopted += 1
            self._touch(child)
            node = child
        return adopted

    # -- eviction --------------------------------------------------------
    def _evictable(self, pool) -> Optional[_Node]:
        """Coldest leaf whose page only the tree holds (refcount 1)."""
        best, best_key = None, None
        for root in self._roots.values():
            stack = [root]
            while stack:
                nd = stack.pop()
                for c in nd.children.values():
                    if c.children:
                        stack.append(c)
                    elif pool.refcounts[c.page] == 1:
                        key = (c.last_used, c.salt)
                        if best_key is None or key < best_key:
                            best, best_key = c, key
        return best

    def evict(self, pool, n_pages: int = 1) -> int:
        """Reclaim up to ``n_pages`` tree-only pages in LRU order,
        cascading leaf-upward (a parent becomes a candidate leaf once
        its subtree is gone).  Returns the number actually freed —
        pinned pages (any slot still mapping them) are never touched, so
        the count may fall short under heavy sharing.
        """
        freed = 0
        while freed < n_pages:
            node = self._evictable(pool)
            if node is None:
                break
            pool.evict_page(node.page)
            del node.parent.children[node.chunk]
            self.n_nodes -= 1
            freed += 1
        return freed

    def flush(self, pool) -> int:
        """Drop every tree reference (pool pages a slot still maps stay
        alive through the slot's own refcount).  Returns nodes released."""
        released = 0
        for root in self._roots.values():
            stack = list(root.children.values())
            root.children.clear()
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                pool.release_page(nd.page)
                released += 1
        self._roots.clear()
        self.n_nodes = 0
        return released

    # -- accounting ------------------------------------------------------
    def stats(self) -> Dict:
        looks = self.hits + self.misses
        return {"nodes": self.n_nodes,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / looks if looks else 0.0,
                "hit_tokens": self.hit_tokens,
                "lookup_tokens": self.lookup_tokens,
                "token_hit_rate": (self.hit_tokens / self.lookup_tokens
                                   if self.lookup_tokens else 0.0)}
