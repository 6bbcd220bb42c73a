"""Continuous-batching serving engine of the port, with one host sync per
decode round.

The PyTorch counterpart of the JAX package's ``serve/engine.py``: a fixed
pool of batch slots, a :class:`~repro_torch.serve.scheduler.Scheduler` for
admission and slot lifecycle, a dense :class:`BatchState` or a paged
:class:`PagedBatchState` for device state, and the model math here.

1. *Batched bucketed admission* — the requests admitted in a round are
   grouped by power-of-two prompt bucket and extras signature and
   prefilled in one batched call per group (``batch_slots`` rows, per-row
   ``prompt_lens`` masking; a VLM request's ``patch_embeds`` rows stacked
   before its tokens, an encoder-decoder request's ``frames`` stacked for
   its encoder, zero rows for the unused slots); the slots' tokens /
   positions / budgets are set on the device in the same call, and the
   sampled first tokens are fetched at the next round sync.
2. *On-device termination* — the per-slot budget ``remaining`` rides every
   decode step: a slot that hits its max-len or samples ``eos_token``
   freezes in place (``torch.where`` on the device, no host involvement).
3. *Multi-chunk rounds* — a round runs several decode chunks back to back
   (PyTorch launches asynchronously) and then makes exactly one
   device-to-host copy for the pending first tokens and every chunk's
   (tokens, emitted-mask) pairs.

Where the reference compiles each decode chunk length and each prompt
bucket's prefill into one ``jax.jit`` program, memoized, the port captures
each as one CUDA graph (``serve/graphs.py``), memoized per chunk length in
``_chunk_fns`` and per (bucket, extras signature) in ``_prefill_fns``
(the patch rows or encoder frames are a static input of the graph), and
replays it; :attr:`ServeEngine.compile_stats` counts them under the
reference's keys.  The state tensors keep their storage (the reference
donates its buffers to ``jit``): every write is in place, and
:meth:`ServeEngine.reset` zeroes them, so the graphs survive it as the
reference's compiled functions do.
On a CPU model the memo entries hold the same bodies, run eagerly;
``cuda_graphs=False`` runs them eagerly on the card too, the counterpart
of running the reference under ``jax.disable_jit()``.

With ``prefix_cache=True`` (paged only) a
:class:`~repro_torch.cache.RadixCache` indexes finished prefills by their
prompt tokens at page granularity: admission splices cached prefix pages
read-only into the slot's block table (a partly matching tail page is
copied on write, in place), the bucket's prefill still runs the whole
prompt but its writes to the shared pages are skipped, and every fully
valid prompt page is adopted into the tree after the prefill, as in the
reference.

An ``executor`` gets the reference's five-method hook at the same points:
``on_prefill()`` per admitted request, ``on_decode(n_active)`` per decode
step, ``finish()``, ``reset()`` and ``summary()``, so a DVFS governor
executor plugs in unchanged.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..cache import RadixCache, extras_namespace
from ..models import common as cm
from ..obs import NULL_TRACER
from .batch_state import BatchState
from .graphs import GraphedCall
from .kv_pages import (PagedBatchState, cow_copy_block, scale_key,
                       write_prefill_pages)
from .scheduler import Scheduler


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False
    # engine decode-step counter at completion (latency-in-steps metric)
    finished_step: Optional[int] = None
    # family-specific prefill inputs, the model's ``prefill_extras``: a
    # VLM request's "patch_embeds" (1, P, d), an encoder-decoder request's
    # "frames" (1, F, d)
    extras: Dict[str, Any] = field(default_factory=dict)


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature: float = 0.0) -> torch.Tensor:
    """Greedy (T=0: the first maximum, as ``jnp.argmax``) or temperature
    sampling from ``generator``; logits (B, V) -> (B,) int32.

    A sample is ``argmax(p / q)`` with ``q ~ Exp(1)`` a logit, the draw
    ``torch.multinomial`` makes for one sample, written out because
    ``multinomial`` first checks its input on the host, which a CUDA graph
    cannot capture."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def _chunk_len(n: int, cap: int) -> int:
    """Largest power of two <= min(n, cap): bounds over-decode."""
    n = min(n, cap)
    p = 1
    while 2 * p <= n:
        p *= 2
    return p


def _bucket(plen: int) -> int:
    """Smallest power of two >= plen (>= 8, so tiny prompts share one
    bucket)."""
    b = 8
    while b < plen:
        b *= 2
    return b


class ServeEngine:
    """Single-host continuous-batching engine over a port model; runs on
    the model's device, through CUDA graphs on the card unless
    ``cuda_graphs`` is False."""

    def __init__(self, model, params, batch_slots: int = 4,
                 max_seq: int = 512, temperature: float = 0.0,
                 seed: int = 0, executor=None, max_chunk: int = 16,
                 eos_token: Optional[int] = None, paged: bool = False,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False, tracer=None,
                 cuda_graphs: bool = True):
        if paged and max_seq % page_size:
            raise ValueError(f"paged engine needs max_seq ({max_seq}) to "
                             f"be a multiple of page_size ({page_size})")
        if kv_dtype not in (None, "none") and not paged:
            raise ValueError("kv_dtype quantization needs paged=True "
                             "(only page pools carry scale tables)")
        if prefix_cache and not paged:
            raise ValueError("prefix_cache needs paged=True (sharing is "
                             "a block-table splice)")
        self.model = model
        self.params = params
        self.device = model.device
        # engine timeline is the decode-step counter (modeled,
        # deterministic); NullTracer keeps the hot path branch-cheap
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_track = "serve"
        self.slots = batch_slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.seed = seed
        self.rng = self._generator()
        self.executor = executor
        self.max_chunk = max_chunk
        self.eos_token = eos_token
        self.paged = paged
        self.page_size = page_size
        self.n_pages = n_pages
        self.kv_dtype = kv_dtype
        # radix prefix index over the page pool (see the module docstring)
        self.prefix_cache: Optional[RadixCache] = \
            RadixCache(page_size, seed=seed) if prefix_cache else None
        self._slot_shared: Dict[int, int] = {}  # slot -> spliced full pages
        self.scheduler = Scheduler(batch_slots)
        self.state = self._new_state()
        self.n_decode_steps = 0           # decode steps executed
        self.n_prefill_calls = 0          # batched bucket prefills run
        # memoized hot-path entry points, keyed by the only shape-varying
        # dims (chunk length / prompt bucket), so their count is bounded
        # by log2(max_chunk) + 1 + n_buckets, as the reference's jit
        # variants are; on the card each is a CUDA graph, and all of them
        # share one memory pool (graphs.py says why that is safe)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self.cuda_graphs else None
        self._chunk_fns: Dict[int, GraphedCall] = {}
        self._prefill_fns: Dict[Tuple, "BucketPrefill"] = {}
        # admissions whose sampled first token has not been fetched yet:
        # (admit_step, [(slot, request), ...], device tensor of firsts)
        self._pending_first: List[Tuple[int, List, torch.Tensor]] = []

    def _generator(self) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        return g

    def _new_state(self):
        if self.paged:
            return PagedBatchState(self.model, self.slots, self.max_seq,
                                   page_size=self.page_size,
                                   n_pages=self.n_pages,
                                   kv_dtype=self.kv_dtype)
        return BatchState(self.model, self.slots, self.max_seq)

    def reset(self) -> None:
        """Clear serving state for a fresh workload, in place: the state
        tensors are zeroed and the sampling generator re-seeded, so a
        seeded run repeats, and the captured graphs (which replay against
        those tensors and that generator) survive, as the reference's
        compiled functions do.  The prefix cache starts empty: the cleared
        state's page pool is a new one, whose ids the old tree's nodes
        would not own."""
        self.rng.manual_seed(self.seed)
        self.scheduler = Scheduler(self.slots)
        self.state.clear()
        self.n_decode_steps = 0
        self.n_prefill_calls = 0
        self._pending_first = []
        if self.prefix_cache is not None:
            self.prefix_cache = RadixCache(self.page_size, seed=self.seed)
        self._slot_shared = {}
        if self.executor is not None:
            self.executor.reset()

    @property
    def compile_stats(self) -> Dict[str, int]:
        """Variant counts of the two hot-path entry points, under the
        reference's keys and as it counts them: decode chunk lengths, and
        prompt buckets (the reference memoizes one jitted prefill a bucket;
        here a bucket holds one CUDA graph, or eager body, per extras
        signature, which ``graph_stats`` lists)."""
        d = len(self._chunk_fns)
        p = len({bucket for bucket, _ in self._prefill_fns})
        return {"decode_chunk_variants": d, "prefill_bucket_variants": p,
                "n_variants": d + p}

    def graph_stats(self) -> List[Dict[str, Any]]:
        """Per memoized entry point: its kind and key, the host ms of its
        capture, the graph pool's growth at it, its replays and the kernel
        launches of one replay (empty without graphs)."""
        calls = [("decode_chunk", n, f) for n, f in self._chunk_fns.items()]
        calls += [("prefill_bucket", key, f.call)
                  for key, f in self._prefill_fns.items()]
        return [{"kind": kind, "key": key, "capture_ms": f.capture_ms,
                 "pool_bytes": f.pool_bytes, "replays": f.replays,
                 "launches": f.launches}
                for kind, key, f in calls if f.graph is not None]

    # -- memoized entry points -------------------------------------------
    def _graphed(self, body) -> GraphedCall:
        gen = self.rng if self.temperature > 0.0 else None
        return GraphedCall(body, self.cuda_graphs, self._graph_pool, gen)

    def _chunk_fn(self, n: int) -> GraphedCall:
        fn = self._chunk_fns.get(n)
        if fn is None:
            fn = self._graphed(functools.partial(self._decode_body, n))
            self._chunk_fns[n] = fn
        return fn

    def _prefill_fn(self, bucket: int, extras: Dict[str, np.ndarray]
                    ) -> "BucketPrefill":
        key = (bucket, _signature(extras))
        fn = self._prefill_fns.get(key)
        if fn is None:
            fn = BucketPrefill(self, bucket, extras)
            self._prefill_fns[key] = fn
        return fn

    # -- device work -----------------------------------------------------
    def _decode_body(self, n: int) -> torch.Tensor:
        """``n`` decode steps over every slot with on-device termination,
        reading and writing only the state tensors; returns the emitted
        tokens and generated-mask as one (2, n, slots) int32 tensor."""
        st = self.state
        tables = st.tables_dev if self.paged else None
        tokens, pos, rem = st.tokens, st.pos, st.remaining
        toks, gens = [], []
        for _ in range(n):
            logits, _ = self.model.decode_step(
                self.params, st.cache, tokens, pos, block_tables=tables)
            nxt = sample_token(logits, self.rng, self.temperature)
            gen = rem > 0
            # finished slots freeze: the same token re-fed at the same pos
            # rewrites the same cache entry, and the row is overwritten at
            # the next admission
            nxt = torch.where(gen, nxt, tokens)
            rem = torch.where(gen, rem - 1, rem)
            if self.eos_token is not None:
                rem = torch.where(gen & (nxt == self.eos_token), 0, rem)
            pos = torch.where(gen, pos + 1, pos)
            tokens = nxt
            toks.append(nxt)
            gens.append(gen)
        st.slot_vectors.copy_(torch.stack([tokens, pos, rem]))
        return torch.stack([torch.stack(toks),
                            torch.stack(gens).to(torch.int32)])

    def _prefill_body(self, prompts: torch.Tensor, meta: torch.Tensor,
                      extras: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict]:
        """One group's masked batched prefill and first-token sampling
        over its static buffers: ``prompts`` (N, bucket), ``meta``
        (prompt_lens, slots, budgets) as (3, N) int32 and ``extras`` (the
        rows' patch embeddings or encoder frames, if any; frames take no
        cache position).  Returns the rows' new slot vectors (first token,
        position, budget left) as one (3, N) int32 tensor, and the
        prefilled sub-cache."""
        logits, sub = self.model.prefill(
            self.params, prompts, prompt_lens=meta[0], max_seq=self.max_seq,
            remat=False, **extras)
        first = sample_token(logits, self.rng, self.temperature)
        rem = meta[2] - 1
        if self.eos_token is not None:
            rem = torch.where(first == self.eos_token, 0, rem)
        prefix = extras["patch_embeds"].shape[1] \
            if "patch_embeds" in extras else 0
        return torch.stack([first, meta[0] + prefix, rem]), sub

    def _prefill(self, prompts: np.ndarray, meta: np.ndarray,
                 tables_sub: Optional[np.ndarray],
                 extras: Dict[str, np.ndarray]) -> torch.Tensor:
        """One group's batched admission: the group's memoized prefill,
        then the cache install (slot rows or pages) and slot activation,
        eager and indexed from the host.  Returns the admitted rows' first
        tokens.

        ``meta`` packs (prompt_lens, slots, budgets) as host (3, N) int32.
        Dummy rows carry ``slot == n_slots`` and page ids ``n_pages``; they
        are filtered out of every write.  The prefill's outputs may be a
        graph's static outputs: each is consumed here, before any later
        replay is queued.
        """
        act, sub = self._prefill_fn(prompts.shape[1], extras)(
            prompts, meta, extras)
        st = self.state
        axes = self.model.cache_slot_axes()
        if tables_sub is not None:
            paged_keys = set(self.model.paged_cache_keys())
            for k in paged_keys:
                sk = scale_key(k)
                if sk in st.cache:
                    write_prefill_pages(st.cache[k], sub[k], tables_sub,
                                        scales=st.cache[sk],
                                        qmax=cm.kv_qmax(st.cache[k].dtype))
                else:
                    write_prefill_pages(st.cache[k], sub[k], tables_sub)
            dense = {k: ax for k, ax in axes.items() if k not in paged_keys}
            cm.write_cache_slots(st.cache, sub, meta[1], dense)
        else:
            cm.write_cache_slots(st.cache, sub, meta[1], axes)
        # real rows come first, so the selected rows' first tokens are the
        # admitted requests' in order (a copy: no graph output aliases it)
        rows = np.nonzero(meta[1] < self.slots)[0]
        idx = cm.to_device(np.stack([rows, meta[1][rows].astype(np.int64)]),
                           self.device)
        vals = act.index_select(1, idx[0])
        st.slot_vectors.index_copy_(1, idx[1], vals)
        self.n_prefill_calls += 1
        return vals[0]

    # -- admission -------------------------------------------------------
    @staticmethod
    def _req_prefix(req: Request) -> int:
        """Positions a request's patch rows take before its prompt."""
        pe = req.extras.get("patch_embeds")
        return 0 if pe is None else np.shape(pe)[1]

    def _cache_key(self, req: Request) -> Tuple[int, List[int]]:
        """(namespace, position-token stream) identifying the request's
        cache pages, as in the reference: the extras condition every K/V
        position, so they pick the namespace (bit-identical patch rows
        share one); each patch row is a sentinel position -1, then the
        prompt ids follow."""
        return extras_namespace(req.extras), [-1] * self._req_prefix(req) \
            + [int(t) for t in np.asarray(req.prompt, np.int64)]

    def _prefix_match(self, req: Request, need: int):
        """Cached pages spliceable into a ``need``-token reservation:
        ``(full_pages, tail_hit)``, the tail (a partly matching page the
        request overwrites past the match) taken only when the reservation
        has a block left for its copy."""
        if self.prefix_cache is None:
            return [], None
        ns, key = self._cache_key(req)
        pages, _, tail = self.prefix_cache.match(key, ns=ns, tail=True)
        if tail is not None and \
                len(pages) + 1 > max(-(-need // self.page_size), 1):
            tail = None
        return pages, tail

    def _allocate_paged(self, slot: int, req: Request, need: int) -> bool:
        """Reserve ``slot``'s pages for the whole request, splicing any
        cached prefix; on pool pressure, evict cold tree-only pages before
        deferring.  A tail hit is copied on write here, since the
        divergent write span is known at admission.  False when the pool
        cannot cover the request yet (the caller defers the admission)."""
        pool = self.state.pool
        shared, tail = self._prefix_match(req, need)
        splice = list(shared) + ([tail[0]] if tail is not None else [])
        need_pages = max(-(-need // self.page_size), 1)
        fresh = need_pages - len(splice)
        extra = 0 if tail is None else 1        # the copy's target page
        if self.prefix_cache is not None and pool.n_free < fresh + extra:
            # the matched pages are the tree's most recently used, but a
            # pool under enough pressure would evict them too and the
            # splice below would then raise (as the reference's does): they
            # are held while the evictor runs
            for p in splice:
                pool.retain_page(p)
            self.prefix_cache.evict(pool, fresh + extra - pool.n_free)
            for p in splice:
                pool.release_page(p)
        if tail is not None and pool.n_free < fresh + 1:
            # no page left for the copy: splice the full pages only (the
            # prefill recomputes the tail anyway)
            tail, splice = None, list(shared)
        if not pool.allocate(slot, need, shared=splice):
            if not int(pool.n_blocks.sum()):  # no slot holds pages: the
                # request can never fit, backpressure would deadlock
                raise ValueError(
                    f"request {req.uid} needs {need} tokens; the page pool "
                    f"holds {pool.n_free * pool.page_size} usable")
            return False
        self._slot_shared[slot] = len(shared)
        if tail is not None:
            cow_copy_block(self.state, slot, len(shared))
        if self.tracer.enabled and (shared or tail is not None):
            self.tracer.instant(
                self.trace_track, "prefix-hit",
                float(self.n_decode_steps), cat="cache",
                args={"uid": req.uid, "shared_pages": len(shared),
                      "cow_tail": tail is not None, "slot": slot})
        return True

    def _admit(self) -> None:
        """Admit every admissible queued request, bucketed by prompt
        length: one batched prefill per power-of-two bucket.  Paged mode
        allocates each request's pages here (the decode path never
        allocates); a request that does not fit re-queues at the head and
        admission stops (backpressure)."""
        admitted: List[Tuple[int, Request]] = []
        while True:
            nxt = self.scheduler.admit_next()
            if nxt is None:
                break
            slot, req = nxt
            if req.max_new_tokens < 1:
                # nothing to generate: complete without touching the pool
                req.done = True
                req.finished_step = self.n_decode_steps
                self.scheduler.release(slot)
                continue
            takes = getattr(self.model, "prefill_extras", ())
            unknown = sorted(set(req.extras) - set(takes))
            if unknown:
                raise NotImplementedError(
                    f"request {req.uid}: prefill extras {unknown} are not "
                    f"inputs of {self.model.cfg.name} (it takes "
                    f"{list(takes)})")
            prompt = np.asarray(req.prompt, np.int32)
            prefix = self._req_prefix(req)
            if prefix + prompt.size + req.max_new_tokens > self.max_seq + 1:
                raise ValueError(
                    f"request {req.uid}: prompt {prefix + prompt.size} + "
                    f"{req.max_new_tokens} new tokens exceeds "
                    f"max_seq={self.max_seq}")
            if self.paged:
                # positions written: patch rows and prompt 0..n-1, decode
                # n..n+new-2 (the final sampled token is emitted, never
                # cached)
                need = prefix + prompt.size + req.max_new_tokens - 1
                if not self._allocate_paged(slot, req, need):
                    self.scheduler.requeue(slot)
                    break
            admitted.append((slot, req))
        if not admitted:
            return
        if self.paged:
            self.state.sync_tables()
        # one prefill call per (prompt bucket, extras signature), as in the
        # reference: rows of a call stack, so text-only and patch requests
        # take separate calls.  The bucket caps at the room the cache has
        # behind the patch rows.  The reference orders the groups by their
        # str(); the same order keeps prefill, executor and trace calls in
        # the same sequence
        groups: Dict[Tuple, List[Tuple[int, Request]]] = {}
        for slot, req in admitted:
            b = min(_bucket(len(req.prompt)),
                    self.max_seq - self._req_prefix(req))
            groups.setdefault((b, _signature(req.extras)), []).append(
                (slot, req))
        for key in sorted(groups, key=str):
            self._admit_bucket(key[0], groups[key])

    def _admit_bucket(self, bucket: int,
                      pairs: List[Tuple[int, Request]]) -> None:
        N = self.slots                      # fixed row count per bucket
        prompts = np.zeros((N, bucket), np.int32)
        meta = np.ones((3, N), np.int32)    # (plens, slots, budgets)
        meta[1] = self.slots                # dummy rows: filtered out
        for i, (slot, req) in enumerate(pairs):
            p = np.asarray(req.prompt, np.int32)
            prompts[i, :p.size] = p
            meta[0, i] = p.size
            meta[1, i] = slot
            meta[2, i] = req.max_new_tokens
        # each extra stacked over the rows, zeros for the dummy rows
        extras: Dict[str, np.ndarray] = {}
        for key in pairs[0][1].extras:
            rows = [np.asarray(r.extras[key])[0] for _, r in pairs]
            extras[key] = np.stack(
                rows + [np.zeros_like(rows[0])] * (N - len(pairs)))
        tables_sub = None
        if self.paged:
            pool = self.state.pool
            tables_sub = np.full((N, pool.max_blocks), pool.n_pages,
                                 np.int32)                # skipped
            for i, (slot, _) in enumerate(pairs):
                nb = int(pool.n_blocks[slot])
                tables_sub[i, :nb] = pool.tables[slot, :nb]
                # spliced prefix pages are shared read-only: this row's
                # prefill re-derives their K/V, so its writes there are
                # skipped (ids >= n_pages); decode reads the real ids
                # through the device block tables
                tables_sub[i, :self._slot_shared.pop(slot, 0)] = \
                    pool.n_pages
        if self.executor is not None:
            for _ in pairs:
                self.executor.on_prefill()
        if self.tracer.enabled:
            for slot, req in pairs:
                self.tracer.instant(
                    self.trace_track, "admit",
                    float(self.n_decode_steps), cat="lifecycle",
                    args={"uid": req.uid, "slot": slot, "bucket": bucket,
                          "prompt_len": len(req.prompt)})
        first = self._prefill(prompts, meta, tables_sub, extras)
        if self.prefix_cache is not None:
            # adopt every fully valid prompt page (the decode span never
            # enters the tree): shared head chunks are already nodes, fresh
            # ones are retained
            pool = self.state.pool
            for slot, req in pairs:
                ns, key = self._cache_key(req)
                n_full = len(key) // self.page_size
                if n_full:
                    self.prefix_cache.insert(
                        key, [int(p) for p in pool.tables[slot, :n_full]],
                        pool, ns=ns)
        self._pending_first.append((self.n_decode_steps, list(pairs),
                                    first))

    # -- decode ----------------------------------------------------------
    def _decode_round(self) -> None:
        """Run this round's decode chunks, then sync once: fetch pending
        first tokens and every chunk's (tokens, mask), extend requests,
        release finished slots."""
        live = [(s, r) for s, r in enumerate(self.scheduler.slots)
                if r is not None]
        pend_slots = {s for _, ps, _ in self._pending_first for s, _ in ps}
        ubs = [r.max_new_tokens - len(r.generated)
               - (1 if s in pend_slots else 0) for s, r in live]
        positive = [u for u in ubs if u > 0]
        if not positive and not self._pending_first:
            if live:
                raise RuntimeError("stalled: live slots with no budget "
                                   "and nothing pending")
            return
        # never outrun the soonest slot release while admissions wait;
        # drain at full chunk width when the queue is empty
        bound = 0
        if positive:
            bound = min(positive) if self.scheduler.pending \
                else max(positive)
        chunks: List[Tuple[int, torch.Tensor]] = []
        off = 0                      # steps already run this round
        while bound > 0:
            n = _chunk_len(bound, self.max_chunk)
            if self.executor is not None:
                # expected occupancy per step from the host-known budgets
                # (exact for max-len termination; upper bound under EOS)
                for step in range(off, off + n):
                    self.executor.on_decode(
                        sum(1 for u in ubs if u > step))
            # a copy: the next replay of this graph overwrites its output
            out = self._chunk_fn(n)().clone()
            chunks.append((self.n_decode_steps, out))
            self.n_decode_steps += n
            bound -= n
            off += n
        if self.tracer.enabled and off:
            self.tracer.span(
                self.trace_track, "decode-round",
                float(self.n_decode_steps - off), float(off), cat="phase",
                args={"steps": off, "chunks": len(chunks),
                      "live": len(live)})
        self._sync(chunks)

    def _sync(self, chunks) -> None:
        """The round's single device-to-host copy."""
        pending, self._pending_first = self._pending_first, []
        if not pending and not chunks:
            return
        parts = [f for _, _, f in pending] + [o.reshape(-1)
                                              for _, o in chunks]
        flat = torch.cat(parts).cpu().numpy()
        at = 0

        def take(shape):
            nonlocal at
            size = int(np.prod(shape))
            out = flat[at:at + size].reshape(shape)
            at += size
            return out

        firsts = [take(f.shape) for _, _, f in pending]
        fetched = [(o[0], o[1].astype(bool))
                   for o in (take(o.shape) for _, o in chunks)]
        last_step: Dict[int, int] = {}
        for (admit_step, pairs, _), first in zip(pending, firsts):
            for i, (slot, req) in enumerate(pairs):
                req.generated.append(int(first[i]))
                last_step[slot] = admit_step
        for (step0, _), (toks, gens) in zip(chunks, fetched):
            for slot, req in enumerate(self.scheduler.slots):
                if req is None:
                    continue
                hit = np.nonzero(gens[:, slot])[0]
                if hit.size:
                    req.generated.extend(int(t) for t in toks[hit, slot])
                    last_step[slot] = step0 + int(hit[-1]) + 1
        for slot, req in enumerate(self.scheduler.slots):
            if req is None:
                continue
            full = len(req.generated) >= req.max_new_tokens
            eosd = (self.eos_token is not None and req.generated
                    and req.generated[-1] == self.eos_token)
            if full or eosd:
                req.done = True
                req.finished_step = last_step.get(slot,
                                                  self.n_decode_steps)
                self.scheduler.release(slot)
                if self.paged:
                    self.state.pool.free(slot)

    # -- driving ---------------------------------------------------------
    def submit(self, requests: List[Request]) -> None:
        self.scheduler.submit(requests)

    def run(self) -> None:
        """Drain the queue: admit into free slots, decode in rounds."""
        while not self.scheduler.done():
            self._admit()
            self._decode_round()
        if self.executor is not None:
            self.executor.finish()

    def generate(self, requests: List[Request]) -> List[Request]:
        self.submit(requests)
        self.run()
        return requests

    def energy_summary(self) -> Optional[Dict]:
        return None if self.executor is None else self.executor.summary()

    def prefix_cache_stats(self) -> Optional[Dict]:
        """Radix-tree hit and occupancy counters plus the pool's sharing
        counters; None when the cache is off."""
        if self.prefix_cache is None:
            return None
        ps = self.state.pool.stats()
        return {**self.prefix_cache.stats(),
                "shared_pages": ps["shared_pages"],
                "cow_copies": ps["cow_copies"],
                "evictions": ps["evictions"]}


def _signature(extras: Dict[str, Any]) -> Tuple:
    """The extras' names and shapes, sorted: requests of one prefill call
    share it (the reference's grouping key beside the bucket)."""
    return tuple(sorted((k, np.shape(v)) for k, v in extras.items()))


class BucketPrefill:
    """One (prompt bucket, extras signature)'s memoized prefill: static
    device buffers for the prompts (slots, bucket), meta (3, slots) and
    each extra stacked over the slots (a VLM call's patch rows, (slots, P,
    d); an encoder-decoder call's frames, (slots, F, d)), filled in place
    at each call, and the engine's prefill body over them as a
    :class:`~repro_torch.serve.graphs.GraphedCall`."""

    def __init__(self, engine: ServeEngine, bucket: int,
                 extras: Dict[str, np.ndarray]):
        dev, n = engine.device, engine.slots
        self.prompts = torch.zeros((n, bucket), dtype=torch.int32, device=dev)
        self.meta = torch.zeros((3, n), dtype=torch.int32, device=dev)
        self.extras = {k: torch.zeros_like(torch.from_numpy(v), device=dev)
                       for k, v in extras.items()}
        self.call = engine._graphed(functools.partial(
            engine._prefill_body, self.prompts, self.meta, self.extras))

    def __call__(self, prompts: np.ndarray, meta: np.ndarray,
                 extras: Dict[str, np.ndarray]):
        cm.upload(self.prompts, prompts)
        cm.upload(self.meta, meta)
        for k, buf in self.extras.items():
            cm.upload(buf, extras[k])
        return self.call()
