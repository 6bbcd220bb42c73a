"""The port's prefix cache against the JAX package's, on the CPU.

The radix tree and the page pool's sharing life cycle run as the same
operation sequences on both packages' ``RadixCache`` / ``PagePool`` (the
cases of ``tests/test_prefix_cache.py`` and seeded random sequences): every
result, refcount, free list, eviction and counter must be equal.  Then the
engine: a cached-splice admission (a full-page hit plus a copy-on-write
tail) decodes like a cold admission of the same prompt, for the dense,
SSM and hybrid families, on f32 and int8 pages; whole engine runs with the
cache on give the tokens of the cache off and of the reference engine with
the cache on, with equal ``prefix_cache_stats()``, trace events and hook
calls, also when the pool is small enough that the evictor runs; and
``reset()`` empties the tree and repeats the run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import FAMILY_ARCHS
from repro.cache import RadixCache as JaxRadix
from repro.cache import extras_namespace as jax_namespace
from repro.obs import Tracer as JaxTracer
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro.serve.kv_pages import PagePool as JaxPool
from repro_torch.cache import RadixCache, extras_namespace
from repro_torch.obs import Tracer as TorchTracer
from repro_torch.serve import PagePool, Request, ServeEngine, cow_copy_block
from torch_parity import QUANT_TOL, RecordingExecutor, np32, twin

PORT = (RadixCache, PagePool, extras_namespace)
REF = (JaxRadix, JaxPool, jax_namespace)


def _pool(mod, **kw):
    geom = dict(n_pages=20, page_size=4, n_slots=4, max_blocks=8)
    geom.update(kw)
    return mod[1](**geom)


def _pool_state(pool):
    return (pool.tables.tolist(), list(pool._free), pool.refcounts.tolist(),
            pool.n_blocks.tolist(), pool.version, pool.stats())


def _call(log, fn, *args, **kw):
    """Record ``fn``'s result (or its exception's type and message)."""
    try:
        out = fn(*args, **kw)
    except (ValueError, RuntimeError) as e:
        out = (type(e).__name__, str(e))
    log.append(out)
    return out


def _seed_prompt(log, pool, cache, slot, tokens, free=False):
    """Allocate ``slot``, adopt its fully covered pages, optionally free the
    slot (leaving the pages tree-only).  Returns the page list."""
    _call(log, pool.allocate, slot, len(tokens))
    n_full = len(tokens) // pool.page_size
    pages = [int(p) for p in pool.tables[slot, :n_full]]
    _call(log, cache.insert, tokens, pages, pool)
    if free:
        _call(log, pool.free, slot)
    return pages


# ---------------------------------------------------------------------------
# the radix tree and the pool: the reference's cases as operation sequences
# ---------------------------------------------------------------------------

def _chunk_walk(mod, log):
    pool, cache = _pool(mod), mod[0](page_size=4)
    toks = list(range(12))
    pages = _seed_prompt(log, pool, cache, 0, toks)
    for q in (toks, toks[:8], toks[:4] + [99, 98, 97, 96], toks[:6]):
        _call(log, cache.match, q)
    _call(log, pool.allocate, 1, 12)
    dup = [int(p) for p in pool.tables[1, :3]]
    _call(log, cache.insert, toks, dup, pool)
    log.append((cache.n_nodes, pages, _pool_state(pool)))


def _tail_hit(mod, log):
    pool, cache = _pool(mod), mod[0](page_size=4)
    toks = list(range(12))
    _seed_prompt(log, pool, cache, 0, toks)
    _call(log, cache.match, toks[:4] + [4, 5, 77, 78], tail=True)
    _call(log, cache.match, toks[:4] + [77, 78], tail=True)
    log.append(cache.stats())


def _pure_probe(mod, log):
    pool, cache = _pool(mod), mod[0](page_size=4)
    toks = list(range(8))
    _seed_prompt(log, pool, cache, 0, toks)
    _call(log, cache.match, toks, touch=True)
    log.append(cache.stats())
    _call(log, cache.match, toks, touch=False)
    log.append(cache.stats())


def _namespaces(mod, log):
    ns = mod[2]
    a = {"frames": np.ones((1, 4, 8), np.float32)}
    b = {"frames": np.zeros((1, 4, 8), np.float32)}
    na, nb = ns(a), ns(b)
    log.append((ns(None), ns({}), na, nb, ns(dict(a))))
    pool, cache = _pool(mod), mod[0](page_size=4)
    toks = list(range(8))
    _call(log, pool.allocate, 0, 8)
    _call(log, cache.insert, toks, [int(p) for p in pool.tables[0, :2]],
          pool, ns=na)
    for n in (na, nb, 0):
        _call(log, cache.match, toks, ns=n)


def _evict_and_flush(mod, log):
    pool, cache = _pool(mod, n_pages=30), mod[0](page_size=4)
    cold = [100, 101, 102, 103, 104, 105, 106, 107]
    warm = list(range(8))
    _seed_prompt(log, pool, cache, 0, cold, free=True)
    warm_pages = _seed_prompt(log, pool, cache, 1, warm, free=True)
    _call(log, cache.match, warm)
    for n in (1, 1):
        _call(log, cache.evict, pool, n)
        _call(log, cache.match, cold, touch=False)
    _call(log, pool.allocate, 2, 8, shared=warm_pages)
    _call(log, cache.evict, pool, 10)
    _call(log, cache.flush, pool)
    _call(log, cache.match, warm)
    _call(log, pool.free, 2)
    log.append((cache.n_nodes, _pool_state(pool)))


def _shared_splice(mod, log):
    pool = _pool(mod)
    _call(log, pool.allocate, 0, 8)
    shared = [int(p) for p in pool.tables[0, :2]]
    _call(log, pool.allocate, 1, 12, shared=shared)
    log.append(_pool_state(pool))
    _call(log, pool.free, 0)
    _call(log, pool.free, 1)
    _call(log, pool.allocate, 2, 8, shared=shared)     # dead pages: raises
    log.append(_pool_state(pool))


def _cow(mod, log):
    pool = _pool(mod, n_pages=6, max_blocks=4)
    _call(log, pool.allocate, 0, 8)
    shared = [int(p) for p in pool.tables[0, :2]]
    _call(log, pool.allocate, 1, 8, shared=shared)
    _call(log, pool.free, 0)
    _call(log, pool.cow, 1, 0)                         # exclusive: None
    _call(log, pool.allocate, 0, 8, shared=[int(pool.tables[1, 0])])
    _call(log, pool.cow, 1, 0)
    _call(log, pool.allocate, 2, 6, shared=[int(pool.tables[1, 1])])
    _call(log, pool.cow, 1, 1)                         # no free page
    log.append(_pool_state(pool))


CASES = {"chunk_walk": _chunk_walk, "tail_hit": _tail_hit,
         "pure_probe": _pure_probe, "namespaces": _namespaces,
         "evict_and_flush": _evict_and_flush,
         "shared_splice": _shared_splice, "cow": _cow}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_and_pool_cases_identical(case):
    port, ref = [], []
    CASES[case](PORT, port)
    CASES[case](REF, ref)
    assert port == ref
    assert any(x not in (None, True) for x in port)   # something happened


def test_tree_cases_hold_the_references_outcomes():
    """A few of the reference's own asserts, on the port's records."""
    log = []
    _tail_hit(PORT, log)
    assert log[-1]["hits"] == 2 and log[-1]["hit_tokens"] == 6 + 4
    log = []
    _evict_and_flush(PORT, log)
    nodes, (_, free, refcounts, _, _, stats) = log[-1]
    assert nodes == 0 and stats["evictions"] == 2
    assert len(free) == 29 and not any(refcounts)


def _random_ops(mod, seed, n_ops=300):
    """A seeded sequence of allocations (spliced from a match half the
    time), adoptions, matches, evictions, frees and flushes over a small
    pool; the log holds every result and the pool's and tree's state."""
    rng = np.random.default_rng(seed)
    pool = mod[1](n_pages=24, page_size=4, n_slots=4, max_blocks=6)
    cache = mod[0](page_size=4, seed=seed)
    # prompts drawn from 3 templates so that prefixes repeat
    templates = [list(rng.integers(0, 5, 16)) for _ in range(3)]
    log, held = [], {}
    for _ in range(n_ops):
        kind = rng.choice(["allocate", "allocate", "match", "evict", "free",
                           "flush"], p=[0.3, 0.2, 0.2, 0.12, 0.15, 0.03])
        slot = int(rng.integers(4))
        if kind == "allocate":
            t = templates[int(rng.integers(3))]
            toks = t[:int(rng.integers(2, 17))] + \
                list(rng.integers(0, 5, int(rng.integers(0, 6))))
            toks = [int(x) for x in toks]
            shared = []
            if rng.random() < 0.5:
                shared = _call(log, cache.match, toks, tail=True)[0]
            if _call(log, pool.allocate, slot, len(toks),
                     shared=shared) is True:
                n_full = len(toks) // 4
                _call(log, cache.insert, toks,
                      [int(p) for p in pool.tables[slot, :n_full]], pool)
                held[slot] = toks
        elif kind == "match":
            toks = [int(x) for x in templates[int(rng.integers(3))]]
            _call(log, cache.match, toks[:int(rng.integers(1, 17))],
                  tail=bool(rng.random() < 0.5),
                  touch=bool(rng.random() < 0.8))
        elif kind == "evict":
            _call(log, cache.evict, pool, int(rng.integers(1, 4)))
        elif kind == "free":
            _call(log, pool.free, slot)
        else:
            _call(log, cache.flush, pool)
        log.append((_pool_state(pool), cache.stats()))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_tree_sequences_identical(seed):
    port, ref = _random_ops(PORT, seed), _random_ops(REF, seed)
    assert port == ref
    pool_stats, tree_stats = port[-1][0][5], port[-1][1]
    assert tree_stats["hits"] > 0 and pool_stats["evictions"] > 0


def test_sync_tables_fast_path_survives_refcount_motion():
    """Radix retain / release never bumps the pool's version, so the device
    block tables skip their upload; a table change (allocate / free / CoW)
    still uploads, in place."""
    _, _, _, tmodel, tparams = twin(FAMILY_ARCHS["transformer"])
    eng = ServeEngine(tmodel, tparams, batch_slots=2, max_seq=64,
                      paged=True, page_size=16, prefix_cache=True)
    st = eng.state
    assert st.pool.allocate(0, 20)
    st.sync_tables()
    ptr, v = st.tables_dev.data_ptr(), st.pool.version
    p = int(st.pool.tables[0, 0])
    st.pool.retain_page(p)                # radix adoption
    st.pool.release_page(p)               # eviction / flush
    assert st.pool.version == v == st._synced_version
    assert st.pool.allocate(1, 4)         # the table map changed
    st.sync_tables()
    assert st._synced_version == st.pool.version != v
    assert st.tables_dev.data_ptr() == ptr
    assert st.tables_dev[1, 0] == int(st.pool.tables[1, 0])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cow_copy_block_copies_in_place(kv_dtype):
    """The copy lands in the leaves' own storage (the captured graphs'
    addresses), payload and scale rows alike, and the device tables follow
    the swap."""
    _, _, _, tmodel, tparams = twin(FAMILY_ARCHS["transformer"])
    eng = ServeEngine(tmodel, tparams, batch_slots=2, max_seq=64,
                      paged=True, page_size=16, kv_dtype=kv_dtype)
    st = eng.state
    g = torch.Generator().manual_seed(0)
    for leaf in st.cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype))
    ptrs = {k: t.data_ptr() for k, t in st.cache.items()}
    assert st.pool.allocate(0, 32)
    shared = [int(p) for p in st.pool.tables[0, :2]]
    assert st.pool.allocate(1, 32, shared=shared)
    old = shared[1]
    assert cow_copy_block(st, 1, 1)
    new = int(st.pool.tables[1, 1])
    assert new != old and st.pool.cow_copies == 1
    for k, t in st.cache.items():
        assert t.data_ptr() == ptrs[k]
        assert torch.equal(t[:, new], t[:, old]), k
    assert sorted(st.cache) == (["k", "k_scale", "v", "v_scale"]
                                if kv_dtype else ["k", "v"])
    assert st.tables_dev[1, 1] == new
    assert not cow_copy_block(st, 1, 1)   # now exclusive: no copy


# ---------------------------------------------------------------------------
# the engine: a cached splice decodes like a cold admission
# ---------------------------------------------------------------------------

def _prefix_pair(cfg, rng):
    """(primer, test) prompts: the primer covers two full 16-token pages;
    the test prompt shares one full page plus a 4-token mid-page tail (the
    copy-on-write splice), then diverges."""
    primer = rng.integers(0, cfg.vocab_size, 36).astype(np.int32)
    test = np.concatenate([primer[:20],
                           rng.integers(0, cfg.vocab_size, 8)]) \
        .astype(np.int32)
    return primer, test


def _warm_and_admit(family, kv_dtype=None):
    """A prefix-cache engine primed with one request, then the sharing
    request admitted into it and (cold) into a cache-less twin.  Returns
    (model, params, warm engine, cold engine, (warm slot, cold slot))."""
    _, _, cfg, tmodel, tparams = twin(FAMILY_ARCHS[family])
    primer, test = _prefix_pair(cfg, np.random.default_rng(7))
    kw = dict(batch_slots=2, max_seq=64, paged=True, page_size=16,
              kv_dtype=kv_dtype)
    warm = ServeEngine(tmodel, tparams, prefix_cache=True, **kw)
    warm.generate([Request(uid=0, prompt=primer, max_new_tokens=4)])
    cold = ServeEngine(tmodel, tparams, **kw)
    for eng in (warm, cold):
        eng.submit([Request(uid=1, prompt=test, max_new_tokens=8)])
        eng._admit()
    st = warm.prefix_cache_stats()
    assert st["hit_tokens"] >= 20 and st["cow_copies"] == 1, st
    slots = tuple(next(s for s, r in enumerate(eng.scheduler.slots)
                       if r is not None and r.uid == 1)
                  for eng in (warm, cold))
    return tmodel, tparams, warm, cold, slots


def _stepwise_logits(model, params, eng, slot, n_steps):
    """Greedy decode ``n_steps`` from the admitted state (the engine's own
    cache, written in place); the logits row of ``slot`` at each step."""
    st = eng.state
    tok, pos = st.tokens.clone(), st.pos.clone()
    rows = []
    for _ in range(n_steps):
        logits, _ = model.decode_step(params, st.cache, tok, pos,
                                      block_tables=st.tables_dev)
        rows.append(np32(logits[slot]))
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1
    return rows


FAMILIES = ["transformer", "ssm", "hybrid"]


@pytest.mark.parametrize("family", FAMILIES)
def test_prefix_hit_decode_parity(family):
    """A cached splice (radix hit + copy-on-write tail) decodes within
    1e-5 of a cold prefill of the same prompt: the shared pages hold the
    K/V the cold engine recomputes."""
    model, params, warm, cold, (ws, cs) = _warm_and_admit(family)
    assert int(warm.state.tokens[ws]) == int(cold.state.tokens[cs])
    for lw, lc in zip(_stepwise_logits(model, params, warm, ws, 3),
                      _stepwise_logits(model, params, cold, cs, 3)):
        assert float(np.max(np.abs(lw - lc))) <= 1e-5, family


@pytest.mark.parametrize("family", FAMILIES)
def test_prefix_hit_decode_parity_int8(family):
    """The same on int8 pages: logits within 5e-2 and the greedy argmax
    equal (the shared pages carry the primer's payload and scales)."""
    model, params, warm, cold, (ws, cs) = _warm_and_admit(family, "int8")
    for lw, lc in zip(_stepwise_logits(model, params, warm, ws, 3),
                      _stepwise_logits(model, params, cold, cs, 3)):
        assert float(np.max(np.abs(lw - lc))) <= QUANT_TOL, family
        assert int(np.argmax(lw)) == int(np.argmax(lc)), family


# ---------------------------------------------------------------------------
# the engine end to end, against the cache off and the reference
# ---------------------------------------------------------------------------

def _shared_requests(cfg, n=6, templates=1):
    """The reference's end-to-end workload: prompts sharing 16, 20 or 24
    tokens of one base, then 6 unique ones; 5 new tokens each.  With more
    ``templates``, request i takes base i % templates, so that the tree
    holds more pages than a small pool can keep."""
    rng = np.random.default_rng(3)
    bases = [rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
             for _ in range(templates)]
    return [(i, np.concatenate([bases[i % templates][:16 + 4 * (i % 3)],
                                rng.integers(0, cfg.vocab_size, 6)])
             .astype(np.int32), 5) for i in range(n)]


# (engine settings, templates): bf16 and int8 pages over one template; a
# pool of 5 usable pages under three, where admissions must evict
RUNS = {"bf16": (dict(), 1), "int8": (dict(kv_dtype="int8"), 1),
        "evict": (dict(n_pages=6), 3)}
_RUNS = {}


def _run(name, family="transformer"):
    """The reference engine with the cache on, the port's with it on and
    off, each with a recording executor and a tracer; memoized."""
    if (name, family) not in _RUNS:
        model, params, cfg, tmodel, tparams = twin(FAMILY_ARCHS[family])
        settings, templates = RUNS[name]
        work = _shared_requests(cfg, templates=templates)
        kw = dict(batch_slots=2, max_seq=64, paged=True, page_size=16,
                  **settings)
        out = {}
        for key, cls, req, tr, m, p, cache in (
                ("ref", JaxEngine, JaxRequest, JaxTracer, model, params,
                 True),
                ("on", ServeEngine, Request, TorchTracer, tmodel, tparams,
                 True),
                ("off", ServeEngine, Request, TorchTracer, tmodel, tparams,
                 False)):
            ex, tracer = RecordingExecutor(), tr()
            eng = cls(m, p, prefix_cache=cache, executor=ex, tracer=tracer,
                      **kw)
            reqs = eng.generate([req(uid=u, prompt=pr, max_new_tokens=n)
                                 for u, pr, n in work])
            out[key] = (reqs, ex, tracer, eng)
        _RUNS[name, family] = out
    return _RUNS[name, family]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_engine_tokens_match_cache_off_and_reference(name):
    runs = _run(name)
    ref, on, off = (runs[k][0] for k in ("ref", "on", "off"))
    for r, t, o in zip(ref, on, off):
        assert t.generated == o.generated == r.generated, (name, t.uid)
        assert t.finished_step == r.finished_step, (name, t.uid)
    assert runs["on"][3].n_decode_steps == runs["ref"][3].n_decode_steps


@pytest.mark.parametrize("name", sorted(RUNS))
def test_engine_prefix_stats_match_reference(name):
    runs = _run(name)
    teng, jeng = runs["on"][3], runs["ref"][3]
    st = teng.prefix_cache_stats()
    assert st == jeng.prefix_cache_stats()
    assert st["hits"] >= (2 if name == "evict" else 4)
    assert st["hit_tokens"] > 0
    assert st["evictions"] >= (name == "evict")
    assert runs["off"][3].prefix_cache_stats() is None
    assert teng.state.pool.stats() == jeng.state.pool.stats()
    # every non-tree page returned; flushing the tree drains the pool
    teng.prefix_cache.flush(teng.state.pool)
    assert teng.state.pool.n_free == teng.state.pool.n_pages - 1


@pytest.mark.parametrize("name", ["bf16", "evict"])
def test_engine_trace_and_hooks_match_reference(name):
    runs = _run(name)
    (_, jex, jtr, _), (_, tex, ttr, _) = runs["ref"], runs["on"]
    assert tex.calls == jex.calls
    assert ttr.to_dict()["traceEvents"] == jtr.to_dict()["traceEvents"]
    assert any(e.get("name") == "prefix-hit"
               for e in ttr.to_dict()["traceEvents"])


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_other_families_serve_with_the_cache(family):
    """The SSM (whose pages only account) and the hybrid (whose shared
    block's K/V is paged) through the same engine: tokens and stats equal
    to the reference's with the cache on, and to the cache off."""
    runs = _run("bf16", family)
    ref, on, off = (runs[k][0] for k in ("ref", "on", "off"))
    for r, t, o in zip(ref, on, off):
        assert t.generated == o.generated == r.generated, (family, t.uid)
    assert runs["on"][3].prefix_cache_stats() \
        == runs["ref"][3].prefix_cache_stats()


def test_reset_empties_the_tree_and_repeats():
    _, _, cfg, tmodel, tparams = twin(FAMILY_ARCHS["transformer"])
    work = _shared_requests(cfg)
    eng = ServeEngine(tmodel, tparams, batch_slots=2, max_seq=64, paged=True,
                      page_size=16, prefix_cache=True)

    def run():
        reqs = eng.generate([Request(uid=u, prompt=p, max_new_tokens=n)
                             for u, p, n in work])
        return [r.generated for r in reqs], eng.prefix_cache_stats()

    first, stats = run()
    tree = eng.prefix_cache
    assert tree.n_nodes > 0
    eng.reset()
    assert eng.prefix_cache is not tree and eng.prefix_cache.n_nodes == 0
    assert eng.prefix_cache.stats()["lookup_tokens"] == 0
    assert eng.state.pool.n_free == eng.state.pool.n_pages - 1
    assert run() == (first, stats)


def test_requests_with_extras_still_raise():
    _, _, cfg, tmodel, tparams = twin(FAMILY_ARCHS["transformer"])
    eng = ServeEngine(tmodel, tparams, batch_slots=2, max_seq=64, paged=True,
                      prefix_cache=True)
    with pytest.raises(NotImplementedError, match="extras"):
        eng.generate([Request(uid=0, prompt=np.arange(8, dtype=np.int32),
                              extras={"frames": np.zeros((1, 2, 4))})])
    with pytest.raises(ValueError, match="paged=True"):
        ServeEngine(tmodel, tparams, prefix_cache=True)


def test_request_dataclass_is_the_references():
    """Both packages' requests carry the same fields, so one workload
    builds either."""
    assert [f.name for f in dataclasses.fields(Request)] \
        == [f.name for f in dataclasses.fields(JaxRequest)]


def test_eviction_spares_the_pages_being_spliced():
    """Under pool pressure the evictor may reach the very pages a request
    just matched (the tree's only leaves).  The reference evicts them and
    its splice then raises; the port holds them while the evictor runs, so
    the request waits for a slot's pages instead and is served as with the
    cache off."""
    model, params, cfg, tmodel, tparams = twin(FAMILY_ARCHS["transformer"])
    rng = np.random.default_rng(5)
    primer = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    work = [(1, rng.integers(0, cfg.vocab_size, 40).astype(np.int32), 8),
            (2, np.concatenate([primer, rng.integers(0, cfg.vocab_size, 16)])
             .astype(np.int32), 8)]
    kw = dict(batch_slots=2, max_seq=64, paged=True, page_size=16,
              n_pages=6)
    ref = JaxEngine(model, params, prefix_cache=True, **kw)
    ref.generate([JaxRequest(uid=0, prompt=primer, max_new_tokens=2)])
    with pytest.raises(ValueError, match="shared pages must be live"):
        ref.generate([JaxRequest(uid=u, prompt=p, max_new_tokens=n)
                      for u, p, n in work])
    out = {}
    for cache in (True, False):
        eng = ServeEngine(tmodel, tparams, prefix_cache=cache, **kw)
        eng.generate([Request(uid=0, prompt=primer, max_new_tokens=2)])
        out[cache] = [r.generated for r in eng.generate(
            [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in work])]
        if cache:
            st = eng.prefix_cache_stats()
            assert st["hit_tokens"] >= 32, st
    assert out[True] == out[False]
