"""The engine's memoized hot-path entry points (CUDA graphs on the card)
against the JAX package's memoized ``jax.jit`` ones, on the CPU.

On the CPU the memo entries hold the same bodies the card captures, run
eagerly, so what a graph needs can be held here: the variant counts equal
the reference's ``compile_stats`` on the same request lists, before and
after ``reset()``; every state tensor keeps its storage across admission,
decode, table syncs and ``reset()``; a round that runs several chunks of
one length gives the reference's tokens; the launch counters take a
capture's delta back out and add it at each replay; sampling draws what
``torch.multinomial`` draws.
"""
import numpy as np
import pytest
import torch

from conftest import make_requests
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro_torch import kernels
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeEngine as TorchEngine
from repro_torch.serve import graphs, sample_token
from torch_parity import twin

LLAMA, MAMBA = "llama3.2-1b", "mamba2-370m"
# (arch, engine options) of each served configuration
CONFIGS = {
    "llama-dense": (LLAMA, dict()),
    "llama-paged": (LLAMA, dict(paged=True, page_size=16)),
    "llama-paged-int8": (LLAMA, dict(paged=True, page_size=16,
                                     kv_dtype="int8")),
    "mamba-dense": (MAMBA, dict()),
    "mamba-paged": (MAMBA, dict(paged=True, page_size=16)),
}


def _second_requests(cfg, req_cls):
    """A second workload with new variants: a 32-token bucket and budgets
    that need chunks the first list did not."""
    rng = np.random.default_rng(7)
    return [req_cls(uid=10 + i, prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(((20, 16), (6, 13), (30, 4)))]


def _to_torch(reqs):
    return [TorchRequest(uid=r.uid, prompt=r.prompt,
                         max_new_tokens=r.max_new_tokens) for r in reqs]


def _engines(arch, **kw):
    model, params, cfg, tmodel, tparams = twin(arch)
    return (cfg, JaxEngine(model, params, batch_slots=2, max_seq=64, **kw),
            TorchEngine(tmodel, tparams, batch_slots=2, max_seq=64, **kw))


@pytest.mark.parametrize("name", ["llama-dense", "llama-paged",
                                  "llama-paged-int8", "mamba-dense"])
def test_compile_stats_match_reference_across_reset(name):
    arch, kw = CONFIGS[name]
    cfg, jeng, teng = _engines(arch, **kw)
    assert teng.compile_stats == jeng.compile_stats
    for reqs in (make_requests(cfg), _second_requests(cfg, JaxRequest)):
        jreqs = jeng.generate(reqs)
        treqs = teng.generate(_to_torch(reqs))
        assert [t.generated for t in treqs] == [j.generated for j in jreqs]
        assert teng.compile_stats == jeng.compile_stats, name
        # the reference's bound (tests/test_paged_serve.py)
        stats = teng.compile_stats
        assert stats["decode_chunk_variants"] <= \
            int(np.log2(teng.max_chunk)) + 1
        jeng.reset()
        teng.reset()
        assert teng.compile_stats == jeng.compile_stats, name
    assert teng.compile_stats["n_variants"] > 0
    assert not teng.cuda_graphs          # a CPU model runs eagerly
    assert teng.graph_stats() == []


def _storage(eng):
    st = eng.state
    ptrs = {"tokens": st.tokens.data_ptr(), "pos": st.pos.data_ptr(),
            "remaining": st.remaining.data_ptr()}
    ptrs.update({f"cache/{k}": v.data_ptr() for k, v in st.cache.items()})
    if eng.paged:
        ptrs["tables_dev"] = st.tables_dev.data_ptr()
    return ptrs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_tensors_keep_their_storage(name):
    """The port's counterpart of the reference's
    ``test_decode_chunk_donates_cache_buffers``: a graph replays against
    fixed addresses, so admission, a decode round, a table sync after a
    release and ``reset()`` all write in place."""
    arch, kw = CONFIGS[name]
    _, _, cfg, tmodel, tparams = twin(arch)
    eng = TorchEngine(tmodel, tparams, batch_slots=2, max_seq=64, **kw)
    fresh = {k: v.clone() for k, v in eng.state.cache.items()}
    ptrs = _storage(eng)
    eng.submit(_to_torch(make_requests(cfg)))
    eng._admit()
    assert _storage(eng) == ptrs
    assert int(eng.state.remaining.sum()) > 0
    eng._decode_round()
    assert _storage(eng) == ptrs
    if eng.paged:
        eng._admit()                          # slots released: new tables
        assert eng.state._synced_version == eng.state.pool.version
        assert _storage(eng) == ptrs
    eng.run()
    assert _storage(eng) == ptrs
    eng.reset()
    assert _storage(eng) == ptrs
    # reset leaves what a fresh state holds
    st = eng.state
    assert not st.slot_vectors.any()
    for k, v in st.cache.items():
        assert torch.equal(v, fresh[k]), k
    if eng.paged:
        assert not st.tables_dev.any()
        assert st.pool.n_free == st.pool.n_pages - 1
        assert st._synced_version == st.pool.version


@pytest.mark.parametrize("name", ["llama-paged", "llama-dense",
                                  "mamba-dense"])
def test_round_of_equal_chunks_matches_reference(name):
    """``max_chunk=2`` and 9 new tokens (the first from the prefill): with
    an empty queue one round runs the 8 decode steps as chunks 2, 2, 2, 2,
    one memo entry called four times before the round's single sync;
    tokens, finish steps and variant counts equal the reference's."""
    arch, kw = CONFIGS[name]
    cfg, jeng, teng = _engines(arch, max_chunk=2, **kw)
    rng = np.random.default_rng(3)
    reqs = [JaxRequest(uid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                       max_new_tokens=9) for i, n in enumerate((7, 11))]
    jreqs = jeng.generate(reqs)
    treqs = teng.generate(_to_torch(reqs))
    for j, t in zip(jreqs, treqs):
        assert len(t.generated) == 9
        assert t.generated == j.generated, (name, j.uid)
        assert t.finished_step == j.finished_step
    assert teng.n_decode_steps == jeng.n_decode_steps == 8
    assert teng.compile_stats == jeng.compile_stats == {
        "decode_chunk_variants": 1, "prefill_bucket_variants": 2,
        "n_variants": 3}


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` at a replay."""

    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1


def test_replays_add_the_captured_launch_counts():
    """A replay adds the launches its capture counted (and took back out),
    so ``chip_smoke.py``'s exact gates keep their formulas."""
    call = graphs.GraphedCall(lambda: "eager", enabled=True)
    call.graph, call.outputs = _FakeGraph(), "static"
    call.launches = {"rmsnorm": 33, "paged_decode": 16}
    kernels.reset_launch_counts()
    try:
        assert call() == "static" and call() == "static"
        got = kernels.launch_counts()
        assert got["rmsnorm"] == 66 and got["paged_decode"] == 32
        assert got["ssd_scan"] == 0
        assert call.replays == call.graph.replayed == 2
        kernels.add_launch_counts({"rmsnorm": -66, "paged_decode": -32})
        assert set(kernels.launch_counts().values()) == {0}
    finally:
        kernels.reset_launch_counts()
    assert graphs.GraphedCall(lambda: "eager", enabled=False)() == "eager"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampling_draws_what_multinomial_draws(seed):
    """The capturable sampler takes the same draw from the same generator
    state as ``torch.multinomial`` with one sample."""
    logits = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(4, 512)).astype(np.float32))
    g = torch.Generator().manual_seed(seed)
    got = sample_token(logits, g, temperature=0.7)
    g.manual_seed(seed)
    probs = torch.softmax(logits / 0.7, dim=-1)
    want = torch.multinomial(probs, 1, generator=g)[:, 0].to(torch.int32)
    assert torch.equal(got, want)
    assert torch.equal(sample_token(logits, g), logits.argmax(-1).int())
