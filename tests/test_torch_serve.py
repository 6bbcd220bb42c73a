"""The port's serving stack against the JAX package's, on the CPU: the page
allocator op by op, and whole engine runs (token streams, finish steps,
executor-hook calls and trace events) on the llama3.2-1b smoke config."""
import numpy as np
import pytest

from conftest import make_requests
from repro.obs import Tracer as JaxTracer
from repro.serve import ServeEngine as JaxEngine
from repro.serve.kv_pages import PagePool as JaxPool
from repro_torch.obs import Tracer as TorchTracer
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeEngine as TorchEngine
from repro_torch.serve.kv_pages import PagePool as TorchPool
from torch_parity import RecordingExecutor, twin

# ---------------------------------------------------------------------------
# PagePool: identical state after every op of a random sequence
# ---------------------------------------------------------------------------


def _pool_state(pool):
    return (pool.tables.tolist(), list(pool._free), pool.refcounts.tolist(),
            pool.n_blocks.tolist(), pool.version, pool.stats())


def _apply(pool, op):
    kind, args = op
    try:
        return ("ok", getattr(pool, kind)(*args))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def _random_ops(rng, n_ops, n_slots, n_pages):
    for _ in range(n_ops):
        kind = rng.choice(["allocate", "allocate", "free", "retain_page",
                           "release_page", "cow"])
        slot = int(rng.integers(n_slots))
        if kind == "allocate":
            n_tok = int(rng.integers(1, 70))
            shared = [int(p) for p in rng.choice(
                np.arange(1, n_pages), size=int(rng.integers(0, 3)),
                replace=False)] if rng.random() < 0.3 else []
            yield kind, (slot, n_tok, shared)
        elif kind == "free":
            yield kind, (slot,)
        elif kind in ("retain_page", "release_page"):
            yield kind, (int(rng.integers(0, n_pages)),)
        else:
            yield kind, (slot, int(rng.integers(0, 5)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_random_ops_identical(seed):
    rng = np.random.default_rng(seed)
    n_slots, n_pages = 4, 24
    ref = JaxPool(n_pages, 16, n_slots, max_blocks=5)
    port = TorchPool(n_pages, 16, n_slots, max_blocks=5)
    for i, op in enumerate(_random_ops(rng, 400, n_slots, n_pages)):
        assert _apply(port, op) == _apply(ref, op), (i, op)
        assert _pool_state(port) == _pool_state(ref), (i, op)


# ---------------------------------------------------------------------------
# engine runs: dense, paged, int8 paged; with and without EOS
# ---------------------------------------------------------------------------

# token 174 ends two of the smoke requests early, one in mid-chunk
CONFIGS = {
    "dense": dict(),
    "paged": dict(paged=True, page_size=16),
    "paged-int8": dict(paged=True, page_size=16, kv_dtype="int8"),
    "dense-eos": dict(eos_token=174),
    "paged-eos": dict(paged=True, page_size=16, eos_token=174),
    "paged-int8-eos": dict(paged=True, page_size=16, kv_dtype="int8",
                           eos_token=174),
}
_RUNS = {}


def _run(name):
    """Both engines over ``conftest.make_requests`` with a recording
    executor and a tracer, memoized per configuration."""
    if name not in _RUNS:
        model, params, cfg, tmodel, tparams = twin()
        out = []
        for eng_cls, tr_cls, m, p, to_req in (
                (JaxEngine, JaxTracer, model, params, lambda r: r),
                (TorchEngine, TorchTracer, tmodel, tparams,
                 lambda r: TorchRequest(uid=r.uid, prompt=r.prompt,
                                        max_new_tokens=r.max_new_tokens))):
            ex, tracer = RecordingExecutor(), tr_cls()
            eng = eng_cls(m, p, batch_slots=2, max_seq=64, executor=ex,
                          tracer=tracer, **CONFIGS[name])
            reqs = eng.generate([to_req(r) for r in make_requests(cfg)])
            out.append((reqs, ex, tracer, eng))
        _RUNS[name] = out
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_token_streams_identical(name):
    (jreqs, _, _, jeng), (treqs, _, _, teng) = _run(name)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated, (name, j.uid)
        assert t.finished_step == j.finished_step, (name, j.uid)
        assert t.done and j.done
    assert teng.n_decode_steps == jeng.n_decode_steps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_executor_hook_identical(name):
    (_, jex, _, jeng), (_, tex, _, teng) = _run(name)
    assert tex.calls == jex.calls
    assert tex.calls[-1] == ("finish",)
    assert teng.energy_summary() == jeng.energy_summary()


@pytest.mark.parametrize("name", ["dense", "paged-int8-eos"])
def test_engine_trace_events_identical(name):
    (_, _, jtr, _), (_, _, ttr, _) = _run(name)
    assert ttr.events == jtr.events
    assert ttr.to_dict()["traceEvents"] == jtr.to_dict()["traceEvents"]


def test_reference_dvfs_executor_plugs_in_unchanged():
    """The JAX package's own governor executor, planned once, replays the
    same phases and books the same energy behind both engines; the port's
    books tie out in the reference's energy ledger."""
    from repro.configs import REGISTRY, ShapeConfig
    from repro.dvfs import DvfsSession
    from repro.obs.ledger import check_executor
    model, params, cfg, tmodel, tparams = twin()
    pre = ShapeConfig(name="p", seq_len=64, global_batch=1, kind="prefill")
    dec = ShapeConfig(name="d", seq_len=64, global_batch=2, kind="decode")
    with DvfsSession(chip="tpu-v5e", tau=0.01, n_reps=2) as sess:
        sess.plan_serve(REGISTRY["llama3.2-1b"], n_slots=2,
                        prefill_shape=pre, decode_shape=dec)
        jex, tex = sess.serve_executor(), sess.serve_executor()
        JaxEngine(model, params, batch_slots=2, max_seq=64, paged=True,
                  executor=jex).generate(make_requests(cfg))
        port = TorchEngine(tmodel, tparams, batch_slots=2, max_seq=64,
                           paged=True, executor=tex)
        port.generate([TorchRequest(uid=r.uid, prompt=r.prompt,
                                    max_new_tokens=r.max_new_tokens)
                       for r in make_requests(cfg)])
    assert port.energy_summary() == jex.summary()
    assert port.energy_summary()["totals"]["energy_j"] > 0
    assert check_executor(tex) == []


def test_temperature_run_repeats_after_reset():
    _, _, cfg, tmodel, tparams = twin()
    eng = TorchEngine(tmodel, tparams, batch_slots=2, max_seq=64,
                      temperature=0.9, seed=3, paged=True)

    def run():
        reqs = [TorchRequest(uid=r.uid, prompt=r.prompt,
                             max_new_tokens=r.max_new_tokens)
                for r in make_requests(cfg)]
        return [r.generated for r in eng.generate(reqs)]

    first = run()
    eng.reset()
    assert run() == first
    greedy = TorchEngine(tmodel, tparams, batch_slots=2, max_seq=64,
                         paged=True)
    assert [r.generated for r in greedy.generate(
        [TorchRequest(uid=r.uid, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens)
         for r in make_requests(cfg)])] != first


def test_engine_rejects_what_is_not_ported():
    _, _, _, tmodel, tparams = twin()
    with pytest.raises(NotImplementedError, match="extras"):
        TorchEngine(tmodel, tparams, paged=True, prefix_cache=True).generate(
            [TorchRequest(uid=0, prompt=np.arange(8, dtype=np.int32),
                          extras={"frames": np.zeros((1, 2, 4))})])
    with pytest.raises(ValueError, match="paged=True"):
        TorchEngine(tmodel, tparams, prefix_cache=True)
    with pytest.raises(ValueError):
        TorchEngine(tmodel, tparams, kv_dtype="int8")
    assert TorchEngine(tmodel, tparams).compile_stats["n_variants"] == 0
