"""The MoE layer and granite-moe-1b-a400m in the port against the JAX
package, on the CPU.

``common.apply_moe`` against the reference's on the same weights and
inputs: training (capacity-bounded) and serving (every pair kept), each
activation, an expert that overflows its capacity, an exact tie in the
top-k, a shared expert; the pairs' ranks within their experts and the
dropped fraction equal, not close.  Then the granite smoke twin (2 layers,
d_model 64, 4 experts, top-2; float32) on the same weights in both
packages: the full-width parameter tree, the init scales, prefill logits
and caches, decode over a dense cache and over f32 and int8 pages, whole
engine runs (token streams and executor hooks), the loss with its aux
terms and every gradient (the router's included) with remat on and off,
a few ``Trainer`` steps, and the wrapper calls a forward and a training
step make.  The MoE layer's expert products are library GEMMs
(``torch._grouped_mm``); its attention and norms reach the kernels that
``chip_smoke.py`` holds against these plain versions on the card.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_requests
from repro.ckpt import CheckpointManager as JaxCheckpoints
from repro.configs import get_config as jax_get_config
from repro.data import DataPipeline as JaxPipeline
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.serve import ServeEngine as JaxEngine
from repro.serve.kv_pages import PagedBatchState as JaxPagedState
from repro.serve.kv_pages import write_prefill_pages as jax_write_pages
from repro.train import OptimizerConfig as JaxOptConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainerConfig as JaxTrainerConfig
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import REGISTRY, card_smoke_config, get_config
from repro_torch.data import DataPipeline
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import prefill as tprefill
from repro_torch.models import build_model
from repro_torch.models import common as tcm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeEngine as TorchEngine
from repro_torch.serve.kv_pages import PagedBatchState as TorchPagedState
from repro_torch.serve.kv_pages import write_prefill_pages as torch_write_pages
from repro_torch.train import OptimizerConfig, loss_and_grads, make_train_step
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.tree import flatten
from torch_parity import (F32_TOL, LOGITS_TOL, QUANT_TOL, RecordingExecutor,
                          jref, np32, twin)

ARCH = "granite-moe-1b-a400m"
MAX_SEQ = 32
GRAD_RTOL = 1e-4     # of each leaf's largest |value| (test_torch_train.py)
CURVE_TOL = 1e-4     # Trainer losses, absolute (test_torch_train.py)


def _rel_err(got, ref) -> float:
    ref = np32(ref)
    return float(np.abs(np32(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# the MoE layer alone
# ---------------------------------------------------------------------------

def _moe_params(rng, d, f, E, activation, shared, router_scale=0.3):
    p = {"router": rng.normal(size=(d, E)).astype(np.float32) * router_scale,
         "w_up": rng.normal(size=(E, d, f)).astype(np.float32) / np.sqrt(d),
         "w_down": rng.normal(size=(E, f, d)).astype(np.float32) / np.sqrt(f)}
    if activation == "swiglu":
        p["w_gate"] = rng.normal(size=(E, d, f)).astype(np.float32) \
            / np.sqrt(d)
    if shared:
        p["shared"] = {k: v[0] for k, v in p.items() if k != "router"}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _reference_ranks(x, router, K, E):
    """The reference's routing step by step (``apply_moe``'s own lines):
    top-k experts and each pair's rank within its expert."""
    logits = jnp.asarray(x).reshape(-1, x.shape[-1]) @ jnp.asarray(router)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    flat_e = top_e.reshape(-1)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - oh, flat_e[:, None],
                              axis=1)[:, 0]
    return np.asarray(top_e), np.asarray(pos)


def _both(p, x, **kw):
    jy, jaux = jcm.apply_moe(_tree(p, jnp.asarray), jnp.asarray(x), **kw)
    ty, taux = tcm.apply_moe(_tree(p, torch.tensor), torch.tensor(x), **kw)
    return (jy, jaux), (ty, taux)


def _check_layer(p, x, cf, **kw):
    """Output at ``F32_TOL``, aux terms, and the routing: top-k experts,
    ranks, kept pairs and the dropped fraction equal exactly."""
    (jy, jaux), (ty, taux) = _both(p, x, capacity_factor=cf, **kw)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(np32(ty), np32(jy), **F32_TOL)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=2e-6, err_msg=k)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    K, E = kw["top_k"], kw["n_experts"]
    T = x.shape[0] * x.shape[1]
    je, jpos = _reference_ranks(x, p["router"], K, E)
    _, _, _, te = tcm.route_top_k(torch.tensor(x).reshape(T, -1),
                                  torch.tensor(p["router"]), K)
    _, _, rank, counts = tcm.expert_ranks(te.reshape(-1), E)
    assert np.array_equal(te.numpy(), je)
    assert np.array_equal(rank.numpy(), jpos)
    assert np.array_equal(counts.numpy(), np.bincount(je.reshape(-1),
                                                      minlength=E))
    C = max(int(cf * T * K / E), 1) if kw.get("drop", True) else T * K
    keep = rank.numpy() < C
    assert np.array_equal(keep, jpos < C)
    # the mean as XLA takes it: the kept count times the f32 reciprocal
    assert float(taux["dropped_frac"]) == float(
        np.float32(1) - np.float32(keep.sum()) * np.float32(1 / keep.size))
    return keep


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu2"])
def test_apply_moe_matches_reference(activation, drop):
    rng = np.random.default_rng(0)
    B, S, d, f, E, K = 2, 24, 32, 48, 8, 3
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    p = _moe_params(rng, d, f, E, activation, False)
    keep = _check_layer(p, x, 1.0, n_experts=E, top_k=K,
                        activation=activation, shared_expert=False, drop=drop)
    assert keep.all() != drop          # capacity 1.0 drops some pairs


def test_apply_moe_overflowing_expert():
    """Every token's first choice is expert 0 (its router column is
    large): at capacity factor 1.25 expert 0 keeps its first C pairs in
    the flat order and drops the rest, as the reference does; serving
    keeps them all."""
    rng = np.random.default_rng(1)
    B, S, d, f, E, K = 2, 16, 32, 40, 4, 2
    x = np.abs(rng.normal(size=(B, S, d))).astype(np.float32)
    p = _moe_params(rng, d, f, E, "swiglu", False, router_scale=0.05)
    p["router"][:, 0] = 1.0
    kw = dict(n_experts=E, top_k=K, activation="swiglu", shared_expert=False)
    keep = _check_layer(p, x, 1.25, drop=True, **kw)
    C = int(1.25 * B * S * K / E)
    first = keep.reshape(B * S, K)[:, 0]
    assert first[:C].all() and not first[C:].any()
    assert _check_layer(p, x, 1.25, drop=False, **kw).all()


@pytest.mark.parametrize("drop", [True, False])
def test_apply_moe_exact_top_k_tie(drop):
    """Experts 1 and 2 have the same router column, so every token's
    probabilities tie exactly between them; with top-1 routing both
    packages pick the lower index (``lax.top_k``'s order), and with top-2
    both take expert 1 first."""
    rng = np.random.default_rng(2)
    B, S, d, f, E = 2, 12, 16, 24, 4
    x = np.abs(rng.normal(size=(B, S, d))).astype(np.float32)
    p = _moe_params(rng, d, f, E, "swiglu", False, router_scale=0.05)
    p["router"][:, 1] = 0.5
    p["router"][:, 2] = 0.5
    kw = dict(n_experts=E, activation="swiglu", shared_expert=False,
              drop=drop)
    for K in (1, 2):
        _check_layer(p, x, 1.25, top_k=K, **kw)
        _, _, _, te = tcm.route_top_k(torch.tensor(x).reshape(B * S, d),
                                      torch.tensor(p["router"]), K)
        assert (te[:, 0] == 1).all()
        if K == 2:
            assert (te[:, 1] == 2).all()


@pytest.mark.parametrize("drop", [True, False])
def test_apply_moe_shared_expert(drop):
    """llama4-style: a dense shared expert added to the routed output."""
    rng = np.random.default_rng(3)
    B, S, d, f, E, K = 2, 10, 32, 48, 4, 1
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    p = _moe_params(rng, d, f, E, "swiglu", True)
    _check_layer(p, x, 1.25, n_experts=E, top_k=K, activation="swiglu",
                 shared_expert=True, drop=drop)


def test_apply_moe_layer_grads_match_reference():
    """The layer's gradients (input, router, experts) in training mode,
    with drops, against ``jax.grad`` of the reference's output and aux."""
    rng = np.random.default_rng(4)
    B, S, d, f, E, K = 2, 16, 32, 40, 8, 2
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    w = rng.normal(size=(B, S, d)).astype(np.float32)
    p = _moe_params(rng, d, f, E, "swiglu", False)
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.0, activation="swiglu",
              shared_expert=False, drop=True)

    def jloss(p, x):
        y, aux = jcm.apply_moe(p, x, **kw)
        return (jnp.sum(y * w) + aux["load_balance"] + 0.1 * aux["router_z"])
    jg = jax.grad(jloss, argnums=(0, 1))(_tree(p, jnp.asarray),
                                         jnp.asarray(x))
    tp = _tree(p, lambda a: torch.tensor(a, requires_grad=True))
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tcm.apply_moe(tp, tx, **kw)
    ((y * torch.tensor(w)).sum() + aux["load_balance"]
     + 0.1 * aux["router_z"]).backward()
    assert _rel_err(tx.grad, jg[1]) <= GRAD_RTOL
    for k, t in tp.items():
        assert _rel_err(t.grad, jg[0][k]) <= GRAD_RTOL, k


# ---------------------------------------------------------------------------
# granite-moe-1b-a400m: the config, the tree, the init
# ---------------------------------------------------------------------------

def test_config_is_the_references():
    """The port's copy of ``configs/granite_moe_1b_a400m.py``, field for
    field, in the registry; its reduced card config keeps 4 experts, top-2,
    at the kernels' widths."""
    cfg = get_config(ARCH)
    assert REGISTRY[ARCH] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.shared_expert) \
        == (32, 8, False)
    small = card_smoke_config(cfg)
    assert (small.d_model, small.resolved_head_dim, small.n_heads,
            small.n_kv_heads, small.moe.n_experts, small.moe.top_k) \
        == (256, 64, 4, 2, 4, 2)


def test_full_width_shapes():
    """granite-moe-1b-a400m at full width: every leaf of the reference's
    tree (1,334,628,352 parameters; 24 layers of 53,512,192, the experts
    stacked (24, 32, 1024, 512)), nothing allocated."""
    cfg = get_config(ARCH)
    tmodel = build_model(cfg, device="cpu")
    shapes = tmodel.param_shapes()
    ref = jax_build_model(jax_get_config(ARCH)).abstract_params()
    jshapes = {jax.tree_util.keystr(p): tuple(leaf.shape) for p, leaf in
               jax.tree_util.tree_leaves_with_path(ref)}
    tshapes = {jax.tree_util.keystr(p): tuple(leaf) for p, leaf in
               jax.tree_util.tree_leaves_with_path(
                   shapes, is_leaf=lambda x: isinstance(x, tuple))}
    assert tshapes == jshapes
    moe = shapes["layers"]["moe"]
    assert moe["router"] == (24, 1024, 32)
    assert moe["w_gate"] == (24, 32, 1024, 512)
    assert moe["w_down"] == (24, 32, 512, 1024)
    assert "mlp" not in shapes["layers"]
    assert sum(int(np.prod(s)) for s in tshapes.values()) == 1_334_628_352
    assert tmodel.leaf_dtype("router") == torch.float32
    assert tmodel.leaf_dtype("w_gate") == torch.bfloat16


def test_init_scales_are_the_references():
    """The router at 0.02, the stacked experts' leaves at E^-0.5 (the
    per-layer leaf's first dim, as ``ParamBuilder`` draws them) in both
    packages, so random routing at full width is the reference's kind."""
    over = dict(n_layers=1, d_model=256, d_ff=128, vocab_size=257,
                n_heads=4, n_kv_heads=2, head_dim=64)
    tcfg = dataclasses.replace(get_config(ARCH), **over)
    jcfg = dataclasses.replace(jax_get_config(ARCH), **over)
    tp = build_model(tcfg, device="cpu").init(dtype=torch.float32)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    E = tcfg.moe.n_experts
    want = {"router": 0.02, "w_gate": E ** -0.5, "w_up": E ** -0.5,
            "w_down": E ** -0.5}
    for name, std in want.items():
        t = float(tp["layers"]["moe"][name].std())
        j = float(np.asarray(jp["layers"]["moe"][name]).std())
        assert abs(t - std) < 0.03 * std and abs(j - std) < 0.03 * std, name


# ---------------------------------------------------------------------------
# granite: prefill and decode
# ---------------------------------------------------------------------------

def _prompts(seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    _, _, cfg, _, _ = twin(ARCH)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("lens", [None, [12, 7]])
def test_prefill_logits_and_cache_match(lens):
    """Logits and both cache leaves; every routed pair kept (serving)."""
    model, params, _, tmodel, tparams = twin(ARCH)
    toks = _prompts()
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = jref(model).prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                                 remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
                            **kw_t)
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


def test_decode_dense_cache_matches():
    model, params, _, tmodel, tparams = twin(ARCH)
    lens = np.array([12, 7], np.int32)
    jl, jc = jref(model).prefill(
        params, jnp.asarray(_prompts(1)), max_seq=MAX_SEQ, remat=False,
        prompt_lens=jnp.asarray(lens))
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), lens.copy()
    for _ in range(3):
        jl, jc = jref(model).decode_step(params, jc, jnp.asarray(tok),
                                         jnp.asarray(pos))
        tl, _ = tmodel.decode_step(tparams, tc, torch.tensor(tok),
                                   torch.tensor(pos))
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1


def _paged_pair(kv_dtype, lens=(12, 7), steps=3):
    """Prefill both packages' page pools through their own writers, then
    step both decoders over the same tokens."""
    model, params, _, tmodel, tparams = twin(ARCH)
    toks = _prompts(2)
    B, page = len(lens), 16
    js = JaxPagedState(model, B, MAX_SEQ, page_size=page, kv_dtype=kv_dtype)
    ts = TorchPagedState(tmodel, B, MAX_SEQ, page_size=page,
                         kv_dtype=kv_dtype)
    for st in (js, ts):
        for b, n in enumerate(lens):
            st.pool.allocate(b, n + steps)
        st.sync_tables()
    tables_sub = js.pool.tables.copy()
    for b in range(B):
        tables_sub[b, js.pool.n_blocks[b]:] = js.pool.n_pages
    jl, jsub = jref(model).prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                                   remat=False, prompt_lens=jnp.asarray(lens))
    _, tsub = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
                             prompt_lens=torch.tensor(lens))
    for key in ("k", "v"):
        sk = f"{key}_scale"
        if sk in js.cache:
            js.cache[key], js.cache[sk] = jax_write_pages(
                js.cache[key], jsub[key], jnp.asarray(tables_sub),
                scales=js.cache[sk], qmax=127.0)
            torch_write_pages(ts.cache[key], tsub[key], tables_sub,
                              scales=ts.cache[sk], qmax=127.0)
        else:
            js.cache[key] = jax_write_pages(js.cache[key], jsub[key],
                                            jnp.asarray(tables_sub))
            torch_write_pages(ts.cache[key], tsub[key], tables_sub)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    out = []
    for _ in range(steps):
        jl, js.cache = jref(model).decode_step(
            params, js.cache, jnp.asarray(tok), jnp.asarray(pos),
            block_tables=js.tables_dev)
        tl, ts.cache = tmodel.decode_step(tparams, ts.cache,
                                          torch.tensor(tok), torch.tensor(pos),
                                          block_tables=ts.tables_dev)
        out.append((jl, tl))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_paged_matches(kv_dtype):
    """f32 pages at ``LOGITS_TOL``; int8 pages within ``QUANT_TOL`` with the
    same greedy tokens."""
    for jl, tl in _paged_pair(kv_dtype):
        if kv_dtype is None:
            np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
        else:
            assert float(np.abs(np32(tl) - np32(jl)).max()) <= QUANT_TOL
            assert np.array_equal(np32(tl).argmax(-1), np32(jl).argmax(-1))


# ---------------------------------------------------------------------------
# granite: engine runs
# ---------------------------------------------------------------------------

CONFIGS = {"dense": dict(), "paged": dict(paged=True, page_size=16),
           "paged-int8": dict(paged=True, page_size=16, kv_dtype="int8")}
_RUNS = {}


def _run(name):
    """Both engines over ``conftest.make_requests`` with a recording
    executor, memoized per configuration."""
    if name not in _RUNS:
        model, params, cfg, tmodel, tparams = twin(ARCH)
        out = []
        for eng_cls, m, p, to_req in (
                (JaxEngine, model, params, lambda r: r),
                (TorchEngine, tmodel, tparams,
                 lambda r: TorchRequest(uid=r.uid, prompt=r.prompt,
                                        max_new_tokens=r.max_new_tokens))):
            ex = RecordingExecutor()
            eng = eng_cls(m, p, batch_slots=2, max_seq=64, executor=ex,
                          **CONFIGS[name])
            reqs = eng.generate([to_req(r) for r in make_requests(cfg)])
            out.append((reqs, ex, eng))
        _RUNS[name] = out
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_token_streams_identical(name):
    (jreqs, _, jeng), (treqs, _, teng) = _run(name)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated, (name, j.uid)
        assert t.finished_step == j.finished_step, (name, j.uid)
    assert teng.n_decode_steps == jeng.n_decode_steps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_executor_hook_identical(name):
    (_, jex, _), (_, tex, _) = _run(name)
    assert tex.calls == jex.calls


# ---------------------------------------------------------------------------
# granite: the loss with its aux terms, every gradient, the Trainer
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=24, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_reference(remat):
    """Loss (cross entropy plus the weighted load balance and router
    z-loss), the three aux metrics, and every leaf's gradient, the
    router's included, against ``jax.value_and_grad(model.loss)``.  The
    layer-mean dropped fraction counts the same dropped pairs; its last
    bit may differ, since XLA fuses the reference's ``1 - mean`` into one
    FMA inside the jitted loss (its eager ``apply_moe``, which the port
    matches bit for bit above, does not)."""
    model, params, cfg, tmodel, _ = twin(ARCH)
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    batch = _batch(cfg)
    (loss, metrics), grads = jref(model).loss_grad(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        remat=remat)
    tloss, tmetrics, tgrads = loss_and_grads(
        tmodel, masters, {k: torch.tensor(v) for k, v in batch.items()},
        remat=remat)
    assert sorted(tmetrics) == sorted(metrics) == [
        "ce_loss", "dropped_frac", "load_balance", "loss", "router_z"]
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    for k in ("ce_loss", "load_balance", "router_z"):
        np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    T, K, L = 2 * 24, cfg.moe.top_k, cfg.n_layers
    np.testing.assert_allclose(float(tmetrics["dropped_frac"]),
                               float(metrics["dropped_frac"]), rtol=1e-6)
    assert round(float(tmetrics["dropped_frac"]) * T * K * L) \
        == round(float(metrics["dropped_frac"]) * T * K * L) > 0
    ref = dict(flatten(jax.tree.map(np.asarray, grads)))
    got = flatten(tgrads)
    assert sorted(p for p, _ in got) == sorted(ref)
    assert "layers/moe/router" in ref
    for path, g in got:
        assert g.shape == ref[path].shape, path
        assert np.abs(np32(g)).max() > 0, path
        assert _rel_err(g, ref[path]) <= GRAD_RTOL, (path,
                                                     _rel_err(g, ref[path]))


STEPS, SEED = 3, 0
OPT = dict(lr=1e-2, warmup_steps=2, decay_steps=100)


def test_trainer_loss_curve_matches_reference():
    """Both ``Trainer``s on the same initial weights and data stream, 3
    steps of 2 micro-batches with remat: the same losses."""
    model, _, cfg, tmodel, _ = twin(ARCH)
    jax_params = model.init(jax.random.split(jax.random.PRNGKey(SEED))[0])
    tree = jax.tree.map(np.asarray, jax_params)
    tcfg = dict(total_steps=STEPS, ckpt_every=STEPS)
    with tempfile.TemporaryDirectory() as d:
        jt = JaxTrainer(
            model, jax_make_train_step(model, JaxOptConfig(**OPT),
                                       accum_steps=2, remat=True),
            JaxPipeline(cfg.vocab_size, 4, 16), JaxCheckpoints(d, keep=1),
            JaxTrainerConfig(**tcfg), seed=SEED)
        jt.run()

    class Carried(type(tmodel)):
        """The port's DecoderLM whose ``init`` returns the JAX trainer's
        initial parameters (fresh copies: the port updates in place)."""

        def init(self, generator=None, dtype=None):
            return params_from_jax(self, tree, dtype)

    carried = Carried(cfg, block_k=16, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        tt = Trainer(
            carried, make_train_step(carried, OptimizerConfig(**OPT),
                                     accum_steps=2, remat=True),
            DataPipeline(cfg.vocab_size, 4, 16), CheckpointManager(d, keep=1),
            TrainerConfig(**tcfg), seed=SEED)
        tt.run()
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=0,
                               atol=CURVE_TOL)


def test_kernel_calls_per_forward_and_step(monkeypatch):
    """What ``chip_smoke.py``'s exact launch gates count for granite: two
    RMSNorms a layer and the final one a forward, n_layers prefill
    attentions a prefill, n_layers paged decodes a paged step; a training
    micro-batch under remat n_layers attention forwards, n_layers more in
    the recompute, n_layers backwards, and its norms twice but the final
    one.  The MoE layer launches none of the port's kernels."""
    _, params, cfg, tmodel, tparams = twin(ARCH)
    L = cfg.n_layers
    calls = dict.fromkeys(("rmsnorm", "flash_prefill", "flash_bwd"), 0)
    for mod, attr, key in ((tcm, "rmsnorm", "rmsnorm"),
                           (tprefill, "_forward", "flash_prefill"),
                           (tops, "flash_attention_bwd", "flash_bwd")):
        def counted(*a, _fn=getattr(mod, attr), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    tmodel.prefill(tparams, torch.tensor(_prompts()), max_seq=MAX_SEQ)
    assert calls == {"rmsnorm": 2 * L + 1, "flash_prefill": L,
                     "flash_bwd": 0}
    calls.update(dict.fromkeys(calls, 0))
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    loss_and_grads(tmodel, masters, batch, remat=True)
    assert calls == {"rmsnorm": 2 * L + 1 + 2 * L, "flash_prefill": 2 * L,
                     "flash_bwd": L}
