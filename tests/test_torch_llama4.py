"""llama4-scout-17b-a16e in the port against the JAX package, on the CPU.

The local/global attention of ``models/transformer.py``: local layers
attend over a window and keep ring caches (slot ``p % W`` holds position
p), the last layer of each group of ``global_attn_every`` is global.  Two
twins on the same weights in both packages (float32): the smoke config
(2 layers, one local at window 32 and one global; 4 experts, top-1, with
the shared expert) and a variant of 4 layers (two groups), built with
``dataclasses.replace`` on both packages' smoke configs.  For each:
prefill logits and every cache leaf with prompts past the window, decode
over a dense cache and over f32 and int8 pages across a ring wrap, the
loss and every gradient with remat on and off; on the 4-layer variant,
engine token streams and executor hooks against the JAX engine with
requests whose decode wraps a ring, and the wrapper calls a forward and a
step make.  ``common.gather_ring_window`` over ragged lengths; the
full-width tree against the reference's ``abstract_params()``.  The CUDA
kernels the model reaches (the flash forward with a window at head_dim
128, G 5, paged decode at (128, 5), RMSNorm at d 5120; the windowed flash
backward at the card smoke config's (64, 2)) are held against the same
plain versions on the card by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro.serve.kv_pages import PagedBatchState as JaxPagedState
from repro.serve.kv_pages import write_prefill_pages as jax_write_pages
from repro_torch.configs import REGISTRY, card_smoke_config, get_config, \
    smoke_config
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import prefill as tprefill
from repro_torch.models import build_model
from repro_torch.models import common as tcm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeEngine as TorchEngine
from repro_torch.serve.kv_pages import PagedBatchState as TorchPagedState
from repro_torch.serve.kv_pages import write_prefill_pages as torch_write_pages
from repro_torch.train import loss_and_grads
from repro_torch.tree import flatten
from torch_parity import (LOGITS_TOL, QUANT_TOL, RecordingExecutor, jref,
                          np32)

ARCH = "llama4-scout-17b-a16e"
MAX_SEQ = 64
GRAD_RTOL = 1e-4     # of each leaf's largest |value| (test_torch_train.py)
#: prompts past the smoke window of 32: row 1 wraps its ring at the
#: second decode step (positions 30, 31, 32, 33)
LENS = (40, 30)
LEAVES = ("k_local", "v_local", "k_global", "v_global")
TWINS = ("smoke", "two_groups")
_TWINS = {}


def twin(which):
    """(jax model, jax params, cfg, port model, port params), memoized: the
    conftest smoke model, or its config at 4 layers (two groups)."""
    if which not in _TWINS:
        if which == "smoke":
            model, params, cfg = smoke_model(ARCH)
        else:
            cfg = dataclasses.replace(jax_smoke_config(JAX_REGISTRY[ARCH]),
                                      compute_dtype="float32", n_layers=4)
            model = jax_build_model(cfg, block_k=16)
            params = model.init(jax.random.PRNGKey(0))
        tcfg = dataclasses.replace(smoke_config(get_config(ARCH)),
                                   compute_dtype="float32",
                                   n_layers=cfg.n_layers)
        tmodel = build_model(tcfg, block_k=16, device="cpu")
        tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params))
        _TWINS[which] = (model, params, cfg, tmodel, tparams)
    return _TWINS[which]


def _prompts(seed=0, B=2, S=40):
    return np.random.default_rng(seed).integers(0, 257, (B, S)).astype(
        np.int32)


def _rel_err(got, ref) -> float:
    ref = np32(ref)
    return float(np.abs(np32(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# the config, the parameter tree and the layer grouping
# ---------------------------------------------------------------------------

def test_config_is_the_references():
    """The port's copy of ``configs/llama4_scout_17b_a16e.py``, field for
    field; its smoke configs keep window 32 with a global layer every
    2nd, top-1 and the shared expert, and the card's runs (64, 2)."""
    cfg = get_config(ARCH)
    assert REGISTRY[ARCH] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert len(REGISTRY) == 11
    small = smoke_config(cfg)
    assert (small.attn_window, small.global_attn_every, small.moe.n_experts,
            small.moe.top_k, small.moe.shared_expert) == (32, 2, 4, 1, True)
    card = card_smoke_config(cfg)
    assert (card.d_model, card.resolved_head_dim, card.n_heads,
            card.n_kv_heads, card.attn_window) == (256, 64, 4, 2, 32)


def test_full_width_shapes_and_cache():
    """llama4-scout at full width: every leaf of the reference's tree
    (107,769,861,120 parameters; 48 layers, 12 groups of 3 local layers
    and a global one), the layer windows, and the cache of 8 slots at
    max_seq 16384 (computed; nothing is allocated): rings of 8192."""
    cfg = get_config(ARCH)
    tmodel = build_model(cfg, device="cpu")
    shapes = tmodel.param_shapes()
    jmodel = jax_build_model(jax_get_config(ARCH))
    ref = jmodel.abstract_params()
    jshapes = {jax.tree_util.keystr(p): tuple(leaf.shape) for p, leaf in
               jax.tree_util.tree_leaves_with_path(ref)}
    tshapes = {jax.tree_util.keystr(p): tuple(leaf) for p, leaf in
               jax.tree_util.tree_leaves_with_path(
                   shapes, is_leaf=lambda x: isinstance(x, tuple))}
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in tshapes.values()) \
        == 107_769_861_120
    assert (tmodel.group, tmodel.n_groups) == (jmodel.group, jmodel.n_groups) \
        == (4, 12)
    assert [tmodel._layer_window(i) for i in range(4)] \
        == [jmodel._layer_window(i) for i in range(4)] == [8192] * 3 + [0]
    st = tmodel._cache_struct(8, 16384)
    jst = jmodel._cache_struct(8, 16384)
    assert {k: s.shape for k, s in st.items()} \
        == {k: s.shape for k, s in jst.items()}
    assert st["k_local"].shape == (12, 3, 8, 8192, 8, 128)
    assert tmodel.paged_cache_keys() == jmodel.paged_cache_keys()
    assert tmodel.cache_slot_axes() == jmodel.cache_slot_axes()


@pytest.mark.parametrize("W", [4, 5])
def test_gather_ring_window_matches_reference(W):
    """Ring slot r holds each row's largest valid position congruent to r
    mod W, zeros where it is negative: rows shorter than, equal to and
    longer than W, and an empty row."""
    x = np.random.default_rng(3).normal(size=(5, 9, 2, 3)).astype(np.float32)
    lens = np.array([9, 3, W, W + 1, 0], np.int32)
    want = jcm.gather_ring_window(jnp.asarray(x), jnp.asarray(lens), W)
    got = tcm.gather_ring_window(torch.tensor(x), torch.tensor(lens), W)
    assert np.array_equal(np32(got), np.asarray(want))
    assert np.array_equal(np32(got)[0, 8 % W], x[0, 8])
    assert not np32(got)[4].any()


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", TWINS)
@pytest.mark.parametrize("lens", [None, list(LENS)])
def test_prefill_logits_and_cache_match(which, lens):
    """Logits and every cache leaf (rings and global K/V) over prompts of
    40 tokens, past the window of 32, with and without ragged rows."""
    model, params, _, tmodel, tparams = twin(which)
    toks = _prompts()
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = jref(model).prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                                 remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
                            **kw_t)
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    assert sorted(tc) == sorted(jc) == sorted(LEAVES)
    for key in LEAVES:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


@pytest.mark.parametrize("which", TWINS)
def test_decode_dense_cache_matches(which):
    """Four steps from a ragged prefill, row 1 wrapping its ring: logits
    each step and every leaf written in place."""
    model, params, _, tmodel, tparams = twin(which)
    lens = np.array(LENS, np.int32)
    jl, jc = jref(model).prefill(
        params, jnp.asarray(_prompts(1)), max_seq=MAX_SEQ, remat=False,
        prompt_lens=jnp.asarray(lens))
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), lens.copy()
    for _ in range(4):
        jl, jc = jref(model).decode_step(params, jc, jnp.asarray(tok),
                                         jnp.asarray(pos))
        tl, tc2 = tmodel.decode_step(tparams, tc, torch.tensor(tok),
                                     torch.tensor(pos))
        assert tc2 is tc
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    for key in LEAVES:
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


def _paged_pair(which, kv_dtype, lens=LENS, steps=4):
    """Prefill both packages' page pools (the global layers' K/V) through
    their own writers beside the dense rings, then step both decoders over
    the same tokens."""
    model, params, _, tmodel, tparams = twin(which)
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
    for key in ("k_global", "v_global"):
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
    for key in ("k_local", "v_local"):          # dense slot rows
        js.cache[key] = jsub[key]
        ts.cache[key].copy_(tsub[key])
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
    return out, js, ts


@pytest.mark.parametrize("which", TWINS)
def test_decode_paged_f32_pages_match(which):
    """Global K/V in f32 pages beside the dense rings: logits, the pools
    and the rings at ``LOGITS_TOL`` across row 1's ring wrap."""
    out, js, ts = _paged_pair(which, None)
    for jl, tl in out:
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in LEAVES:
        np.testing.assert_allclose(np32(ts.cache[key]), np32(js.cache[key]),
                                   **LOGITS_TOL)


@pytest.mark.parametrize("which", TWINS)
def test_decode_int8_pages_match(which):
    """Global K/V in int8 pages with per-(page, KV head) scales named after
    their leaves ("k_global_scale"): logits within ``QUANT_TOL`` and the
    same greedy tokens; scales and stored values within one quantization
    step; the rings stay unquantized."""
    out, js, ts = _paged_pair(which, "int8")
    for jl, tl in out:
        assert float(np.abs(np32(tl) - np32(jl)).max()) <= QUANT_TOL
        assert np.array_equal(np32(tl).argmax(-1), np32(jl).argmax(-1))
    assert sorted(ts.cache) == sorted(js.cache) == sorted(
        LEAVES + ("k_global_scale", "v_global_scale"))
    for key in ("k_global", "v_global"):
        np.testing.assert_allclose(np32(ts.cache[f"{key}_scale"]),
                                   np32(js.cache[f"{key}_scale"]),
                                   rtol=1e-4, atol=1e-7)
        assert np.abs(np32(ts.cache[key]) - np32(js.cache[key])).max() <= 1.0
    assert ts.cache["k_local"].dtype == torch.float32
    for key in ("k_local", "v_local"):
        assert float(np.abs(np32(ts.cache[key])
                            - np32(js.cache[key])).max()) <= QUANT_TOL


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------

CONFIGS = {"dense": dict(), "paged": dict(paged=True, page_size=16),
           "paged-int8": dict(paged=True, page_size=16, kv_dtype="int8")}
_RUNS = {}


def _requests(cls):
    """Six requests of 12, 30 and 40 tokens with 2-11 new ones: the
    40-token prompts pass the window in prefill, and the 30-token request
    with 11 new tokens wraps its rings in decode."""
    rng = np.random.default_rng(2)
    news = [3, 11, 2, 7, 5, 9]
    return [cls(uid=i, prompt=rng.integers(0, 257, [12, 30, 40][i % 3]),
                max_new_tokens=news[i]) for i in range(6)]


def _run(name):
    """Both engines on the 4-layer twin with a recording executor,
    memoized per configuration."""
    if name not in _RUNS:
        model, params, _, tmodel, tparams = twin("two_groups")
        out = []
        for eng_cls, m, p, req in ((JaxEngine, model, params, JaxRequest),
                                   (TorchEngine, tmodel, tparams,
                                    TorchRequest)):
            ex = RecordingExecutor()
            eng = eng_cls(m, p, batch_slots=2, max_seq=MAX_SEQ, executor=ex,
                          **CONFIGS[name])
            out.append((eng.generate(_requests(req)), ex, eng))
        _RUNS[name] = out
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_token_streams_and_hooks_identical(name):
    (jreqs, jex, jeng), (treqs, tex, teng) = _run(name)
    assert [t.generated for t in treqs] == [j.generated for j in jreqs]
    assert [t.finished_step for t in treqs] \
        == [j.finished_step for j in jreqs]
    assert all(t.done for t in treqs)
    assert teng.n_decode_steps == jeng.n_decode_steps
    assert tex.calls == jex.calls


# ---------------------------------------------------------------------------
# training: the loss and every gradient, the wrapper calls
# ---------------------------------------------------------------------------

def _batch(B=2, S=40, seed=0):
    toks = np.random.default_rng(seed).integers(0, 257, (B, S + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("which", TWINS)
@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_reference(which, remat):
    """Over 40 positions (the local layers' window of 32 masks): the loss
    with its aux terms and every leaf's gradient, the router's
    included."""
    model, params, _, tmodel, _ = twin(which)
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    batch = _batch()
    (loss, jmet), grads = jref(model).loss_grad(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        remat=remat)
    tloss, tmet, tgrads = loss_and_grads(
        tmodel, masters, {k: torch.tensor(v) for k, v in batch.items()},
        remat=remat)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    assert sorted(tmet) == sorted(jmet)
    ref = dict(flatten(jax.tree.map(np.asarray, grads)))
    got = flatten(tgrads)
    assert sorted(p for p, _ in got) == sorted(ref)
    assert "layers/moe/router" in ref
    for path, g in got:
        assert g.shape == ref[path].shape, path
        assert _rel_err(g, ref[path]) <= GRAD_RTOL, (path,
                                                     _rel_err(g, ref[path]))


def test_kernel_calls_per_forward_and_step(monkeypatch):
    """What ``chip_smoke.py``'s exact launch gates count for llama4-scout:
    2 RMSNorms a layer and the final one a forward; a prefill attention
    for every layer (the local ones with their window) a prefill; a paged
    decode for each global layer only a paged step (the rings' decode is
    plain PyTorch); a training micro-batch under remat n_layers attention
    forwards, n_layers more and 2 n_layers norms more in the recompute,
    n_layers backwards, each local one with its window."""
    _, params, cfg, tmodel, _ = twin("two_groups")
    L, n_global = cfg.n_layers, cfg.n_layers // cfg.global_attn_every
    calls = dict.fromkeys(("rmsnorm", "flash_prefill", "flash_bwd",
                           "paged_decode"), 0)
    windows = []
    for mod, attr, key in ((tcm, "rmsnorm", "rmsnorm"),
                           (tprefill, "_forward", "flash_prefill"),
                           (tops, "flash_attention_bwd", "flash_bwd"),
                           (tcm, "paged_flash_decode", "paged_decode")):
        def counted(*a, _fn=getattr(mod, attr), _key=key, **kw):
            calls[_key] += 1
            if _key == "flash_bwd":
                windows.append(a[7] if len(a) > 7 else kw.get("window"))
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    _paged_pair("two_groups", None, steps=1)     # one prefill, one step
    assert calls == {"rmsnorm": 2 * (2 * L + 1), "flash_prefill": L,
                     "flash_bwd": 0, "paged_decode": n_global}
    calls.update(dict.fromkeys(calls, 0))
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    loss_and_grads(tmodel, masters,
                   {k: torch.tensor(v) for k, v in _batch().items()},
                   remat=True)
    assert calls == {"rmsnorm": 2 * L + 1 + 2 * L, "flash_prefill": 2 * L,
                     "flash_bwd": L, "paged_decode": 0}
    assert sorted(windows) == [0] * n_global + [32] * (L - n_global)
