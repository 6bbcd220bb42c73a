"""nemotron-4-340b in the port against the JAX package, on the CPU.

The smoke twin on the same weights in both packages (float32: 2 layers,
d_model 64, 4 query heads over 2 KV heads at head_dim 16, LayerNorm with
biases, the non-gated squared-ReLU MLP, RoPE): prefill logits and caches
(with and without ragged rows), decode over a dense cache and over f32 and
int8 pages, engine token streams and executor hooks against the JAX
engine, the loss and every gradient with remat on and off; the full-width
tree against the reference's ``abstract_params()``; ``init_params``'s
row-block draw of an unstacked leaf past ``DRAW_WHOLE_MAX`` values (the
full model's ``wte`` and ``head``).  The CUDA kernels the model reaches
(the flash forward and paged decode at head_dim 192 with 12 query heads
per KV head; LayerNorm runs no kernel) are held against the same plain
versions on the card by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_requests
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxEngine
from repro.serve.kv_pages import PagedBatchState as JaxPagedState
from repro.serve.kv_pages import write_prefill_pages as jax_write_pages
from repro_torch.configs import REGISTRY, card_smoke_config, get_config
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeEngine as TorchEngine
from repro_torch.serve.kv_pages import PagedBatchState as TorchPagedState
from repro_torch.serve.kv_pages import write_prefill_pages as torch_write_pages
from repro_torch.train import loss_and_grads
from repro_torch.tree import flatten
from torch_parity import (LOGITS_TOL, QUANT_TOL, RecordingExecutor, jref,
                          np32, twin)

ARCH = "nemotron-4-340b"
MAX_SEQ = 32
GRAD_RTOL = 1e-4     # of each leaf's largest |value| (test_torch_train.py)


def _prompts(seed=0, B=2, S=12):
    return np.random.default_rng(seed).integers(0, 257, (B, S)).astype(
        np.int32)


def _rel_err(got, ref) -> float:
    ref = np32(ref)
    return float(np.abs(np32(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# the config, the parameter tree, the row-block draw
# ---------------------------------------------------------------------------

def test_config_is_the_references():
    """The port's copy of ``configs/nemotron_4_340b.py``, field for field;
    its reduced card config runs the kernels' widths (LayerNorm, which
    runs none, and the squared-ReLU MLP stay)."""
    cfg = get_config(ARCH)
    assert REGISTRY[ARCH] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.norm, cfg.activation) == (18432, 96, 8, 192, "layer",
                                          "relu2")
    small = card_smoke_config(cfg)
    assert (small.d_model, small.resolved_head_dim, small.n_heads,
            small.n_kv_heads, small.norm) == (256, 64, 4, 2, "layer")


def test_full_width_shapes():
    """nemotron-4-340b at full width: every leaf of the reference's tree
    (341,029,195,776 parameters; wte and head of 256000 x 18432 each, 96
    layers of 3,454,083,072), and its cache (computed; nothing is
    allocated)."""
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
    assert sum(int(np.prod(s)) for s in tshapes.values()) \
        == 341_029_195_776
    per_layer = sum(int(np.prod(s[1:])) for k, s in tshapes.items()
                    if k.startswith("['layers']"))
    assert per_layer == 3_454_083_072
    assert np.prod(shapes["embed"]["wte"]) > transformer.DRAW_WHOLE_MAX
    assert tmodel._cache_struct(8, 1024)["k"].shape == (96, 8, 1024, 8, 192)


def test_init_draws_an_unstacked_leaf_past_the_limit_in_row_blocks(
        monkeypatch):
    """With ``DRAW_WHOLE_MAX`` lowered below an unstacked leaf (as the full
    model's ``wte``, 4.7e9 values, lies past 2^32), ``init_params`` draws
    it in blocks of whole rows, in order: the same values from the same
    seed, and, since each block is a whole number of the CPU generator's
    16-value chunks, the values of the one draw that a leaf under the limit
    takes; leaves under the limit are drawn whole as before."""
    shapes = {"embed": {"wte": (40, 32)}, "layers": {"w": (3, 32, 8)}}
    whole = transformer.init_params(shapes, lambda n: torch.float32, "cpu")
    monkeypatch.setattr(transformer, "DRAW_WHOLE_MAX", 12 * 32)
    parts = transformer.init_params(shapes, lambda n: torch.float32, "cpu")
    again = transformer.init_params(shapes, lambda n: torch.float32, "cpu")
    assert torch.equal(parts["embed"]["wte"], again["embed"]["wte"])
    assert torch.equal(parts["embed"]["wte"], whole["embed"]["wte"])
    assert torch.equal(parts["layers"]["w"], whole["layers"]["w"])
    # a block that is not whole chunks draws other values, so the blocks
    # above are 12 rows of 32 (and a last one of 4), not one draw
    monkeypatch.setattr(transformer, "DRAW_WHOLE_MAX", 13 * 24)
    odd = {"embed": {"wte": (40, 24)}}
    assert not torch.equal(
        transformer.init_params(odd, lambda n: torch.float32, "cpu")
        ["embed"]["wte"],
        torch.randn((40, 24), generator=torch.Generator().manual_seed(0))
        * 0.02)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens", [None, [12, 7]])
def test_prefill_logits_and_cache_match(lens):
    model, params, _, tmodel, tparams = twin(ARCH)
    toks = _prompts()
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = jref(model).prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                                 remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
                            **kw_t)
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape, key
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
    for key in ("k", "v"):
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


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
    return out, js, ts


def test_decode_paged_f32_pages_match():
    out, js, ts = _paged_pair(None)
    for jl, tl in out:
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np32(ts.cache[key]), np32(js.cache[key]),
                                   **LOGITS_TOL)


def test_decode_int8_pages_match():
    """Logits within ``QUANT_TOL`` and the same greedy tokens; scales and
    stored values within one quantization step."""
    out, js, ts = _paged_pair("int8")
    for jl, tl in out:
        assert float(np.abs(np32(tl) - np32(jl)).max()) <= QUANT_TOL
        assert np.array_equal(np32(tl).argmax(-1), np32(jl).argmax(-1))
    for key in ("k", "v"):
        np.testing.assert_allclose(np32(ts.cache[f"{key}_scale"]),
                                   np32(js.cache[f"{key}_scale"]),
                                   rtol=1e-4, atol=1e-7)
        assert np.abs(np32(ts.cache[key]) - np32(js.cache[key])).max() <= 1.0


# ---------------------------------------------------------------------------
# engine runs
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
def test_engine_token_streams_and_hooks_identical(name):
    (jreqs, jex, jeng), (treqs, tex, teng) = _run(name)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated, (name, j.uid)
        assert t.finished_step == j.finished_step, (name, j.uid)
    assert teng.n_decode_steps == jeng.n_decode_steps
    assert tex.calls == jex.calls


# ---------------------------------------------------------------------------
# training: the loss and every gradient
# ---------------------------------------------------------------------------

def _batch(B=2, S=24, seed=0):
    toks = np.random.default_rng(seed).integers(0, 257, (B, S + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_reference(remat):
    """The loss and every leaf's gradient, the LayerNorm biases'
    included."""
    model, params, _, tmodel, _ = twin(ARCH)
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    batch = _batch()
    (loss, _), grads = jref(model).loss_grad(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        remat=remat)
    tloss, _, tgrads = loss_and_grads(
        tmodel, masters, {k: torch.tensor(v) for k, v in batch.items()},
        remat=remat)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    ref = dict(flatten(jax.tree.map(np.asarray, grads)))
    got = flatten(tgrads)
    assert sorted(p for p, _ in got) == sorted(ref)
    assert "layers/norm_attn/bias" in ref
    for path, g in got:
        assert g.shape == ref[path].shape, path
        assert _rel_err(g, ref[path]) <= GRAD_RTOL, (path,
                                                     _rel_err(g, ref[path]))
