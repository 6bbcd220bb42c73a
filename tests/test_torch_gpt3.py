"""gpt3-xl, the paper's GPT-3 1.3B, in the port against the JAX package, on
the CPU.

The gpt3-xl smoke model (2 layers, d_model 64, learned positions,
LayerNorm, tanh GELU, an untied head; float32) on the same weights in both
packages: the full-width parameter tree, the bridge carrying ``wpe``,
prefill logits and every cache leaf (with and without ragged rows), decode
over a dense cache and over f32 and int8 page pools, whole engine runs
(token streams, finish steps, executor-hook calls; the prefix cache on
against off), the loss and every gradient with remat on and off, a few
``Trainer`` steps, the wrapper calls a forward and a training step make,
and the learned table's position bound, where the port raises and the
reference reads NaN.  The CUDA kernels the model reaches at head_dim 128
are held against the same plain versions on the card by ``chip_smoke.py``.
"""
import dataclasses
import json
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
from repro.serve import Request as JaxRequest
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
from torch_parity import (LOGITS_TOL, QUANT_TOL, RecordingExecutor, jref, np32,
                          twin)

ARCH = "gpt3-xl"
MAX_SEQ = 32
GRAD_RTOL = 1e-4     # of each leaf's largest |value| (test_torch_train.py)
CURVE_TOL = 1e-4     # Trainer losses, absolute (test_torch_train.py)


def _prompts(seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    _, _, cfg, _, _ = twin(ARCH)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _rel_err(got, ref) -> float:
    ref = np32(ref)
    return float(np.abs(np32(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# the config, the parameter tree and the bridge
# ---------------------------------------------------------------------------

def test_config_is_the_references():
    """The port's copy of ``configs/gpt3_xl.py``, field for field, in the
    registry; its reduced card config keeps the recipe at the kernels'
    widths."""
    cfg = get_config(ARCH)
    assert REGISTRY[ARCH] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert (cfg.positional, cfg.norm, cfg.activation, cfg.tie_embeddings) \
        == ("learned", "layer", "gelu", False)
    small = card_smoke_config(cfg)
    assert (small.d_model, small.resolved_head_dim, small.n_heads,
            small.n_kv_heads) == (256, 64, 4, 2)
    assert (small.positional, small.norm, small.activation) \
        == ("learned", "layer", "gelu")


def test_full_width_shapes():
    """gpt3-xl at full width: every leaf the reference's tree holds (1.418 B
    parameters: wte and head 50257 x 2048 each, wpe 2048 x 2048, 24 layers
    of 50,339,840, the final norm's scale and bias), and the cache the
    serving kernels read (computed from the config; nothing is
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
    assert shapes["embed"]["wpe"] == (2048, 2048)
    assert shapes["embed"]["head"] == (2048, 50257)
    assert shapes["layers"]["attn"]["wq"] == (24, 2048, 16, 128)
    assert shapes["layers"]["norm_attn"]["bias"] == (24, 2048)
    total = sum(int(np.prod(s)) for s in tshapes.values())
    assert total == 1_418_207_232
    per_layer = sum(int(np.prod(s[1:])) for k, s in tshapes.items()
                    if k.startswith("['layers']"))
    assert per_layer == 50_339_840
    assert tmodel._cache_struct(8, 1024)["k"].shape == (24, 8, 1024, 16, 128)


def test_params_from_jax_carries_the_position_table():
    """``wpe`` crosses over as the other embeddings do (in the compute
    dtype, equal values), and every leaf at the shape the port declares;
    a table of the wrong length raises."""
    _, params, cfg, tmodel, tparams = twin(ARCH)
    ref = jax.tree.map(np.asarray, params)
    assert np.array_equal(np32(tparams["embed"]["wpe"]), ref["embed"]["wpe"])
    assert tuple(tparams["embed"]["wpe"].shape) == (cfg.max_train_seq,
                                                    cfg.d_model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == tmodel.leaf_dtype(path[-1].key), path
    bad = jax.tree.map(np.asarray, params)
    bad["embed"]["wpe"] = bad["embed"]["wpe"][:64]
    with pytest.raises(ValueError, match="embed/wpe"):
        params_from_jax(tmodel, bad)


def test_init_draws_the_position_table_like_the_embeddings():
    """``init`` draws ``wpe`` at 0.02, as the reference's
    ``init_embedding`` does, and norm biases at zero."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, d_model=64,
                              n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                              vocab_size=257, max_train_seq=512)
    params = build_model(cfg, device="cpu").init()
    std = float(params["embed"]["wpe"].float().std())
    assert 0.018 < std < 0.022
    assert not bool(params["layers"]["norm_attn"]["bias"].any())


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens", [None, [12, 7]])
def test_prefill_logits_and_cache_match(lens):
    """Logits and both cache leaves, K/V padded to max_seq with zeros as the
    reference pads them; right-padded rows take positions from 0."""
    model, params, _, tmodel, tparams = twin(ARCH)
    toks = _prompts()
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = jref(model).prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                                 remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
                            **kw_t)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


def test_decode_dense_cache_matches():
    """Three steps from a ragged prefill: each slot adds ``wpe[pos]`` at its
    own position; logits each step and the cache written in place."""
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
        tl, tc2 = tmodel.decode_step(tparams, tc, torch.tensor(tok),
                                     torch.tensor(pos))
        assert tc2 is tc
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
    """Pages in the compute dtype (f32 here): logits and both pools at
    ``LOGITS_TOL``."""
    out, js, ts = _paged_pair(None)
    for jl, tl in out:
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np32(ts.cache[key]), np32(js.cache[key]),
                                   **LOGITS_TOL)


def test_decode_int8_pages_match():
    """int8 pages with per-(page, KV head) scales: logits within
    ``QUANT_TOL`` and the same greedy tokens; scales and stored values
    within one quantization step."""
    out, js, ts = _paged_pair("int8")
    for jl, tl in out:
        assert float(np.abs(np32(tl) - np32(jl)).max()) <= QUANT_TOL
        assert np.array_equal(np32(tl).argmax(-1), np32(jl).argmax(-1))
    for key in ("k", "v"):
        sc = np32(js.cache[f"{key}_scale"])
        np.testing.assert_allclose(np32(ts.cache[f"{key}_scale"]), sc,
                                   rtol=1e-4, atol=1e-7)
        diff = np.abs(np32(ts.cache[key]) - np32(js.cache[key]))
        assert diff.max() <= 1.0


# ---------------------------------------------------------------------------
# the learned table's position bound
# ---------------------------------------------------------------------------

def test_positions_past_the_table_raise_in_the_port():
    """A cache longer than ``wpe``'s rows raises at ``init_cache`` and so at
    engine construction (dense and paged), and a prompt or training batch
    longer than them raises at the embedding: on the card such an index
    would be a device-side assert."""
    _, _, cfg, tmodel, tparams = twin(ARCH)
    rows = cfg.max_train_seq
    assert tuple(tparams["embed"]["wpe"].shape)[0] == rows
    assert tmodel.init_cache(1, rows)["k"].shape[2] == rows
    with pytest.raises(ValueError, match="learned position table"):
        tmodel.init_cache(1, rows + 1)
    for kw in (dict(), dict(paged=True, page_size=16)):
        with pytest.raises(ValueError, match="learned position table"):
            TorchEngine(tmodel, tparams, batch_slots=2, max_seq=rows + 16,
                        **kw)
    toks = torch.zeros(1, rows + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="learned position table"):
        tmodel.loss(tparams, {"tokens": toks, "targets": toks})
    with pytest.raises(ValueError, match="learned position table"):
        tcm.embed_tokens(tparams["embed"], toks[:, :8], torch.float32,
                         pos_offset=rows - 4)


def test_the_reference_reads_nan_past_the_table():
    """The documented difference (ROADMAP queue 3): the reference's
    ``jnp.take`` fills a position past ``wpe`` with NaN instead of
    raising; at a slot parked at ``pos == rows`` its decode logits are NaN
    where the port's read the last row and stay finite (a parked slot's
    logits are never used)."""
    model, params, cfg, tmodel, tparams = twin(ARCH)
    rows = cfg.max_train_seq
    x = np.asarray(jcm.embed_tokens(params["embed"],
                                    jnp.zeros((1, 4), jnp.int32),
                                    jnp.float32, pos_offset=rows - 2))
    assert np.isfinite(x[0, :2]).all() and np.isnan(x[0, 2:]).all()
    tok = np.array([5], np.int32)
    pos = np.array([rows], np.int32)
    jl, _ = jref(model).decode_step(params, model.init_cache(1, rows),
                                    jnp.asarray(tok), jnp.asarray(pos))
    tl, _ = tmodel.decode_step(tparams, tmodel.init_cache(1, rows),
                               torch.tensor(tok), torch.tensor(pos))
    assert np.isnan(np32(jl)[:, :cfg.vocab_size]).all()
    assert bool(torch.isfinite(tl[:, :cfg.vocab_size]).all())


# ---------------------------------------------------------------------------
# engine runs: dense and paged, with and without EOS, the prefix cache
# ---------------------------------------------------------------------------

# token 109 is the first sampled token of two of the smoke requests, which
# then end at once
CONFIGS = {
    "dense": dict(),
    "paged": dict(paged=True, page_size=16),
    "paged-int8": dict(paged=True, page_size=16, kv_dtype="int8"),
    "dense-eos": dict(eos_token=109),
    "paged-eos": dict(paged=True, page_size=16, eos_token=109),
}
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
        assert t.done and j.done
    assert teng.n_decode_steps == jeng.n_decode_steps
    if "eos" in name:
        assert sum(len(t.generated) < t.max_new_tokens for t in treqs) == 2


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_executor_hook_identical(name):
    (_, jex, _), (_, tex, _) = _run(name)
    assert tex.calls == jex.calls
    assert tex.calls[-1] == ("finish",)


def test_prefix_cache_on_matches_off_and_reference():
    """Prompts sharing 16-24 tokens of one base through the radix prefix
    cache: the port's tokens with the cache on equal its tokens with the
    cache off and the reference's with the cache on, with the same hits
    and stats."""
    model, params, cfg, tmodel, tparams = twin(ARCH)
    rng = np.random.default_rng(3)
    base = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    work = [(i, np.concatenate([base[:16 + 4 * (i % 3)],
                                rng.integers(0, cfg.vocab_size, 6)])
             .astype(np.int32)) for i in range(6)]
    kw = dict(batch_slots=2, max_seq=64, paged=True, page_size=16)
    got = {}
    for key, eng_cls, req_cls, m, p, cache in (
            ("ref", JaxEngine, JaxRequest, model, params, True),
            ("on", TorchEngine, TorchRequest, tmodel, tparams, True),
            ("off", TorchEngine, TorchRequest, tmodel, tparams, False)):
        eng = eng_cls(m, p, prefix_cache=cache, **kw)
        reqs = eng.generate([req_cls(uid=u, prompt=pr, max_new_tokens=5)
                             for u, pr in work])
        got[key] = ([r.generated for r in reqs], eng.prefix_cache_stats())
    assert got["on"][0] == got["off"][0] == got["ref"][0]
    assert got["on"][1] == got["ref"][1]
    assert got["on"][1]["hits"] >= 4 and got["off"][1] is None


# ---------------------------------------------------------------------------
# the wrapper calls of a forward and of a training step
# ---------------------------------------------------------------------------

def _count_calls(monkeypatch):
    """Count the calls of each kernel wrapper the model reaches (the plain
    versions on the CPU, which count no launch): the forward, whether the
    serving entry or the training ``Function``'s, and the backward."""
    calls = dict.fromkeys(("rmsnorm", "flash_prefill", "flash_bwd",
                           "paged_decode"), 0)
    for mod, attr, key in ((tcm, "rmsnorm", "rmsnorm"),
                           (tprefill, "_forward", "flash_prefill"),
                           (tops, "flash_attention_bwd", "flash_bwd"),
                           (tcm, "paged_flash_decode", "paged_decode")):
        def counted(*a, _fn=getattr(mod, attr), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    return calls


def test_kernel_calls_per_forward_and_step(monkeypatch):
    """What ``chip_smoke.py``'s exact launch gates count, from the model's
    structure: no RMSNorm anywhere (LayerNorm); a prefill runs n_layers
    prefill attentions, a paged decode step n_layers paged decodes; a
    training micro-batch under remat n_layers forwards, n_layers more in
    the backward's recompute and n_layers backwards (remat off: no
    recompute)."""
    _, params, cfg, tmodel, tparams = twin(ARCH)
    L = cfg.n_layers
    calls = _count_calls(monkeypatch)
    tmodel.prefill(tparams, torch.tensor(_prompts()), max_seq=MAX_SEQ,
                   prompt_lens=torch.tensor([12, 7]))
    assert calls == {"rmsnorm": 0, "flash_prefill": L, "flash_bwd": 0,
                     "paged_decode": 0}
    calls.update(dict.fromkeys(calls, 0))
    _paged_pair(None, steps=1)                  # one prefill, one step
    assert calls == {"rmsnorm": 0, "flash_prefill": L, "flash_bwd": 0,
                     "paged_decode": L}
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    for remat, forwards in ((True, 2 * L), (False, L)):
        calls.update(dict.fromkeys(calls, 0))
        loss_and_grads(tmodel, masters, batch, remat=remat)
        assert calls == {"rmsnorm": 0, "flash_prefill": forwards,
                         "flash_bwd": L, "paged_decode": 0}, remat


# ---------------------------------------------------------------------------
# training: the loss and every gradient, the Trainer
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=24, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_reference(remat):
    """Loss, metrics and every leaf's gradient (``wpe``, the LayerNorm
    biases, the untied head included) against
    ``jax.value_and_grad(model.loss)``."""
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
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(tmetrics["ce_loss"]),
                               float(metrics["ce_loss"]), rtol=1e-6)
    ref = dict(flatten(jax.tree.map(np.asarray, grads)))
    got = flatten(tgrads)
    assert sorted(p for p, _ in got) == sorted(ref)
    assert "embed/wpe" in ref
    for path, g in got:
        assert g.shape == ref[path].shape, path
        assert _rel_err(g, ref[path]) <= GRAD_RTOL, (path,
                                                     _rel_err(g, ref[path]))
    # positions past the batch's 24 take no gradient, on both sides
    assert not np.abs(np32(dict(got)["embed/wpe"])[24:]).any()


STEPS, SEED = 4, 0
OPT = dict(lr=1e-2, warmup_steps=2, decay_steps=100)


def test_trainer_loss_curve_matches_reference():
    """Both ``Trainer``s on the same initial weights and data stream, 4
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
        jout = jt.run()

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
        tout = tt.run()
    assert [h["step"] for h in tt.history] == [h["step"] for h in jt.history] \
        == list(range(STEPS))
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=0,
                               atol=CURVE_TOL)
    assert tout["final_step"] == jout["final_step"] == STEPS


# ---------------------------------------------------------------------------
# the launcher and the DVFS plan at the paper's shape
# ---------------------------------------------------------------------------

def test_train_launcher_at_the_papers_shape_prints_the_references_lines(
        monkeypatch, capsys, tmp_path):
    """``launch.train --arch gpt3-xl --shape paper_gpt3xl`` (planned for
    the paper's 40 x 1024 tokens a step, trained at the smoke shape on the
    CPU) against the reference's launcher with the same flags: the model
    and plan lines and the executed DVFS totals."""
    import sys

    from repro.launch import train as jax_train
    from repro_torch.launch import train
    flags = ["--arch", ARCH, "--shape", "paper_gpt3xl", "--accum", "2",
             "--smoke", "--chip", "tpu-v5e", "--steps", "2"]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["train"] + flags
                        + ["--ckpt-dir", str(tmp_path / "jax")])
    jax_train.main()
    ref = capsys.readouterr().out.splitlines()
    out = train.main(flags + ["--ckpt-dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    assert port[:2] == ref[:2]
    assert port[0].startswith("[train] gpt3-xl-smoke x paper_gpt3xl-smoke")
    assert out["done"]["final_step"] == 2
    assert out["done"]["dvfs"] == json.loads(
        ref[-1][len("[train] done: "):])["dvfs"]


def test_h100_plan_at_the_papers_shape():
    """The plan ``chip_smoke.py``'s gpt3-xl window replays: the h100 chip
    model's train plan for gpt3-xl at ``paper_gpt3xl``, every phase's
    numbers finite."""
    from repro_torch.configs import get_shape
    from repro_torch.dvfs import DvfsSession
    with DvfsSession(chip="h100", tau=0.0) as sess:
        plan = sess.plan_train(get_config(ARCH),
                               shape=get_shape("paper_gpt3xl"))
    rows = plan.summary()["phases"]
    assert set(rows) == {"fwd", "bwd", "opt"}
    assert all(np.isfinite(v) for r in rows.values() for v in r.values()
               if isinstance(v, float))
