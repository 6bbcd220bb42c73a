"""internvl2-1b in the port against the JAX package, on the CPU.

The VLM family is the dense decoder behind a prefix of precomputed patch
embeddings (the ViT is a stub in both packages).  Two twins on the same
weights in both packages (float32): the smoke config (2 layers, d_model
64, 4 query heads over 2 KV heads at head_dim 16, 8 patch rows) and a
variant with the full model's head geometry, head_dim 64 with 7 query
heads per KV head (14 over 2), built with ``dataclasses.replace`` on both
packages' smoke configs.  For each: prefill logits and caches with patch
rows and per-row prompt lengths, decode over a dense cache and over f32
and int8 pages, engine token streams and executor hooks with
``conftest.make_requests``' patch rows, the loss over the text positions
and every gradient with remat on and off, and the wrapper calls a forward
and a training step make; text-only and patch requests sharing a bucket,
the prefix cache on against off with patch requests, a few ``Trainer``
steps and the serve launcher with ``--smoke`` on the variant or the smoke
config; the full-width tree against the reference's ``abstract_params()``.
The CUDA kernels the model reaches (head_dim 64 at G 7; RMSNorm at d 896)
are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_requests, smoke_model
from repro.ckpt import CheckpointManager as JaxCheckpoints
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataPipeline as JaxPipeline
from repro.launch import serve as jax_serve
from repro.models import build_model as jax_build_model
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro.serve.kv_pages import PagedBatchState as JaxPagedState
from repro.serve.kv_pages import write_prefill_pages as jax_write_pages
from repro.train import OptimizerConfig as JaxOptConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainerConfig as JaxTrainerConfig
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import REGISTRY, card_smoke_config, get_config, \
    smoke_config
from repro_torch.data import DataPipeline
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import prefill as tprefill
from repro_torch.launch import serve
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
from torch_parity import LOGITS_TOL, QUANT_TOL, RecordingExecutor, jref, np32

ARCH = "internvl2-1b"
MAX_SEQ = 48
GRAD_RTOL = 1e-4     # of each leaf's largest |value| (test_torch_train.py)
CURVE_TOL = 1e-4     # Trainer losses, absolute (test_torch_train.py)
#: the full model's head geometry at smoke width: head_dim 64, 7 query
#: heads per KV head
G7 = dict(n_heads=14, n_kv_heads=2, head_dim=64)
TWINS = ("smoke", "g7")
_TWINS = {}


def twin(which):
    """(jax model, jax params, cfg, port model, port params), memoized: the
    conftest smoke model, or the smoke config with ``G7``'s heads."""
    if which not in _TWINS:
        if which == "smoke":
            model, params, cfg = smoke_model(ARCH)
        else:
            cfg = dataclasses.replace(jax_smoke_config(JAX_REGISTRY[ARCH]),
                                      compute_dtype="float32", **G7)
            model = jax_build_model(cfg, block_k=16)
            params = model.init(jax.random.PRNGKey(0))
        tcfg = dataclasses.replace(smoke_config(get_config(ARCH)),
                                   compute_dtype="float32",
                                   **(G7 if which == "g7" else {}))
        tmodel = build_model(tcfg, block_k=16, device="cpu")
        tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params))
        _TWINS[which] = (model, params, cfg, tmodel, tparams)
    return _TWINS[which]


def _prompts(seed=0, B=2, S=12):
    return np.random.default_rng(seed).integers(0, 257, (B, S)).astype(
        np.int32)


def _patches(cfg, seed=0, B=2):
    """Seeded patch rows (B, vision_prefix_len, d_model) in float32, as
    ``conftest.make_requests`` draws them."""
    return np.random.default_rng(seed).normal(
        size=(B, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)


def _rel_err(got, ref) -> float:
    ref = np32(ref)
    return float(np.abs(np32(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _port_request(r):
    return TorchRequest(uid=r.uid, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens,
                        extras={k: v.copy() for k, v in r.extras.items()})


# ---------------------------------------------------------------------------
# the config and the parameter tree
# ---------------------------------------------------------------------------

def test_config_is_the_references():
    """The port's copy of ``configs/internvl2_1b.py``, field for field; its
    reduced card config runs the kernels' widths and keeps the smoke
    config's 8 patch rows."""
    cfg = get_config(ARCH)
    assert REGISTRY[ARCH] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert (cfg.family, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.n_layers, cfg.vision_prefix_len) \
        == ("vlm", 896, 14, 2, 64, 24, 256)
    small = card_smoke_config(cfg)
    assert (small.d_model, small.resolved_head_dim, small.n_heads,
            small.n_kv_heads, small.vision_prefix_len) == (256, 64, 4, 2, 8)


def test_full_width_shapes():
    """internvl2-1b at full width: every leaf of the reference's tree
    (493,753,344 parameters: wte 151655 x 896, tied; 24 layers of
    14,911,232), and the cache the serving kernels read (computed; nothing
    is allocated)."""
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
    assert shapes["layers"]["attn"]["wq"] == (24, 896, 14, 64)
    assert shapes["layers"]["attn"]["wk"] == (24, 896, 2, 64)
    assert sum(int(np.prod(s)) for s in tshapes.values()) == 493_753_344
    per_layer = sum(int(np.prod(s[1:])) for k, s in tshapes.items()
                    if k.startswith("['layers']"))
    assert per_layer == 14_911_232
    assert tmodel._cache_struct(8, 1024)["k"].shape == (24, 8, 1024, 2, 64)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", TWINS)
@pytest.mark.parametrize("lens", [None, [12, 7]])
def test_prefill_logits_and_cache_match(which, lens):
    """The patch rows take positions 0..7 of the cache, the prompt
    8..8 + len - 1; with ``prompt_lens`` the logits are taken at
    8 + len - 1."""
    model, params, cfg, tmodel, tparams = twin(which)
    toks, pe = _prompts(), _patches(cfg)
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = jref(model).prefill(params, jnp.asarray(toks), jnp.asarray(pe),
                                 max_seq=MAX_SEQ, remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), torch.tensor(pe),
                            max_seq=MAX_SEQ, **kw_t)
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)
    # the patch rows condition every text position
    other, _ = tmodel.prefill(tparams, torch.tensor(toks),
                              torch.tensor(pe + 1.0), max_seq=MAX_SEQ, **kw_t)
    assert not np.allclose(np32(other), np32(tl))


@pytest.mark.parametrize("which", TWINS)
def test_decode_dense_cache_matches(which):
    model, params, cfg, tmodel, tparams = twin(which)
    lens = np.array([12, 7], np.int32)
    P = cfg.vision_prefix_len
    jl, jc = jref(model).prefill(
        params, jnp.asarray(_prompts(1)), jnp.asarray(_patches(cfg, 1)),
        max_seq=MAX_SEQ, remat=False, prompt_lens=jnp.asarray(lens))
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), lens + P
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


def _paged_pair(which, kv_dtype, lens=(12, 7), steps=3):
    """Prefill both packages' page pools (patch rows and prompts) through
    their own writers, then step both decoders over the same tokens from
    position P + len."""
    model, params, cfg, tmodel, tparams = twin(which)
    toks, pe = _prompts(2), _patches(cfg, 2)
    B, page, P = len(lens), 16, cfg.vision_prefix_len
    js = JaxPagedState(model, B, MAX_SEQ, page_size=page, kv_dtype=kv_dtype)
    ts = TorchPagedState(tmodel, B, MAX_SEQ, page_size=page,
                         kv_dtype=kv_dtype)
    for st in (js, ts):
        for b, n in enumerate(lens):
            st.pool.allocate(b, P + n + steps)
        st.sync_tables()
    tables_sub = js.pool.tables.copy()
    for b in range(B):
        tables_sub[b, js.pool.n_blocks[b]:] = js.pool.n_pages
    jl, jsub = jref(model).prefill(params, jnp.asarray(toks), jnp.asarray(pe),
                                   max_seq=MAX_SEQ, remat=False,
                                   prompt_lens=jnp.asarray(lens))
    _, tsub = tmodel.prefill(tparams, torch.tensor(toks), torch.tensor(pe),
                             max_seq=MAX_SEQ, prompt_lens=torch.tensor(lens))
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
    pos = np.asarray(lens, np.int32) + P
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
    out, js, ts = _paged_pair(which, None)
    for jl, tl in out:
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np32(ts.cache[key]), np32(js.cache[key]),
                                   **LOGITS_TOL)


@pytest.mark.parametrize("which", TWINS)
def test_decode_int8_pages_match(which):
    """Logits within ``QUANT_TOL`` and the same greedy tokens; scales and
    stored values within one quantization step."""
    out, js, ts = _paged_pair(which, "int8")
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


def _run(which, name):
    """Both engines over ``conftest.make_requests`` (each request with its
    patch rows) with a recording executor, memoized per twin and
    configuration."""
    if (which, name) not in _RUNS:
        model, params, cfg, tmodel, tparams = twin(which)
        out = []
        for eng_cls, m, p, to_req in ((JaxEngine, model, params, lambda r: r),
                                      (TorchEngine, tmodel, tparams,
                                       _port_request)):
            ex = RecordingExecutor()
            eng = eng_cls(m, p, batch_slots=2, max_seq=MAX_SEQ, executor=ex,
                          **CONFIGS[name])
            reqs = eng.generate([to_req(r) for r in make_requests(cfg)])
            out.append((reqs, ex, eng))
        _RUNS[which, name] = out
    return _RUNS[which, name]


#: (twin, configuration) pairs of the engine runs: every cache type on the
#: variant, pages on the smoke twin
ENGINE_RUNS = [("g7", name) for name in sorted(CONFIGS)] + [("smoke",
                                                              "paged")]


@pytest.mark.parametrize("which,name", ENGINE_RUNS)
def test_engine_token_streams_and_hooks_identical(which, name):
    (jreqs, jex, jeng), (treqs, tex, teng) = _run(which, name)
    assert all("patch_embeds" in r.extras for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated, (name, j.uid)
        assert t.finished_step == j.finished_step, (name, j.uid)
    assert teng.n_decode_steps == jeng.n_decode_steps
    assert tex.calls == jex.calls
    assert teng.compile_stats == jeng.compile_stats


def test_text_and_patch_requests_sharing_a_bucket():
    """A text-only and a patch request whose prompts share a bucket take
    separate prefill calls (paged) (the rows of one call stack): each request's
    tokens equal its tokens served alone and the reference engine's; the
    bucket holds two memoized prefills and counts as one variant, as the
    reference counts it."""
    model, params, cfg, tmodel, tparams = twin("smoke")
    rng = np.random.default_rng(3)
    pe = _patches(cfg, 3, B=1)
    reqs = [JaxRequest(uid=0, prompt=rng.integers(0, cfg.vocab_size, 6),
                       max_new_tokens=4),
            JaxRequest(uid=1, prompt=rng.integers(0, cfg.vocab_size, 7),
                       max_new_tokens=4, extras={"patch_embeds": pe})]
    kw = dict(batch_slots=2, max_seq=MAX_SEQ, paged=True)
    jeng = JaxEngine(model, params, **kw)
    ref = jeng.generate([JaxRequest(uid=r.uid, prompt=r.prompt,
                                    max_new_tokens=r.max_new_tokens,
                                    extras=dict(r.extras)) for r in reqs])
    teng = TorchEngine(tmodel, tparams, **kw)
    got = teng.generate([_port_request(r) for r in reqs])
    assert teng.n_prefill_calls == 2
    assert len(teng._prefill_fns) == 2
    assert teng.compile_stats == jeng.compile_stats
    assert teng.compile_stats["prefill_bucket_variants"] == 1
    for r, j in zip(got, ref):
        assert r.generated == j.generated, r.uid
        [solo] = TorchEngine(tmodel, tparams, **kw).generate(
            [_port_request(r)])
        assert r.generated == solo.generated, r.uid


def _prefix_requests(cfg, cls):
    """Patch requests on one page-crossing prompt head: two with the same
    patch rows (the second splices the first's pages), one with other
    rows (another namespace), one text-only (namespace 0)."""
    rng = np.random.default_rng(11)
    head = rng.integers(0, cfg.vocab_size, 20)
    pa, pb = _patches(cfg, 11, B=1), _patches(cfg, 12, B=1)
    tails = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 3, 6)]
    extras = [{"patch_embeds": pa}, {}, {"patch_embeds": pa},
              {"patch_embeds": pb}]
    return [cls(uid=i, prompt=np.concatenate([head, t]).astype(np.int32),
                max_new_tokens=5, extras={k: v.copy() for k, v in ex.items()})
            for i, (t, ex) in enumerate(zip(tails, extras))]


def test_prefix_cache_with_patch_requests():
    """The prefix cache on against off with patch requests: the same
    tokens, and the reference engine's tokens and cache statistics with
    the cache on.  A patch row is a sentinel position of the key and the
    rows pick the namespace, so only the request with bit-identical rows
    hits."""
    model, params, cfg, tmodel, tparams = twin("smoke")
    kw = dict(batch_slots=1, max_seq=MAX_SEQ, paged=True, page_size=16,
              n_pages=16)
    off = TorchEngine(tmodel, tparams, **kw).generate(
        _prefix_requests(cfg, TorchRequest))
    teng = TorchEngine(tmodel, tparams, prefix_cache=True, **kw)
    on = teng.generate(_prefix_requests(cfg, TorchRequest))
    jeng = JaxEngine(model, params, prefix_cache=True, **kw)
    ref = jeng.generate(_prefix_requests(cfg, JaxRequest))
    assert [r.generated for r in on] == [r.generated for r in off]
    assert [r.generated for r in on] == [r.generated for r in ref]
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.prefix_cache_stats()["hits"] == 1


# ---------------------------------------------------------------------------
# training: the loss and every gradient, the Trainer, the wrapper calls
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, 257, (B, S + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "patch_embeds": _patches(cfg, seed + 1, B)}


@pytest.mark.parametrize("which", TWINS)
@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_reference(which, remat):
    """The loss over the text positions (the patch positions dropped) and
    every gradient."""
    model, params, cfg, tmodel, _ = twin(which)
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    batch = _batch(cfg)
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
    for path, g in got:
        assert g.shape == ref[path].shape, path
        assert _rel_err(g, ref[path]) <= GRAD_RTOL, (path,
                                                     _rel_err(g, ref[path]))


class WithPatches:
    """A data pipeline whose batches carry seeded patch rows, drawn from
    the step's index so that a restored pipeline repeats them."""

    def __init__(self, pipeline, cfg):
        self.pipeline, self.cfg, self.step = pipeline, cfg, 0

    def next_batch(self):
        batch = dict(self.pipeline.next_batch())
        batch["patch_embeds"] = _patches(
            self.cfg, 100 + self.step, B=batch["tokens"].shape[0])
        self.step += 1
        return batch

    def state_dict(self):
        return {"inner": self.pipeline.state_dict(), "step": self.step}

    def load_state_dict(self, d):
        self.pipeline.load_state_dict(d["inner"])
        self.step = d["step"]


STEPS, SEED = 3, 0
OPT = dict(lr=1e-2, warmup_steps=2, decay_steps=100)


def test_trainer_loss_curve_matches_reference():
    """Both ``Trainer``s on the variant with 7 query heads per KV head,
    the same initial weights and data stream with the same patch rows, 3
    steps of 2 micro-batches with remat: the same losses."""
    model, _, cfg, tmodel, _ = twin("g7")
    jax_params = model.init(jax.random.split(jax.random.PRNGKey(SEED))[0])
    tree = jax.tree.map(np.asarray, jax_params)
    tcfg = dict(total_steps=STEPS, ckpt_every=STEPS)
    with tempfile.TemporaryDirectory() as d:
        jt = JaxTrainer(
            model, jax_make_train_step(model, JaxOptConfig(**OPT),
                                       accum_steps=2, remat=True),
            WithPatches(JaxPipeline(cfg.vocab_size, 4, 16), cfg),
            JaxCheckpoints(d, keep=1), JaxTrainerConfig(**tcfg), seed=SEED)
        jt.run()

    class Carried(type(tmodel)):
        """The port's DecoderLM whose ``init`` returns the JAX trainer's
        initial parameters (fresh copies: the port updates in place)."""

        def init(self, generator=None, dtype=None):
            return params_from_jax(self, tree, dtype)

    carried = Carried(tmodel.cfg, block_k=16, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        tt = Trainer(
            carried, make_train_step(carried, OptimizerConfig(**OPT),
                                     accum_steps=2, remat=True),
            WithPatches(DataPipeline(cfg.vocab_size, 4, 16), cfg),
            CheckpointManager(d, keep=1), TrainerConfig(**tcfg), seed=SEED)
        tt.run()
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=0,
                               atol=CURVE_TOL)


def test_kernel_calls_per_forward_and_step(monkeypatch):
    """What ``chip_smoke.py``'s exact launch gates count for internvl2-1b
    (as for llama3.2-1b: the patch rows add positions, not calls): 2
    RMSNorms a layer and the final one a forward; n_layers prefill
    attentions a prefill, n_layers paged decodes a paged step; a training
    micro-batch under remat n_layers attention forwards, n_layers more and
    2 n_layers norms more in the recompute, n_layers backwards."""
    _, params, cfg, tmodel, tparams = twin("g7")
    L = cfg.n_layers
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
    _paged_pair("g7", None, steps=1)            # one prefill, one step
    assert calls == {"rmsnorm": 2 * (2 * L + 1), "flash_prefill": L,
                     "flash_bwd": 0, "paged_decode": L}
    calls.update(dict.fromkeys(calls, 0))
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    loss_and_grads(tmodel, masters,
                   {k: torch.tensor(v) for k, v in _batch(cfg).items()},
                   remat=True)
    assert calls == {"rmsnorm": 2 * L + 1 + 2 * L, "flash_prefill": 2 * L,
                     "flash_bwd": L, "paged_decode": 0}


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------

def test_serve_launcher_prints_the_references_lines(monkeypatch, capsys):
    """``launch.serve --arch internvl2-1b --smoke`` in both packages: the
    same plan lines and executed totals (text-only requests, as the
    reference's launcher builds them)."""
    flags = ["--arch", ARCH, "--smoke", "--chip", "tpu-v5e", "--requests",
             "2"]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [jax_serve.__name__] + flags)
    jax_serve.main()
    ref = capsys.readouterr().out.splitlines()
    out = serve.main(flags + ["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()

    def same(lines):
        return [ln for ln in lines if "tok/s on this host" not in ln]
    assert same(port) == same(ref)
    assert out["requests"] == 2 and out["tokens"] == 16
