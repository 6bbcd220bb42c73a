"""seamless-m4t-medium in the port against the JAX package, on the CPU.

The encoder-decoder family: a bidirectional encoder over precomputed frame
embeddings (the speech frontend is a stub in both packages), a decoder of
causal self-attention, cross-attention to the encoder's output and a GELU
MLP, LayerNorm and learned positions.  Two twins on the same weights in
both packages (float32): the smoke config (2 encoder and 2 decoder layers,
d_model 64, 4 query heads over 2 KV heads at head_dim 16, 12 frames) and a
variant with the full model's one query head per KV head (4 over 4), built
with ``dataclasses.replace`` on both packages' smoke configs.  For each:
``encode``, prefill logits and every cache leaf with ragged prompts,
decode over a dense cache and over f32 and int8 pages, the loss and every
gradient with remat on and off; engine token streams and executor hooks
with ``conftest.make_requests``' frames, the prefix cache on against off
(one prompt under two sets of frames shares no page), a few ``Trainer``
steps and the wrapper calls a forward and a training step make; the
full-width tree against the reference's ``abstract_params()``.  The CUDA
kernels the model reaches (the flash forward non-causal and at Sq != Sk,
its backward likewise, paged decode at head_dim 64 with one query head per
KV head) are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses
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
from repro_torch.models import EncDecLM, build_model
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

ARCH = "seamless-m4t-medium"
MAX_SEQ = 48
GRAD_RTOL = 1e-4     # of each leaf's largest |value| (test_torch_train.py)
CURVE_TOL = 1e-4     # Trainer losses, absolute (test_torch_train.py)
#: the full model's head geometry at smoke width: one query head per KV
#: head
G1 = dict(n_heads=4, n_kv_heads=4)
TWINS = ("smoke", "g1")
_TWINS = {}


def twin(which):
    """(jax model, jax params, cfg, port model, port params), memoized: the
    conftest smoke model, or the smoke config with ``G1``'s heads."""
    if which not in _TWINS:
        if which == "smoke":
            model, params, cfg = smoke_model(ARCH)
        else:
            cfg = dataclasses.replace(jax_smoke_config(JAX_REGISTRY[ARCH]),
                                      compute_dtype="float32", **G1)
            model = jax_build_model(cfg, block_k=16)
            params = model.init(jax.random.PRNGKey(0))
        tcfg = dataclasses.replace(smoke_config(get_config(ARCH)),
                                   compute_dtype="float32",
                                   **(G1 if which == "g1" else {}))
        tmodel = build_model(tcfg, block_k=16, device="cpu")
        tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params))
        _TWINS[which] = (model, params, cfg, tmodel, tparams)
    return _TWINS[which]


def _prompts(seed=0, B=2, S=12):
    return np.random.default_rng(seed).integers(0, 257, (B, S)).astype(
        np.int32)


def _frames(cfg, seed=0, B=2):
    """Seeded frames (B, encoder_frontend_len, d_model) in float32, as
    ``conftest.make_requests`` draws them."""
    return np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_frontend_len, cfg.d_model)).astype(np.float32)


def _rel_err(got, ref) -> float:
    ref = np32(ref)
    return float(np.abs(np32(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _port_request(r):
    return TorchRequest(uid=r.uid, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens,
                        extras={k: v.copy() for k, v in r.extras.items()})


# ---------------------------------------------------------------------------
# the config, the parameter tree and the device
# ---------------------------------------------------------------------------

def test_config_is_the_references():
    """The port's copy of ``configs/seamless_m4t_medium.py``, field for
    field; no reduced card config runs it (no launcher serves the family,
    as in the reference)."""
    cfg = get_config(ARCH)
    assert REGISTRY[ARCH] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert (cfg.family, cfg.n_encoder_layers, cfg.n_layers, cfg.d_model,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.encoder_frontend_len, cfg.tie_embeddings) \
        == ("encdec", 12, 12, 1024, 16, 16, 64, 4096, 256206, 1024, False)
    with pytest.raises(NotImplementedError, match="encdec"):
        card_smoke_config(cfg)


def test_full_width_shapes():
    """seamless-m4t-medium at full width: every leaf of the reference's tree
    (920,150,016 parameters: wte and the untied head 256206 x 1024, wpe
    40960 x 1024, enc_pos 1024 x 1024, 12 encoder layers of 12,587,008 and
    12 decoder layers of 16,783,360), and the caches the serving kernels
    read (computed; nothing is allocated)."""
    cfg = get_config(ARCH)
    tmodel = build_model(cfg, device="cpu")
    assert isinstance(tmodel, EncDecLM)
    shapes = tmodel.param_shapes()
    ref = jax_build_model(jax_get_config(ARCH)).abstract_params()
    jshapes = {jax.tree_util.keystr(p): tuple(leaf.shape) for p, leaf in
               jax.tree_util.tree_leaves_with_path(ref)}
    tshapes = {jax.tree_util.keystr(p): tuple(leaf) for p, leaf in
               jax.tree_util.tree_leaves_with_path(
                   shapes, is_leaf=lambda x: isinstance(x, tuple))}
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in tshapes.values()) == 920_150_016
    for stack, L, per in (("enc_layers", 12, 12_587_008),
                          ("dec_layers", 12, 16_783_360)):
        leaves = [s for k, s in tshapes.items()
                  if k.startswith(f"['{stack}']")]
        assert {s[0] for s in leaves} == {L}
        assert sum(int(np.prod(s[1:])) for s in leaves) == per
    cache = tmodel._cache_struct(8, 1024)
    assert cache["k"].shape == (12, 8, 1024, 16, 64)
    assert cache["cross_k"].shape == (12, 8, 1024, 16, 64)


def test_default_device_is_the_card():
    """With no device given the model is built for the card; without one
    it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EncDecLM(smoke_config(get_config(ARCH)))


def test_init_draws_every_leaf():
    """``init`` on the CPU: the reference's tree and dtypes (norms in f32,
    matrices in the compute dtype or the one asked for), random matrices
    at 0.02 for the embeddings and ``enc_pos``, ones and zeros for the
    norms; the encoder's and decoder's stacks carry their layer dims."""
    _, _, _, tmodel, _ = twin("g1")
    gen = torch.Generator()
    gen.manual_seed(3)
    params = tmodel.init(gen, dtype=torch.float32)
    shapes = dict(flatten(tmodel.param_shapes()))
    got = dict(flatten(params))
    assert {p: tuple(t.shape) for p, t in got.items()} == shapes
    for path, t in got.items():
        leaf = path.split("/")[-1]
        if leaf in ("scale", "bias"):
            assert t.dtype == torch.float32
            assert bool((t == (1.0 if leaf == "scale" else 0.0)).all())
        else:
            assert t.dtype == torch.float32 and float(t.std()) > 0
    assert abs(float(got["enc_pos"].std()) - 0.02) < 5e-3


# ---------------------------------------------------------------------------
# encode, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", TWINS)
def test_encode_matches(which):
    """The encoder's output (the memory) over seeded frames."""
    model, params, cfg, tmodel, tparams = twin(which)
    fr = _frames(cfg, 4)
    ref = jref(model).encode(params, jnp.asarray(fr), remat=False)
    got = tmodel.encode(tparams, torch.tensor(fr), remat=False)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(np32(got), np32(ref), **LOGITS_TOL)


@pytest.mark.parametrize("which", TWINS)
@pytest.mark.parametrize("lens", [None, [12, 7]])
def test_prefill_logits_and_cache_match(which, lens):
    """Prefill logits and every cache leaf: the self-attention K/V at
    positions 0 .. S - 1 of max_seq, the cross K/V of the memory; the
    frames condition every text position but take none."""
    model, params, cfg, tmodel, tparams = twin(which)
    toks, fr = _prompts(), _frames(cfg)
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = jref(model).prefill(params, jnp.asarray(toks), jnp.asarray(fr),
                                 max_seq=MAX_SEQ, remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), torch.tensor(fr),
                            max_seq=MAX_SEQ, **kw_t)
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    assert sorted(tc) == sorted(jc) == ["cross_k", "cross_v", "k", "v"]
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)
    other, _ = tmodel.prefill(tparams, torch.tensor(toks),
                              torch.tensor(fr + 1.0), max_seq=MAX_SEQ, **kw_t)
    assert not np.allclose(np32(other), np32(tl))
    with pytest.raises(ValueError, match="frames"):
        tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ)


@pytest.mark.parametrize("which", TWINS)
def test_decode_dense_cache_matches(which):
    model, params, cfg, tmodel, tparams = twin(which)
    lens = np.array([12, 7], np.int32)
    jl, jc = jref(model).prefill(params, jnp.asarray(_prompts(1)),
                                 jnp.asarray(_frames(cfg, 1)), max_seq=MAX_SEQ,
                                 remat=False, prompt_lens=jnp.asarray(lens))
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), lens
    for _ in range(3):
        jl, jc = jref(model).decode_step(params, jc, jnp.asarray(tok),
                                         jnp.asarray(pos))
        tl, _ = tmodel.decode_step(tparams, tc, torch.tensor(tok),
                                   torch.tensor(pos))
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    for key in jc:
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


def _paged_pair(which, kv_dtype, lens=(12, 7), steps=3):
    """Prefill both packages' page pools through their own writers (the
    self-attention K/V paged, the cross K/V into dense slot rows), then
    step both decoders over the same tokens."""
    model, params, cfg, tmodel, tparams = twin(which)
    toks, fr = _prompts(2), _frames(cfg, 2)
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
    jl, jsub = jref(model).prefill(params, jnp.asarray(toks), jnp.asarray(fr),
                                   max_seq=MAX_SEQ, remat=False,
                                   prompt_lens=jnp.asarray(lens))
    _, tsub = tmodel.prefill(tparams, torch.tensor(toks), torch.tensor(fr),
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
    for key in ("cross_k", "cross_v"):
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
    out, js, ts = _paged_pair(which, None)
    for jl, tl in out:
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(np32(ts.cache[key]), np32(js.cache[key]),
                                   **LOGITS_TOL)


@pytest.mark.parametrize("which", TWINS)
def test_decode_int8_pages_match(which):
    """Logits within ``QUANT_TOL`` and the same greedy tokens; scales and
    stored values within one quantization step.  Only the self-attention
    pools are quantized: the cross K/V stay dense at the compute width, as
    the reference keeps them."""
    out, js, ts = _paged_pair(which, "int8")
    for jl, tl in out:
        assert float(np.abs(np32(tl) - np32(jl)).max()) <= QUANT_TOL
        assert np.array_equal(np32(tl).argmax(-1), np32(jl).argmax(-1))
    for key in ("k", "v"):
        assert ts.cache[key].dtype == torch.int8
        np.testing.assert_allclose(np32(ts.cache[f"{key}_scale"]),
                                   np32(js.cache[f"{key}_scale"]),
                                   rtol=1e-4, atol=1e-7)
        assert np.abs(np32(ts.cache[key]) - np32(js.cache[key])).max() <= 1.0
    for key in ("cross_k", "cross_v"):
        assert ts.cache[key].dtype == torch.float32
        assert f"{key}_scale" not in ts.cache
        np.testing.assert_allclose(np32(ts.cache[key]), np32(js.cache[key]),
                                   **LOGITS_TOL)


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------

CONFIGS = {"dense": dict(), "paged": dict(paged=True, page_size=16),
           "paged-int8": dict(paged=True, page_size=16, kv_dtype="int8")}
_RUNS = {}


def _run(which, name, eos=None):
    """Both engines over ``conftest.make_requests`` (each request with its
    frames) with a recording executor, memoized per twin, configuration
    and EOS token."""
    if (which, name, eos) not in _RUNS:
        model, params, cfg, tmodel, tparams = twin(which)
        out = []
        for eng_cls, m, p, to_req in ((JaxEngine, model, params, lambda r: r),
                                      (TorchEngine, tmodel, tparams,
                                       _port_request)):
            ex = RecordingExecutor()
            eng = eng_cls(m, p, batch_slots=2, max_seq=MAX_SEQ, executor=ex,
                          eos_token=eos, **CONFIGS[name])
            reqs = eng.generate([to_req(r) for r in make_requests(cfg)])
            out.append((reqs, ex, eng))
        _RUNS[which, name, eos] = out
    return _RUNS[which, name, eos]


#: (twin, configuration, EOS token) of the engine runs: every cache type on
#: the variant, and pages on the smoke twin with an EOS token that its
#: greedy streams sample (its second request's second token), so that a
#: slot frees early
ENGINE_RUNS = [("g1", name, None) for name in sorted(CONFIGS)] \
    + [("smoke", "paged", 199)]


@pytest.mark.parametrize("which,name,eos", ENGINE_RUNS)
def test_engine_token_streams_and_hooks_identical(which, name, eos):
    (jreqs, jex, jeng), (treqs, tex, teng) = _run(which, name, eos)
    assert all("frames" in r.extras for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated, (name, j.uid)
        assert t.finished_step == j.finished_step, (name, j.uid)
    assert teng.n_decode_steps == jeng.n_decode_steps
    assert tex.calls == jex.calls
    assert teng.compile_stats == jeng.compile_stats
    if eos is not None:
        assert any(len(t.generated) < t.max_new_tokens for t in treqs)


def test_dense_cross_leaves_keep_their_storage_across_admission():
    """The engine installs each admitted row's cross K/V into the dense
    slot leaves in place (``write_cache_slots``): their storage is the
    same before and after a workload, as the captured graphs need."""
    _, _, cfg, tmodel, tparams = twin("g1")
    eng = TorchEngine(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ,
                      paged=True, page_size=16)
    ptrs = {k: t.data_ptr() for k, t in eng.state.cache.items()}
    eng.generate([_port_request(r) for r in make_requests(cfg)])
    assert {k: t.data_ptr() for k, t in eng.state.cache.items()} == ptrs
    assert float(eng.state.cache["cross_k"].abs().sum()) > 0


def _frame_requests(cfg, cls):
    """Requests on one page-crossing prompt head: two under the same
    frames (the second splices the first's pages), one under other frames
    with the very same prompt (another namespace: it shares no page)."""
    rng = np.random.default_rng(11)
    head = rng.integers(0, cfg.vocab_size, 20)
    fa, fb = _frames(cfg, 11, B=1), _frames(cfg, 12, B=1)
    tails = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9)]
    prompts = [np.concatenate([head, tails[0]]),
               np.concatenate([head, tails[1]]),
               np.concatenate([head, tails[0]])]
    frames = [fa, fa, fb]
    return [cls(uid=i, prompt=p.astype(np.int32), max_new_tokens=5,
                extras={"frames": f.copy()})
            for i, (p, f) in enumerate(zip(prompts, frames))]


def test_prefix_cache_with_frames():
    """The prefix cache on against off with frame requests: the same
    tokens, and the reference engine's tokens and cache statistics with
    the cache on.  The frames pick the namespace, so the request with the
    first one's frames hits and the one with other frames, on the very
    same prompt, does not."""
    model, params, cfg, tmodel, tparams = twin("g1")
    kw = dict(batch_slots=1, max_seq=MAX_SEQ, paged=True, page_size=16,
              n_pages=16)
    off = TorchEngine(tmodel, tparams, **kw).generate(
        _frame_requests(cfg, TorchRequest))
    teng = TorchEngine(tmodel, tparams, prefix_cache=True, **kw)
    on = teng.generate(_frame_requests(cfg, TorchRequest))
    jeng = JaxEngine(model, params, prefix_cache=True, **kw)
    ref = jeng.generate(_frame_requests(cfg, JaxRequest))
    assert [r.generated for r in on] == [r.generated for r in off]
    assert [r.generated for r in on] == [r.generated for r in ref]
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.prefix_cache_stats()["hits"] == 1
    assert on[0].generated != on[2].generated


def test_requests_carry_only_the_models_extras():
    """An encoder-decoder request with patch rows raises before any
    prefill, naming the extras; a dense decoder given frames still
    raises (``test_torch_serve.py``)."""
    _, _, cfg, tmodel, tparams = twin("smoke")
    eng = TorchEngine(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ)
    with pytest.raises(NotImplementedError, match="extras"):
        eng.generate([TorchRequest(uid=0, prompt=np.arange(8, dtype=np.int32),
                                   extras={"frames": _frames(cfg, B=1),
                                           "patch_embeds": np.zeros(
                                               (1, 2, cfg.d_model))})])
    assert eng.n_prefill_calls == 0


# ---------------------------------------------------------------------------
# training: the loss and every gradient, the Trainer, the wrapper calls
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, 257, (B, S + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "frames": _frames(cfg, seed + 1, B)}


@pytest.mark.parametrize("which", TWINS)
@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_reference(which, remat):
    """The loss over the decoder's tokens and every gradient, the
    encoder's through the cross-attention included."""
    model, params, cfg, tmodel, _ = twin(which)
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    batch = _batch(cfg)
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
    for path, g in got:
        assert g.shape == ref[path].shape, path
        assert _rel_err(g, ref[path]) <= GRAD_RTOL, (path,
                                                     _rel_err(g, ref[path]))


class WithFrames:
    """A data pipeline whose batches carry seeded frames, drawn from the
    step's index so that a restored pipeline repeats them."""

    def __init__(self, pipeline, cfg):
        self.pipeline, self.cfg, self.step = pipeline, cfg, 0

    def next_batch(self):
        batch = dict(self.pipeline.next_batch())
        batch["frames"] = _frames(self.cfg, 100 + self.step,
                                  B=batch["tokens"].shape[0])
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
    """Both ``Trainer``s on the variant with one query head per KV head,
    the same initial weights and data stream with the same frames, 3 steps
    of 2 micro-batches with remat: the same losses."""
    model, _, cfg, tmodel, _ = twin("g1")
    jax_params = model.init(jax.random.split(jax.random.PRNGKey(SEED))[0])
    tree = jax.tree.map(np.asarray, jax_params)
    tcfg = dict(total_steps=STEPS, ckpt_every=STEPS)
    with tempfile.TemporaryDirectory() as d:
        jt = JaxTrainer(
            model, jax_make_train_step(model, JaxOptConfig(**OPT),
                                       accum_steps=2, remat=True),
            WithFrames(JaxPipeline(cfg.vocab_size, 4, 16), cfg),
            JaxCheckpoints(d, keep=1), JaxTrainerConfig(**tcfg), seed=SEED)
        jt.run()

    class Carried(EncDecLM):
        """The port's EncDecLM whose ``init`` returns the JAX trainer's
        initial parameters (fresh copies: the port updates in place)."""

        def init(self, generator=None, dtype=None):
            return params_from_jax(self, tree, dtype)

    carried = Carried(tmodel.cfg, block_k=16, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        tt = Trainer(
            carried, make_train_step(carried, OptimizerConfig(**OPT),
                                     accum_steps=2, remat=True),
            WithFrames(DataPipeline(cfg.vocab_size, 4, 16), cfg),
            CheckpointManager(d, keep=1), TrainerConfig(**tcfg), seed=SEED)
        tt.run()
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=0,
                               atol=CURVE_TOL)


def test_kernel_calls_per_forward_and_step(monkeypatch):
    """What ``chip_smoke.py``'s exact launch gates count for
    seamless-m4t-medium, from the model's structure: no RMSNorm anywhere
    (LayerNorm); a prefill runs n_encoder_layers non-causal encoder
    attentions, n_layers causal self-attentions and n_layers
    cross-attentions; a paged decode step n_layers paged decodes (the
    cross-attention decode is plain); a training micro-batch under remat
    each of those attention forwards twice (the recompute) and one
    backward each."""
    _, params, cfg, tmodel, _ = twin("g1")
    Le, L = cfg.n_encoder_layers, cfg.n_layers
    calls = dict.fromkeys(("rmsnorm", "flash_prefill", "flash_bwd",
                           "paged_decode"), 0)
    causal = []
    for mod, attr, key in ((tcm, "rmsnorm", "rmsnorm"),
                           (tprefill, "_forward", "flash_prefill"),
                           (tops, "flash_attention_bwd", "flash_bwd"),
                           (tcm, "paged_flash_decode", "paged_decode")):
        def counted(*a, _fn=getattr(mod, attr), _key=key, **kw):
            calls[_key] += 1
            if _key == "flash_prefill":
                causal.append((kw["causal"], a[0].shape[1], a[1].shape[1]))
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    _paged_pair("g1", None, steps=1)            # one prefill, one step
    assert calls == {"rmsnorm": 0, "flash_prefill": Le + 2 * L,
                     "flash_bwd": 0, "paged_decode": L}
    F = cfg.encoder_frontend_len
    assert causal == [(False, F, F)] * Le + [(True, 12, 12),
                                             (False, 12, F)] * L
    calls.update(dict.fromkeys(calls, 0))
    masters = params_from_jax(tmodel, jax.tree.map(np.asarray, params),
                              dtype=torch.float32)
    loss_and_grads(tmodel, masters,
                   {k: torch.tensor(v) for k, v in _batch(cfg).items()},
                   remat=True)
    assert calls == {"rmsnorm": 0, "flash_prefill": 2 * (Le + 2 * L),
                     "flash_bwd": Le + 2 * L, "paged_decode": 0}
