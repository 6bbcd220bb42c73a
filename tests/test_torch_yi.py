"""yi-34b in the port against the JAX package, on the CPU.

yi-34b is a llama-style dense decoder with 56 query heads over 8 KV heads
at head_dim 128 (7 query heads per KV head), served on the card at full
width (68.8 GB of bf16 weights) and trained there at full width and 3 of
its 60 layers.  Two twins on the same weights in both packages (float32):
the smoke config (2 layers, d_model 64, 4 query heads over 2 at head_dim
16) and a variant with the full model's head geometry, head_dim 128 with 7
query heads per KV head (14 over 2), built with ``dataclasses.replace`` on
both packages' smoke configs: prefill logits and caches with and without
ragged rows, decode over f32 and int8 pages, the loss and every gradient
with remat on and off, and the wrapper calls a forward and a training
step make; a few ``Trainer`` steps on the variant.  The full-width tree
against the reference's ``abstract_params()``, and the layer-by-layer
draw of its largest leaves (``models.transformer.DRAW_WHOLE_MAX``).  The
CUDA kernels the model reaches (head_dim 128 at G 7, forward and
backward; RMSNorm at d 7168) are held against the same plain versions on
the card by ``chip_smoke.py``.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.ckpt import CheckpointManager as JaxCheckpoints
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataPipeline as JaxPipeline
from repro.models import build_model as jax_build_model
from repro.serve.kv_pages import PagedBatchState as JaxPagedState
from repro.serve.kv_pages import write_prefill_pages as jax_write_pages
from repro.train import OptimizerConfig as JaxOptConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainerConfig as JaxTrainerConfig
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import REGISTRY, get_config, smoke_config
from repro_torch.data import DataPipeline
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import prefill as tprefill
from repro_torch.models import build_model
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.kv_pages import PagedBatchState as TorchPagedState
from repro_torch.serve.kv_pages import write_prefill_pages as torch_write_pages
from repro_torch.train import OptimizerConfig, loss_and_grads, make_train_step
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.tree import flatten
from torch_parity import LOGITS_TOL, QUANT_TOL, jref, np32

ARCH = "yi-34b"
MAX_SEQ = 32
GRAD_RTOL = 1e-4     # of each leaf's largest |value| (test_torch_train.py)
CURVE_TOL = 1e-4     # Trainer losses, absolute (test_torch_train.py)
#: the full model's head geometry at smoke width: head_dim 128, 7 query
#: heads per KV head
G7 = dict(n_heads=14, n_kv_heads=2, head_dim=128)
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


# ---------------------------------------------------------------------------
# the config, the parameter tree and its draw
# ---------------------------------------------------------------------------

def test_config_is_the_references():
    """The port's copy of ``configs/yi_34b.py``, field for field."""
    cfg = get_config(ARCH)
    assert REGISTRY[ARCH] is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert (cfg.family, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.n_layers, cfg.d_ff) \
        == ("dense", 7168, 56, 8, 128, 60, 20480)


def test_full_width_shapes_and_draw():
    """yi-34b at full width: every leaf of the reference's tree
    (34,388,917,248 parameters, 68.8 GB in bf16; 60 layers of 557,856,768
    and an untied head), the 240 KiB of bf16 K/V a token, and which leaves
    ``init_params`` draws a layer at a time: the three MLP matrices, each
    8.8e9 values (35 GB in float32), so that the largest float32 draw is
    wq's or wo's 3.1e9 values (12.3 GB) and a layer's draw 0.59 GB
    (computed from the shapes; nothing is allocated)."""
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
    assert shapes["layers"]["attn"]["wq"] == (60, 7168, 56, 128)
    assert shapes["layers"]["attn"]["wk"] == (60, 7168, 8, 128)
    assert shapes["layers"]["mlp"]["w_gate"] == (60, 7168, 20480)
    total = sum(int(np.prod(s)) for s in tshapes.values())
    assert total == 34_388_917_248
    per_layer = sum(int(np.prod(s[1:])) for k, s in tshapes.items()
                    if k.startswith("['layers']"))
    assert per_layer == 557_856_768
    k = tmodel._cache_struct(8, 1024)["k"].shape
    assert k == (60, 8, 1024, 8, 128)
    assert 2 * 2 * int(np.prod(k[:1] + k[3:])) == 240 * 1024
    layered = sorted(key for key, s in tshapes.items()
                     if key.startswith("['layers']")
                     and np.prod(s) > ttr.DRAW_WHOLE_MAX)
    assert layered == ["['layers']['mlp']['w_down']",
                       "['layers']['mlp']['w_gate']",
                       "['layers']['mlp']['w_up']"]
    whole = max(np.prod(s) for key, s in tshapes.items()
                if key.startswith("['layers']") and key not in layered)
    assert whole == 60 * 7168 * 56 * 128
    assert int(np.prod(shapes["layers"]["mlp"]["w_gate"][1:])) * 4 \
        == 587_202_560


def test_layer_by_layer_draw(monkeypatch):
    """A stacked leaf past ``DRAW_WHOLE_MAX`` values (here lowered below
    the MLP leaves of a small config) is drawn one float32 layer at a
    time, in the leaf's dtype with its fan-in's scale; the leaves at or
    below it are one draw each, and those drawn before the first layered
    leaf equal the draws with the threshold at its value; the same seed
    gives the same weights."""
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)),
                              compute_dtype="bfloat16", d_model=256,
                              d_ff=512, n_layers=3)
    tmodel = build_model(cfg, device="cpu")
    draws = []
    randn = torch.randn

    def recorded(*args, **kw):
        out = randn(*args, **kw)
        draws.append(tuple(out.shape))
        return out

    def init():
        g = torch.Generator()
        g.manual_seed(0)
        return tmodel.init(g)
    whole = init()
    monkeypatch.setattr(ttr, "DRAW_WHOLE_MAX", 256 * 512 * 3 - 1)
    monkeypatch.setattr(torch, "randn", recorded)
    layered = init()
    assert draws.count((256, 512)) == 2 * 3 and (512, 256) in draws
    assert (3, 256, 512) not in draws and (3, 256, 4, 16) in draws
    for key in ("w_gate", "w_up", "w_down"):
        w = layered["layers"]["mlp"][key]
        assert w.dtype == torch.bfloat16 and w.shape == \
            whole["layers"]["mlp"][key].shape
        std = float(w.float().std())
        assert abs(std / w.shape[1] ** -0.5 - 1) < 0.05, (key, std)
    # drawn before the MLP leaves in tree order, from the same stream
    for key in ("wq", "wk", "wv", "wo"):
        assert torch.equal(layered["layers"]["attn"][key],
                           whole["layers"]["attn"][key]), key
    assert torch.equal(layered["embed"]["wte"], whole["embed"]["wte"])
    again = init()
    for key in ("w_gate", "w_up", "w_down"):
        assert torch.equal(again["layers"]["mlp"][key],
                           layered["layers"]["mlp"][key])


# ---------------------------------------------------------------------------
# prefill and paged decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", TWINS)
@pytest.mark.parametrize("lens", [None, [12, 7]])
def test_prefill_logits_and_cache_match(which, lens):
    model, params, _, tmodel, tparams = twin(which)
    toks = _prompts()
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = jref(model).prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                                 remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
                            **kw_t)
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


def _paged_pair(which, kv_dtype, lens=(12, 7), steps=3):
    """Prefill both packages' page pools through their own writers, then
    step both decoders over the same tokens."""
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
# training: the loss and every gradient, the Trainer, the wrapper calls
# ---------------------------------------------------------------------------

def _batch(B=2, S=24, seed=0):
    toks = np.random.default_rng(seed).integers(0, 257, (B, S + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _rel_err(got, ref) -> float:
    ref = np32(ref)
    return float(np.abs(np32(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("which", TWINS)
@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_reference(which, remat):
    """The loss and every gradient leaf from f32 masters against the
    reference's ``jax.value_and_grad``: at ``g7`` the attention gradient
    sums dK and dV over 7 query heads a KV head at head_dim 128, as
    yi-34b's training does."""
    model, params, _, tmodel, _ = twin(which)
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
    for path, g in got:
        assert g.shape == ref[path].shape, path
        assert _rel_err(g, ref[path]) <= GRAD_RTOL, (path,
                                                     _rel_err(g, ref[path]))


STEPS, SEED = 3, 0
OPT = dict(lr=1e-2, warmup_steps=2, decay_steps=100)


def test_trainer_loss_curve_matches_reference():
    """Both ``Trainer``s on the variant with 7 query heads per KV head at
    head_dim 128, the same initial weights and data stream, 3 steps of 2
    micro-batches with remat: the same losses."""
    model, _, cfg, tmodel, _ = twin("g7")
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

    carried = Carried(tmodel.cfg, block_k=16, device="cpu")
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
    """What ``chip_smoke.py``'s exact launch gates count for yi-34b
    (``_yi_per_step``, as for llama3.2-3b): 2 RMSNorms a layer and the
    final one a forward; n_layers prefill attentions a prefill, n_layers
    paged decodes a paged step; a training micro-batch under remat
    n_layers attention forwards, n_layers more and 2 n_layers norms more
    in the recompute, n_layers backwards."""
    _, params, cfg, tmodel, _ = twin("g7")
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
                   {k: torch.tensor(v) for k, v in _batch().items()},
                   remat=True)
    assert calls == {"rmsnorm": 2 * L + 1 + 2 * L, "flash_prefill": 2 * L,
                     "flash_bwd": L, "paged_decode": 0}
