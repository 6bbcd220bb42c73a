"""The port's hybrid (zamba2-style) serving path against the JAX package's,
on the CPU.

The zamba2-7b smoke model (4 Mamba2 blocks, the shared attention block
every 2, float32) on the same weights in both packages: the parameter
bridge, prefill logits and every cache leaf (with and without ragged rows,
and on a 5-layer variant whose tail runs the shared block once more),
decode over a dense cache and over unquantized and int8 page pools, whole
engine runs (token streams, finish steps, executor-hook calls), and the
bf16 rounding of the attention's query scale.  The CUDA kernels the model
reaches are held against the same plain versions on the card by
``chip_smoke.py``.
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
from repro.models import common as jcm
from repro.serve import ServeEngine as JaxEngine
from repro.serve.kv_pages import PagedBatchState as JaxPagedState
from repro.serve.kv_pages import write_prefill_pages as jax_write_pages
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.prefill import query_scale
from repro_torch.models import build_model
from repro_torch.models import common as tcm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.hybrid import HybridLM
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeEngine as TorchEngine
from repro_torch.serve.kv_pages import PagedBatchState as TorchPagedState
from repro_torch.serve.kv_pages import write_prefill_pages as torch_write_pages
from torch_parity import (BF16_TOL, LOGITS_TOL, QUANT_TOL, RecordingExecutor,
                          jref, np32, twin)

ARCH = "zamba2-7b"
MAX_SEQ = 32
LEAVES = ("ssm", "conv", "k", "v")
_TAILED = {}


def _models(tail: bool):
    """(jax model, jax params, cfg, port model, port params): the smoke
    twin (4 layers, the shared block every 2: no tail), or with ``tail``
    the same config at 5 layers, whose last Mamba2 block runs after one
    more application of the shared block (built and converted here as
    ``torch_parity.twin`` builds the smoke twin)."""
    if not tail:
        return twin(ARCH)
    if not _TAILED:
        _, _, cfg, _, _ = twin(ARCH)
        cfg = dataclasses.replace(cfg, n_layers=5)
        model = jax_build_model(cfg, block_k=16)
        params = model.init(jax.random.PRNGKey(0))
        tmodel = build_model(cfg, block_k=16, device="cpu")
        tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params))
        _TAILED.update(m=(model, params, cfg, tmodel, tparams))
    return _TAILED["m"]


def _prompts(seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    _, _, cfg, _, _ = twin(ARCH)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# structure and the parameter bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tail", [False, True])
def test_group_order_is_the_references(tail):
    """The shared block before each group of ``attn_every`` Mamba2 blocks,
    then once before the tail."""
    model, _, cfg, tmodel, _ = _models(tail)
    assert (tmodel.n_groups, tmodel.tail, tmodel.n_attn) == \
        (model.n_groups, model.tail, model.n_attn)
    assert [list(g) for _, g in tmodel._groups()] == \
        ([[0, 1], [2, 3], [4]] if tail else [[0, 1], [2, 3]])
    assert tmodel.attn_head_dim == model.attn_head_dim == 32


def test_params_from_jax_checks_every_shape():
    """Every leaf of the reference's tree crosses over at the shape the
    port declares, in the port's leaf dtypes; a wrong shape raises."""
    _, params, cfg, tmodel, tparams = twin(ARCH)
    ref = jax.tree.map(np.asarray, params)
    jflat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(jflat) == len(list(_leaves(tparams)))
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == tmodel.leaf_dtype(path[-1].key), path
    assert tuple(tparams["shared"]["attn"]["wo"].shape) == \
        (cfg.n_heads, 32, cfg.d_model)
    bad = jax.tree.map(np.asarray, params)
    bad["shared"]["attn"]["wo"] = bad["shared"]["attn"]["wo"][:, :16]
    with pytest.raises(ValueError, match="shared/attn/wo"):
        params_from_jax(tmodel, bad)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_full_width_shapes():
    """zamba2-7b at full width: the shapes the serving kernels are built
    for (computed from the config; nothing is allocated), and every leaf
    the reference's tree holds: 6.917 B parameters, above the 6.737 B of
    ``ModelConfig.param_count()``, whose formula sizes the shared MLP at
    d_model, not 2 d_model, and counts no embedding head."""
    cfg = get_config(ARCH)
    tmodel = build_model(cfg, device="cpu")
    shapes = tmodel.param_shapes()
    assert shapes["shared"]["attn"]["wo"] == (32, 224, 3584)
    assert shapes["shared"]["norm_attn"]["scale"] == (7168,)
    assert shapes["layers"]["mamba"]["gate_norm"]["scale"] == (81, 7168)
    st = tmodel._cache_struct(8, 1024)
    assert st["ssm"].shape == (81, 8, 112, 64, 64)
    assert st["conv"].shape == (81, 8, 3, 7424)
    assert st["k"].shape == (14, 8, 1024, 32, 224)
    assert (tmodel.n_groups, tmodel.tail, tmodel.n_attn) == (13, 3, 14)
    ref = jax_build_model(jax_get_config(ARCH)).abstract_params()
    jshapes = {jax.tree_util.keystr(p): tuple(leaf.shape) for p, leaf in
               jax.tree_util.tree_leaves_with_path(ref)}
    tshapes = {jax.tree_util.keystr(p): tuple(leaf) for p, leaf in
               jax.tree_util.tree_leaves_with_path(
                   shapes, is_leaf=lambda x: isinstance(x, tuple))}
    assert tshapes == jshapes
    total = sum(int(np.prod(s)) for s in tshapes.values())
    assert total == 6_916_799_312
    assert cfg.param_count()[0] == 6_736_648_416


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("lens", [None, [12, 7]])
def test_prefill_logits_and_cache_match(lens, tail):
    """Logits and every cache leaf, K/V padded to max_seq with zeros as
    the reference pads them."""
    model, params, _, tmodel, tparams = _models(tail)
    toks = _prompts()
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = jref(model).prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                                 remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
                            **kw_t)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    assert sorted(tc) == sorted(jc) == sorted(LEAVES)
    for key in LEAVES:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)
    assert tc["ssm"].dtype == torch.float32


def _dense_decode(tail, steps=3):
    model, params, _, tmodel, tparams = _models(tail)
    lens = np.array([12, 7], np.int32)
    jl, jc = jref(model).prefill(
        params, jnp.asarray(_prompts(1)), max_seq=MAX_SEQ, remat=False,
        prompt_lens=jnp.asarray(lens))
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), lens.copy()
    out = []
    for _ in range(steps):
        jl, jc = jref(model).decode_step(params, jc, jnp.asarray(tok),
                                         jnp.asarray(pos))
        tl, tc2 = tmodel.decode_step(tparams, tc, torch.tensor(tok),
                                     torch.tensor(pos))
        assert tc2 is tc
        out.append((jl, tl))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    return out, jc, tc


@pytest.mark.parametrize("tail", [False, True])
def test_decode_dense_cache_matches(tail):
    """Three steps from a ragged prefill: logits each step, and every
    leaf written in place (the tail's KV application included)."""
    out, jc, tc = _dense_decode(tail)
    for jl, tl in out:
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in LEAVES:
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


def test_decode_dense_parked_slot_writes_no_kv():
    """A frozen slot parked at pos == max_seq leaves every application's
    KV alone, as the reference's dropped scatter does; its recurrent
    state still advances, as the reference's does."""
    _, _, _, tmodel, tparams = twin(ARCH)
    cache = tmodel.init_cache(2, 8)
    before = {k: v.clone() for k, v in cache.items()}
    tmodel.decode_step(tparams, cache, torch.tensor([3, 4], dtype=torch.int32),
                       torch.tensor([8, 2], dtype=torch.int32))
    for key in ("k", "v"):
        assert torch.equal(cache[key][:, 0], before[key][:, 0])
        assert not torch.equal(cache[key][:, 1], before[key][:, 1])
    assert not torch.equal(cache["ssm"][:, 0], before["ssm"][:, 0])


def _paged_pair(kv_dtype, tail=False, lens=(12, 7), steps=3):
    """Prefill both packages' page pools through their own writers, then
    step both decoders over the same tokens."""
    model, params, _, tmodel, tparams = _models(tail)
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
    tl, tsub = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
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
    for key in ("ssm", "conv"):                 # dense slot rows
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


@pytest.mark.parametrize("tail", [False, True])
def test_decode_paged_unquantized_matches(tail):
    """Pages in the compute dtype: logits, the pools and the dense
    recurrent leaves at ``LOGITS_TOL``."""
    out, js, ts = _paged_pair(None, tail)
    for jl, tl in out:
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in LEAVES:
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
# the attention's query scale in bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [224, 32])
def test_bf16_query_scale_is_the_references(D):
    """JAX multiplies bf16 q by ``D ** -0.5`` rounded to bf16 (a weak-typed
    Python float), then rounds once.  The port's scaled q equals it bit
    for bit at head_dim 224 (zamba2-7b) and 32 (its smoke config), where
    multiplying by the f32 factor, as the port did before, differs in
    some elements."""
    q = np.random.default_rng(D).normal(size=(4, 1024)).astype(np.float32)
    want = np32(jnp.asarray(q, jnp.bfloat16) * D ** -0.5)
    tq = torch.tensor(q).bfloat16()
    got = np32(tq * query_scale(D, torch.bfloat16))
    assert np.array_equal(got, want)
    assert (np32(tq * D ** -0.5) != want).any()
    assert query_scale(D, torch.float32) == float(np.float32(D ** -0.5))


@pytest.mark.parametrize("D", [224, 32])
def test_bf16_dense_decode_attention_matches(D):
    """The dense decode attention in bf16 against the reference's, on the
    same bf16 operands: the scaled q is the same, so only the order of the
    f32 sums differs."""
    rng = np.random.default_rng(D + 1)
    B, S, H, KV = 3, 20, 4, 4
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D)))
    pos = np.array([0, 7, 19], np.int32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in (q, k, v))
    want = jcm.decode_attention(jq, jk, jv, pos=jnp.asarray(pos))
    got = tcm.decode_attention(tq, tk, tv, pos=torch.tensor(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), **BF16_TOL)


# ---------------------------------------------------------------------------
# engine runs: dense and paged, with and without EOS
# ---------------------------------------------------------------------------

# token 43 ends two of the smoke requests early: one at its first token
# (sampled by the prefill), one in mid-chunk
CONFIGS = {
    "dense": dict(),
    "paged": dict(paged=True, page_size=16),
    "dense-eos": dict(eos_token=43),
    "paged-eos": dict(paged=True, page_size=16, eos_token=43),
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


def _count_calls(monkeypatch):
    """Count the calls of each kernel wrapper the model reaches (the
    plain versions on the CPU, which count no launch)."""
    from repro_torch.models import ssm as tssm
    calls = dict.fromkeys(("rmsnorm", "ssd_scan", "flash_prefill",
                           "paged_decode"), 0)
    for mod, attr, key in ((tcm, "rmsnorm", "rmsnorm"),
                           (tssm, "ssd_scan", "ssd_scan"),
                           (tcm, "flash_prefill", "flash_prefill"),
                           (tcm, "paged_flash_decode", "paged_decode")):
        def counted(*a, _fn=getattr(mod, attr), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    return calls


@pytest.mark.parametrize("tail", [False, True])
def test_kernel_calls_per_forward(monkeypatch, tail):
    """What ``chip_smoke.py``'s exact launch gates count, from the model's
    structure: a forward normalises 2 n_layers + 2 n_attn + 1 times (191
    at full width: 81 block norms, 81 gate norms, 2 a shared application,
    the final norm); a prefill runs n_layers SSD scans and n_attn prefill
    attentions; a paged decode step n_attn paged decodes and no scan."""
    _, _, cfg, tmodel, tparams = _models(tail)
    L, A = cfg.n_layers, tmodel.n_attn
    calls = _count_calls(monkeypatch)
    tmodel.prefill(tparams, torch.tensor(_prompts()), max_seq=MAX_SEQ,
                   prompt_lens=torch.tensor([12, 7]))
    prefill = dict(calls)
    assert prefill == {"rmsnorm": 2 * L + 2 * A + 1, "ssd_scan": L,
                       "flash_prefill": A, "paged_decode": 0}
    calls.update(dict.fromkeys(calls, 0))
    _paged_pair(None, tail, steps=1)            # one prefill, one step
    step = {k: calls[k] - prefill[k] for k in calls}
    assert step == {"rmsnorm": 2 * L + 2 * A + 1, "ssd_scan": 0,
                    "flash_prefill": 0, "paged_decode": A}
    full = get_config(ARCH)
    m = build_model(full, device="cpu")
    assert 2 * full.n_layers + 2 * m.n_attn + 1 == 191


# ---------------------------------------------------------------------------
# devices and the training entry points
# ---------------------------------------------------------------------------

def test_build_model_needs_the_card_unless_told():
    cfg = get_config(ARCH)
    assert cfg.family == "hybrid" and cfg.ssm.state_dim == 64
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    assert isinstance(build_model(cfg, device="cpu"), HybridLM)


def test_training_entry_points_wait_for_their_slice():
    """The training slice has landed: ``forward_hidden`` and ``loss`` run
    (with and without remat, the same loss; held against the reference in
    ``tests/test_torch_ssm_train.py``)."""
    _, _, cfg, tmodel, tparams = twin(ARCH)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 5)),
                        dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    losses = [float(tmodel.loss(tparams, batch, remat=r)[0])
              for r in (True, False)]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    x, aux = tmodel.forward_hidden(tparams, torch.zeros(1, 4, cfg.d_model))
    assert x.shape == (1, 4, cfg.d_model) and aux == {}
