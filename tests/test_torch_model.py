"""The port's dense decoder against the JAX package's, on the CPU: prefill
logits and caches, decode over a dense cache and over unquantized, int8 and
fp8 page pools, and the paged cache writers, on the same weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import paged_cache_write_quant as jax_write_quant
from repro.serve.kv_pages import PagedBatchState as JaxPagedState
from repro.serve.kv_pages import write_prefill_pages as jax_write_pages
from repro_torch.models import common as tcm
from repro_torch.serve.kv_pages import PagedBatchState as TorchPagedState
from repro_torch.serve.kv_pages import write_prefill_pages as torch_write_pages
from torch_parity import F32_TOL, LOGITS_TOL, QUANT_TOL, np32, twin

MAX_SEQ = 32


def _prompts(seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    _, _, cfg, _, _ = twin()
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("lens", [None, [12, 7]])
def test_prefill_logits_and_cache_match(lens):
    model, params, _, tmodel, tparams = twin()
    toks = _prompts()
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = model.prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                           remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
                            **kw_t)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


def _dense_decode(steps=3):
    model, params, _, tmodel, tparams = twin()
    toks = _prompts(1)
    lens = np.array([12, 7], np.int32)
    jl, jc = model.prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                           remat=False, prompt_lens=jnp.asarray(lens))
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = lens.copy()
    for _ in range(steps):
        jl, jc = model.decode_step(params, jc, jnp.asarray(tok),
                                   jnp.asarray(pos))
        tl, tc = tmodel.decode_step(tparams, tc, torch.tensor(tok),
                                    torch.tensor(pos))
        yield jl, tl, jc, tc
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1


def test_decode_dense_cache_matches():
    for jl, tl, jc, tc in _dense_decode():
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


def test_decode_dense_cache_parked_slot_writes_nothing():
    """A frozen slot parked at pos == max_seq must leave the dense cache
    alone, as the reference's dropped scatter does."""
    _, _, _, tmodel, tparams = twin()
    cache = tmodel.init_cache(2, 8)
    before = {k: v.clone() for k, v in cache.items()}
    tmodel.decode_step(tparams, cache, torch.tensor([3, 4], dtype=torch.int32),
                       torch.tensor([8, 2], dtype=torch.int32))
    assert torch.equal(cache["k"][:, 0], before["k"][:, 0])
    assert not torch.equal(cache["k"][:, 1], before["k"][:, 1])


def _paged_pair(kv_dtype, lens=(12, 7), steps=3):
    """Prefill both packages' page pools through their own engines'
    writers, then step both decoders over the same tokens."""
    model, params, _, tmodel, tparams = twin()
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
    jl, jsub = model.prefill(params, jnp.asarray(toks), max_seq=MAX_SEQ,
                             remat=False, prompt_lens=jnp.asarray(lens))
    tl, tsub = tmodel.prefill(tparams, torch.tensor(toks), max_seq=MAX_SEQ,
                              prompt_lens=torch.tensor(lens))
    for key in ("k", "v"):
        sk = f"{key}_scale"
        if sk in js.cache:
            qmax = 127.0 if kv_dtype == "int8" else 448.0
            js.cache[key], js.cache[sk] = jax_write_pages(
                js.cache[key], jsub[key], jnp.asarray(tables_sub),
                scales=js.cache[sk], qmax=qmax)
            torch_write_pages(ts.cache[key], tsub[key], tables_sub,
                              scales=ts.cache[sk], qmax=qmax)
        else:
            js.cache[key] = jax_write_pages(js.cache[key], jsub[key],
                                            jnp.asarray(tables_sub))
            torch_write_pages(ts.cache[key], tsub[key], tables_sub)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    out = []
    for _ in range(steps):
        jl, js.cache = model.decode_step(params, js.cache, jnp.asarray(tok),
                                         jnp.asarray(pos),
                                         block_tables=js.tables_dev)
        tl, ts.cache = tmodel.decode_step(tparams, ts.cache,
                                          torch.tensor(tok), torch.tensor(pos),
                                          block_tables=ts.tables_dev)
        out.append((jl, tl))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    return out, js, ts


def test_decode_paged_unquantized_matches():
    out, js, ts = _paged_pair(None)
    for jl, tl in out:
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np32(ts.cache[key]), np32(js.cache[key]),
                                   **LOGITS_TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_decode_quantized_pages_match(kv_dtype):
    out, js, ts = _paged_pair(kv_dtype)
    for jl, tl in out:
        assert float(np.abs(np32(tl) - np32(jl)).max()) <= QUANT_TOL
        assert np.array_equal(np32(tl).argmax(-1), np32(jl).argmax(-1))
    for key in ("k", "v"):
        sc = np32(js.cache[f"{key}_scale"])
        np.testing.assert_allclose(np32(ts.cache[f"{key}_scale"]), sc,
                                   rtol=1e-4, atol=1e-7)
        # stored values agree to one quantization step of the page
        step = 1.0 if kv_dtype == "int8" else 32.0   # fp8 ulp at 448
        diff = np.abs(np32(ts.cache[key]) - np32(js.cache[key]))
        assert (diff * sc[:, :, None, :, None]
                <= 1.01 * step * sc[:, :, None, :, None] + 1e-9).all()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_paged_cache_write_quant_matches(dtype):
    """Per-token quantizing write: scale reset on a page's first write,
    monotone widening after it, page requantized on the wider scale."""
    rng = np.random.default_rng(4)
    P, page, KV, D = 5, 4, 2, 8
    jd, td, qmax = {"int8": (jnp.int8, torch.int8, 127),
                    "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn,
                            448)}[dtype]
    stale = rng.integers(-qmax, qmax, (P, page, KV, D)).astype(np.float32)
    scales = rng.uniform(1, 2, (P, KV)).astype(np.float32)
    tables = np.array([[2, 1], [3, 4]], np.int32)
    toks = rng.normal(size=(page + 2, 2, KV, D)).astype(np.float32)
    toks[2] *= 50.0                        # a loud token mid-page
    jp, js = jnp.asarray(stale).astype(jd), jnp.asarray(scales)
    tp, ts = torch.tensor(stale).to(td), torch.tensor(scales)
    for t in range(page + 2):
        pos = np.array([t, t + 1], np.int32)
        jp, js = jax_write_quant(jp, js, jnp.asarray(toks[t]),
                                 jnp.asarray(tables), jnp.asarray(pos))
        tcm.paged_cache_write_quant(tp, ts, torch.tensor(toks[t]),
                                    torch.tensor(tables), torch.tensor(pos))
    np.testing.assert_allclose(np32(ts), np32(js), rtol=1e-6)
    np.testing.assert_allclose(np32(tp), np32(jp), atol=1.0 if dtype == "int8"
                               else 0.0, rtol=0.0 if dtype == "int8" else 0.13)


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_write_prefill_pages_matches(quant):
    rng = np.random.default_rng(6)
    L, N, S, KV, D, P, page = 2, 3, 32, 2, 16, 9, 16
    sub = rng.normal(size=(L, N, S, KV, D)).astype(np.float32)
    tables_sub = np.array([[3, 5], [1, P], [P, P]], np.int32)  # P: skipped
    if quant is None:
        pool = rng.normal(size=(L, P, page, KV, D)).astype(np.float32)
        jout = jax_write_pages(jnp.asarray(pool), jnp.asarray(sub),
                               jnp.asarray(tables_sub))
        tout = torch_write_pages(torch.tensor(pool), torch.tensor(sub),
                                 tables_sub)
        np.testing.assert_array_equal(np32(tout), np32(jout))
        return
    jd, td, qmax = {"int8": (jnp.int8, torch.int8, 127.0),
                    "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn,
                            448.0)}[quant]
    pool = np.zeros((L, P, page, KV, D), np.float32)
    scales = np.ones((L, P, KV), np.float32)
    jp, js = jax_write_pages(jnp.asarray(pool).astype(jd), jnp.asarray(sub),
                             jnp.asarray(tables_sub), scales=jnp.asarray(scales),
                             qmax=qmax)
    tp, ts = torch_write_pages(torch.tensor(pool).to(td), torch.tensor(sub),
                               tables_sub, scales=torch.tensor(scales),
                               qmax=qmax)
    np.testing.assert_allclose(np32(ts), np32(js), rtol=1e-6)
    np.testing.assert_allclose(np32(tp), np32(jp), atol=1.0 if quant == "int8"
                               else 0.0, rtol=0.0 if quant == "int8" else 0.13)
    untouched = [0, 2, 4, 6, 7, 8]
    np.testing.assert_array_equal(np32(tp)[:, untouched], 0.0)


def test_unembed_pads_vocab_and_masks_pad_columns():
    _, params, cfg, _, tparams = twin()
    x = np.random.default_rng(9).normal(size=(2, 1, cfg.d_model)) \
        .astype(np.float32)
    from repro.models.common import unembed as jax_unembed
    jl = np32(jax_unembed(params["embed"], jnp.asarray(x)))
    tl = np32(tcm.unembed(tparams["embed"], torch.tensor(x)))
    assert tl.shape[-1] % 512 == 0 and tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, **F32_TOL)
    assert (tl[..., cfg.vocab_size:] == -1e30).all()


def test_rope_is_half_split():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5) + 7
    from repro.models.common import apply_rope as jax_rope
    np.testing.assert_allclose(
        np32(tcm.apply_rope(torch.tensor(x), torch.tensor(pos), 5e5)),
        np32(jax_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)), **F32_TOL)
