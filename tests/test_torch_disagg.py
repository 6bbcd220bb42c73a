"""The port's KV page-block migration against the JAX package's, on the CPU.

A request prefilled on engine A, serialized into a ``PageBlockTransfer``
and spliced into engine B's page pool must decode as if it never moved.
For the four model families on f32 pages and on int8 pages (the smoke
twins of ``torch_parity.twin()``, the same weights in both packages):

* the port's extraction of each slot has the reference's keys, shapes,
  dtypes, token counts and payload bytes; from pools holding the same
  stored bytes it gives the reference's payload exactly, and from each
  package's own prefill (computed values, which part at ~1e-6 in f32) it
  agrees within the parity tolerances;
* decode on the migrated engine (half the slots through the host dict,
  half device to device) stays within 1e-5 (f32 pages) or 5e-2 (int8) of
  the unmigrated port engine and of the reference's migrated decode, with
  the greedy argmax exact.

Then the port's own rules: the host dict round trip is bit for bit for
bf16, int8 and fp8 pools; a splice writes into the existing tensors
(their ``data_ptr`` stays); back-pressure leaves the device alone; the
parking page stays zero; a double splice and a kv_dtype or page_size
mismatch raise; copy semantics hold when the source's pages are reused;
and a reference transfer dict lands in a port pool.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import FAMILY_ARCHS, make_requests
from repro.serve import ServeEngine as JaxEngine
from repro.serve.kv_pages import extract_page_block as jax_extract
from repro.serve.kv_pages import splice_page_block as jax_splice
from repro.serve.kv_pages import PageBlockTransfer as JaxTransfer
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.kv_pages import (PageBlockTransfer, PagedBatchState,
                                        extract_page_block, scale_key,
                                        splice_page_block)
from torch_parity import F32_TOL, QUANT_TOL, jref, np32, twin

# the reference's own bounds (tests/test_disagg.py): f32 pages read through
# another block table give the same values; int8 pages the serve path's
DENSE_TOL = 1e-5
FAMILIES = ["transformer", "ssm", "hybrid", "encdec"]
KV = ["none", "int8"]
STEPS = 4
ENGINE_KW = dict(batch_slots=2, max_seq=64, paged=True, page_size=16)

_REF_RUNS = {}


def _tol(kv):
    return DENSE_TOL if kv == "none" else QUANT_TOL


def _kw(kv):
    return dict(ENGINE_KW, **({} if kv == "none" else {"kv_dtype": kv}))


def _port_request(r):
    return Request(uid=r.uid, prompt=r.prompt,
                   max_new_tokens=r.max_new_tokens,
                   extras={k: v.copy() for k, v in r.extras.items()})


def _port_engine(family, kv, prefill=True, **kw):
    """A port engine on the family's twin, with ``make_requests``' first
    two requests admitted (prefilled) in slots 0 and 1."""
    _, _, cfg, tmodel, tparams = twin(FAMILY_ARCHS[family])
    eng = ServeEngine(tmodel, tparams, **dict(_kw(kv), **kw))
    if prefill:
        eng.submit([_port_request(r) for r in make_requests(cfg, n=2)])
        eng._admit()
    return tmodel, tparams, eng


def _ref_engine(family, kv):
    model, params, cfg, _, _ = twin(FAMILY_ARCHS[family])
    eng = JaxEngine(model, params, **_kw(kv))
    eng.submit([dataclasses.replace(r, generated=[])
                for r in make_requests(cfg, n=2)])
    eng._admit()
    return model, params, eng


def _ref_run(family, kv):
    """The reference's migration (memoized per family and kv_dtype): its
    payloads of both slots, and the logits of ``STEPS`` greedy decode
    steps on its migrated engine (tokens fed from its unmigrated one)."""
    if (family, kv) not in _REF_RUNS:
        model, params, uni = _ref_engine(family, kv)
        _, _, src = _ref_engine(family, kv)
        dst = JaxEngine(model, params, **_kw(kv))
        payloads = [jax_extract(src.state, s, model) for s in range(2)]
        for s, tr in enumerate(payloads):
            assert jax_splice(dst.state, s, tr, model)
        step = jref(model).decode_step
        uc, mc = uni.state.cache, dst.state.cache
        tok, pos = uni.state.tokens, src.state.pos
        logits = []
        for _ in range(STEPS):
            lu, uc = step(params, uc, tok, pos,
                          block_tables=uni.state.tables_dev)
            lm, mc = step(params, mc, tok, pos,
                          block_tables=dst.state.tables_dev)
            logits.append(np32(lm))
            tok = np.asarray(lu).argmax(-1).astype(np.int32)
            pos = pos + 1
        _REF_RUNS[family, kv] = (payloads, logits, uni)
    return _REF_RUNS[family, kv]


def _parts(tr):
    return {(part, k): v for part in ("leaves", "scales", "dense")
            for k, v in getattr(tr, part).items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes (bit-exact comparisons, float8 and bf16 too)."""
    return t.detach().contiguous().view(torch.uint8).numpy()


def _migrate(model, src, dst, slots, via_host):
    """Extract each slot of ``src``, send it through the host dict when
    ``via_host(slot)``, splice it into the same slot of ``dst``, and hand
    over the decode carries by copy."""
    for slot in slots:
        tr = extract_page_block(src.state, slot, model)
        if via_host(slot):
            tr = PageBlockTransfer.from_dict(tr.to_dict())
        assert splice_page_block(dst.state, slot, tr, model)
    dst.state.tokens.copy_(src.state.tokens)
    dst.state.pos.copy_(src.state.pos)


# ---------------------------------------------------------------------------
# the payload against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("family", FAMILIES)
def test_payload_matches_reference(family, kv):
    """Keys, shapes, dtypes, token counts and bytes equal; values within
    F32_TOL (int8 pages: dequantized within QUANT_TOL, scales in f32)."""
    payloads = _ref_run(family, kv)[0]
    tmodel, _, eng = _port_engine(family, kv)
    for slot, ref in enumerate(payloads):
        tr = extract_page_block(eng.state, slot, tmodel)
        assert (tr.kv_dtype, tr.page_size, tr.n_tokens, tr.n_tokens_total,
                tr.n_blocks, tr.nbytes()) \
            == (ref.kv_dtype, ref.page_size, ref.n_tokens,
                ref.n_tokens_total, ref.n_blocks, ref.nbytes())
        got, want = _parts(tr), _parts(ref)
        assert got.keys() == want.keys()
        for key, t in got.items():
            w = np.asarray(want[key])
            assert t.shape == w.shape and str(t.dtype).endswith(
                str(w.dtype)), key
            if key[0] == "leaves" and kv != "none":
                sc = (tr.scales[key[1]], np.asarray(ref.scales[key[1]]))
                deq = np32(t) * np32(sc[0])[:, :, None, :, None]
                wdeq = w.astype(np.float32) * sc[1][:, :, None, :, None]
                np.testing.assert_allclose(deq, wdeq, atol=QUANT_TOL,
                                           err_msg=str(key))
            else:
                np.testing.assert_allclose(np32(t), w, **F32_TOL,
                                           err_msg=str(key))


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("family", FAMILIES)
def test_payload_exact_on_equal_pools(family, kv):
    """The reference's prefilled cache copied into the port's pool (both
    allocators give the same block tables): every leaf, scale row and
    dense row of the port's payload equals the reference's bit for bit."""
    uni = _ref_run(family, kv)[2]
    tmodel, _, eng = _port_engine(family, kv)
    np.testing.assert_array_equal(eng.state.pool.tables,
                                  uni.state.pool.tables)
    for k, leaf in eng.state.cache.items():
        leaf.copy_(torch.from_numpy(np.array(uni.state.cache[k])))
    for slot in range(2):
        got = _parts(extract_page_block(eng.state, slot, tmodel))
        want = _parts(jax_extract(uni.state, slot, uni.model))
        assert got.keys() == want.keys()
        for key, t in got.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]),
                                          err_msg=str(key))


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("family", FAMILIES)
def test_migrated_decode_parity(family, kv):
    """Prefill on A, slot 0 through the host dict and slot 1 device to
    device, splice into B, decode: within the bound of the unmigrated port
    engine and of the reference's migrated decode, argmax exact."""
    ref_logits = _ref_run(family, kv)[1]
    tmodel, tparams, uni = _port_engine(family, kv)
    _, _, src = _port_engine(family, kv)
    _, _, dst = _port_engine(family, kv, prefill=False)
    ptrs = {k: v.data_ptr() for k, v in dst.state.cache.items()}
    ptrs["slot_vectors"] = dst.state.slot_vectors.data_ptr()
    _migrate(tmodel, src, dst, range(2), via_host=lambda s: s == 0)
    assert {k: v.data_ptr() for k, v in dst.state.cache.items()} \
        == {k: ptrs[k] for k in dst.state.cache}
    assert dst.state.slot_vectors.data_ptr() == ptrs["slot_vectors"]
    tol = _tol(kv)
    tok, pos = uni.state.tokens.clone(), uni.state.pos.clone()
    assert torch.equal(dst.state.tokens, tok)
    for i in range(STEPS):
        lu, _ = tmodel.decode_step(tparams, uni.state.cache, tok, pos,
                                   block_tables=uni.state.tables_dev)
        lm, _ = tmodel.decode_step(tparams, dst.state.cache, tok, pos,
                                   block_tables=dst.state.tables_dev)
        assert float((lu - lm).abs().max()) <= tol, i
        assert torch.equal(lu.argmax(-1), lm.argmax(-1)), i
        assert float(np.abs(np32(lm) - ref_logits[i]).max()) <= tol, i
        assert np.array_equal(np32(lm).argmax(-1),
                              ref_logits[i].argmax(-1)), i
        tok = lu.argmax(-1).to(torch.int32)
        pos = pos + 1


@pytest.mark.parametrize("family", ["ssm", "hybrid", "encdec"])
def test_dense_state_rides_along(family):
    """Recurrent (SSM/conv) and cross-attention state is not paged; the
    transfer carries the slot's dense rows, without the batch axis."""
    tmodel, _, eng = _port_engine(family, "none")
    tr = extract_page_block(eng.state, 0, tmodel)
    want = {"ssm": (set(), {"ssm", "conv"}),
            "hybrid": ({"k", "v"}, {"ssm", "conv"}),
            "encdec": ({"k", "v"}, {"cross_k", "cross_v"})}[family]
    assert set(tr.leaves) == want[0] and not tr.scales
    assert set(tr.dense) == want[1]
    axes = tmodel.cache_slot_axes()
    for k, v in tr.dense.items():
        assert torch.equal(v, eng.state.cache[k].select(axes[k], 0))
        assert v.data_ptr() != eng.state.cache[k].data_ptr()   # a copy


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------

def _filled_state(kv_dtype, compute_dtype="float32", seed=0):
    """A transformer pool at the smoke width, slot 1 holding 40 tokens'
    pages, every leaf filled with seeded values (bf16 / fp8 / int8 bits
    that numpy has no dtype for, in the bf16 and fp8 cases)."""
    cfg = dataclasses.replace(twin()[2], compute_dtype=compute_dtype)
    model = build_model(cfg, block_k=16, device="cpu")
    st = PagedBatchState(model, 2, 64, page_size=16, kv_dtype=kv_dtype)
    assert st.pool.allocate(1, 40)
    g = torch.Generator().manual_seed(seed)
    for leaf in st.cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g) * 3)
    for k in st.paged_keys:                  # the parking page stays zero
        st.cache[k][:, 0].zero_()
        if st.quant is not None:
            st.cache[scale_key(k)][:, 0].zero_()
    st.pos[1] = 37
    return model, st


@pytest.mark.parametrize("kv_dtype,compute,want", [
    ("none", "bfloat16", torch.bfloat16),
    ("int8", "float32", torch.int8),
    ("fp8_e4m3", "float32", torch.float8_e4m3fn)])
def test_host_round_trip_is_bit_exact(kv_dtype, compute, want):
    model, st = _filled_state(kv_dtype, compute)
    tr = extract_page_block(st, 1, model)
    assert tr.n_tokens == 37 and tr.n_tokens_total == 40 \
        and tr.n_blocks == 3
    d = tr.to_dict()
    assert all(isinstance(a, np.ndarray)
               for part in ("leaves", "scales", "dense")
               for a in d[part].values())
    back = PageBlockTransfer.from_dict(d)
    assert (back.kv_dtype, back.page_size, back.n_tokens,
            back.n_tokens_total) == (tr.kv_dtype, tr.page_size,
                                     tr.n_tokens, tr.n_tokens_total)
    a, b = _parts(tr), _parts(back)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(_bits(a[key]), _bits(b[key]))
    assert all(v.dtype == want for v in back.leaves.values())
    assert back.nbytes() == tr.nbytes()
    # landed in another pool, the pages hold the same bytes
    dst = PagedBatchState(model, 2, 64, page_size=16, kv_dtype=kv_dtype)
    assert splice_page_block(dst, 0, back, model)
    ids = torch.from_numpy(dst.pool.tables[0, :3].astype(np.int64))
    for k in st.paged_keys:
        np.testing.assert_array_equal(
            _bits(dst.cache[k].index_select(1, ids)), _bits(tr.leaves[k]))


@pytest.mark.parametrize("kv_dtype", ["none", "int8", "fp8_e4m3"])
def test_splice_writes_in_place_and_spares_parking(kv_dtype):
    model, st = _filled_state(kv_dtype)
    tr = extract_page_block(st, 1, model)
    dst = PagedBatchState(model, 2, 64, page_size=16, kv_dtype=kv_dtype)
    dst.pool.allocate(0, 20)                 # a spacer: other page ids
    dst.sync_tables()
    ptrs = {k: v.data_ptr() for k, v in dst.cache.items()}
    ptrs["tables_dev"] = dst.tables_dev.data_ptr()
    assert splice_page_block(dst, 1, tr, model)
    assert ptrs == dict({k: v.data_ptr() for k, v in dst.cache.items()},
                        tables_dev=dst.tables_dev.data_ptr())
    ids = dst.pool.tables[1, :tr.n_blocks]
    assert 0 not in ids.tolist()
    assert sorted(ids.tolist()) != sorted(st.pool.tables[1, :3].tolist())
    for k in dst.paged_keys:
        keys = [k] + ([scale_key(k)] if dst.quant is not None else [])
        for key in keys:
            assert not _bits(dst.cache[key][:, 0]).any(), key
    axes = model.cache_slot_axes()
    for k in tr.dense:
        assert torch.equal(dst.cache[k].select(axes[k], 1), tr.dense[k])
    np.testing.assert_array_equal(dst.tables_dev.numpy(), dst.pool.tables)
    with pytest.raises(ValueError, match="already holds pages"):
        splice_page_block(dst, 1, tr, model)


def test_backpressure_leaves_the_device_alone():
    """A pool that cannot cover the reservation returns False and changes
    no device tensor, no allocator state."""
    model, st = _filled_state("int8")
    tr = extract_page_block(st, 1, model)
    tiny = PagedBatchState(model, 2, 64, page_size=16, n_pages=3,
                           kv_dtype="int8")
    for leaf in tiny.cache.values():
        leaf.copy_(torch.full(leaf.shape, 7))
    before = {k: v.clone() for k, v in tiny.cache.items()}
    before["tables_dev"] = tiny.tables_dev.clone()
    free, version = tiny.pool.n_free, tiny.pool.version
    assert splice_page_block(tiny, 0, tr, model) is False
    assert tiny.pool.n_free == free and tiny.pool.version == version
    assert int(tiny.pool.n_blocks[0]) == 0
    after = dict(tiny.cache, tables_dev=tiny.tables_dev)
    for k, t in before.items():
        assert torch.equal(t, after[k]), k


def test_mismatches_and_empty_slots_raise():
    model, st = _filled_state("int8")
    tr = extract_page_block(st, 1, model)
    with pytest.raises(ValueError, match="kv_dtype mismatch"):
        splice_page_block(PagedBatchState(model, 2, 64, page_size=16),
                          0, tr, model)
    with pytest.raises(ValueError, match="page_size mismatch"):
        splice_page_block(PagedBatchState(model, 2, 64, page_size=32,
                                          kv_dtype="int8"), 0, tr, model)
    with pytest.raises(ValueError, match="no pages"):
        extract_page_block(st, 0, model)


@pytest.mark.parametrize("kv", KV)
def test_parity_survives_page_aliasing(kv):
    """After extraction the source frees its pages and a new tenant
    overwrites them, while the destination (a spacer holding its low
    pages) lands the transfer on other page ids: the migrated slot still
    decodes as the unmigrated engine's."""
    tmodel, tparams, uni = _port_engine("transformer", kv)
    _, _, src = _port_engine("transformer", kv)
    _, _, dst = _port_engine("transformer", kv, prefill=False)
    dst.state.pool.allocate(0, 40)
    tr = PageBlockTransfer.from_dict(
        extract_page_block(src.state, 1, tmodel).to_dict())
    src_ids = src.state.pool.tables[1, :tr.n_blocks].copy()
    pool = src.state.pool
    pool.free(1)
    pool.allocate(1, int(pool.used_tokens[0]))
    idx = torch.from_numpy(src_ids.astype(np.int64))
    for k in src.state.paged_keys:
        src.state.cache[k][:, idx] = 1
    assert splice_page_block(dst.state, 1, tr, tmodel)
    dst_ids = dst.state.pool.tables[1, :tr.n_blocks]
    assert 0 not in dst_ids.tolist()
    assert sorted(dst_ids.tolist()) != sorted(src_ids.tolist())
    dst.state.tokens.copy_(uni.state.tokens)
    dst.state.pos.copy_(uni.state.pos)
    tok, pos = uni.state.tokens.clone(), uni.state.pos.clone()
    for i in range(STEPS):
        lu, _ = tmodel.decode_step(tparams, uni.state.cache, tok, pos,
                                   block_tables=uni.state.tables_dev)
        ld, _ = tmodel.decode_step(tparams, dst.state.cache, tok, pos,
                                   block_tables=dst.state.tables_dev)
        assert float((lu[1] - ld[1]).abs().max()) <= _tol(kv), i
        assert int(lu[1].argmax()) == int(ld[1].argmax()), i
        tok = lu.argmax(-1).to(torch.int32)
        pos = pos + 1


@pytest.mark.parametrize("kv", KV)
def test_reference_transfer_dict_lands_in_port_pool(kv):
    """A reference transfer's host dict (numpy, no dtype names) loads into
    the port, splices, and decodes within the bound of the port's
    unmigrated engine (argmax exact)."""
    model, params, ref_src = _ref_engine("transformer", kv)
    tmodel, tparams, uni = _port_engine("transformer", kv)
    _, _, dst = _port_engine("transformer", kv, prefill=False)
    for slot in range(2):
        d = jax_extract(ref_src.state, slot, model).to_dict()
        back = JaxTransfer.from_dict(d)      # the reference's own form
        assert back.n_blocks == PageBlockTransfer.from_dict(d).n_blocks
        assert splice_page_block(dst.state, slot,
                                 PageBlockTransfer.from_dict(d), tmodel)
    tok, pos = uni.state.tokens.clone(), uni.state.pos.clone()
    for i in range(STEPS):
        lu, _ = tmodel.decode_step(tparams, uni.state.cache, tok, pos,
                                   block_tables=uni.state.tables_dev)
        lm, _ = tmodel.decode_step(tparams, dst.state.cache, tok, pos,
                                   block_tables=dst.state.tables_dev)
        assert float((lu - lm).abs().max()) <= _tol(kv), i
        assert torch.equal(lu.argmax(-1), lm.argmax(-1)), i
        tok = lu.argmax(-1).to(torch.int32)
        pos = pos + 1
