"""The port's kernel modules against their JAX counterparts, on the CPU.

Each kernel wrapper sends a CPU tensor to its plain PyTorch version; these
tests hold that plain version against the function the JAX package runs
(the Pallas kernels' oracles), on the same seeded numpy inputs.  The CUDA
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import ctypes
import glob
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import paged_attention_ref as jax_paged
from repro.kernels.rmsnorm import rmsnorm_ref as jax_rmsnorm
from repro.models import common as jcm
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_prefill,
                                                 paged_flash_decode)
from repro_torch.kernels.flash_attention.paged import launch_split
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import common as tcm
from torch_parity import BF16_TOL, F32_TOL, np32

DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _pair(a: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 5, 64), (4, 2048)])
def test_rmsnorm_matches_reference(shape, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    w = (1.0 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    jx, tx = _pair(x, dtype)
    tol = DTYPES[dtype][2]
    got = rmsnorm(tx, torch.tensor(w))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(np32(got), np32(jax_rmsnorm(jx, jnp.asarray(w))),
                               **tol)
    # the model-level entry point takes the same path
    np.testing.assert_allclose(
        np32(tcm.apply_norm({"scale": torch.tensor(w)}, tx, "rms")),
        np32(jcm.apply_norm({"scale": jnp.asarray(w)}, jx, "rms")), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [3584, 7168])
def test_rmsnorm_matches_reference_at_hybrid_widths(d, dtype):
    """zamba2-7b's widths: d_model 3584, and 7168 (its d_inner, and the
    shared block's concat(h, emb)), at a few rows."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(3, d)).astype(np.float32) * 3.0
    w = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = rmsnorm(tx, torch.tensor(w))
    np.testing.assert_allclose(np32(got), np32(jax_rmsnorm(jx, jnp.asarray(w))),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_reference_at_llama3b_width(dtype):
    """llama3.2-3b's d_model 3072, at a few rows."""
    rng = np.random.default_rng(3072)
    x = rng.normal(size=(3, 3072)).astype(np.float32) * 3.0
    w = (1.0 + 0.1 * rng.normal(size=3072)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = rmsnorm(tx, torch.tensor(w))
    np.testing.assert_allclose(np32(got),
                               np32(jax_rmsnorm(jx, jnp.asarray(w))),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_reference_at_llama4_width(dtype):
    """llama4-scout-17b-a16e's d_model 5120, at a few rows."""
    rng = np.random.default_rng(5120)
    x = rng.normal(size=(3, 5120)).astype(np.float32) * 3.0
    w = (1.0 + 0.1 * rng.normal(size=5120)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = rmsnorm(tx, torch.tensor(w))
    np.testing.assert_allclose(np32(got),
                               np32(jax_rmsnorm(jx, jnp.asarray(w))),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_reference_at_vlm_width(dtype):
    """internvl2-1b's d_model 896, at a few rows, against the JAX package's
    ``rmsnorm_ref`` and its model-level ``apply_norm``."""
    rng = np.random.default_rng(896)
    x = rng.normal(size=(3, 896)).astype(np.float32) * 3.0
    w = (1.0 + 0.1 * rng.normal(size=896)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(np32(rmsnorm(tx, torch.tensor(w))),
                               np32(jax_rmsnorm(jx, jnp.asarray(w))), **tol)
    np.testing.assert_allclose(
        np32(tcm.apply_norm({"scale": torch.tensor(w)}, tx, "rms")),
        np32(jcm.apply_norm({"scale": jnp.asarray(w)}, jx, "rms")), **tol)


def test_rmsnorm_kernel_chunks_cover_the_row_once():
    """``csrc/rmsnorm.cu``'s layout at d 896: lane l holds chunk i at
    values 8 (32 i + l) .. + 7, 3 chunks on every lane and a 4th on lanes
    0-15 only (``rmsnorm_kernel<4, 16>``); together they hold every value
    of the row exactly once, and the dispatch names that instantiation."""
    CPL, LAST = 4, 16
    held = [8 * (32 * i + lane) + j for i in range(CPL) for lane in range(32)
            if i < CPL - 1 or lane < LAST for j in range(8)]
    assert sorted(held) == list(range(896))
    assert 256 * (CPL - 1) + 8 * LAST == 896
    with open(os.path.join(_build.CSRC, "rmsnorm.cu")) as f:
        src = f.read()
    assert re.search(r"case 896:.*\n\s*return launch_rms<4, 16>\(", src)


# ---------------------------------------------------------------------------
# prefill attention with per-row valid lengths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_prefill_attention_matches_chunked_attention(G, D, dtype):
    rng = np.random.default_rng(G * 100 + D)
    B, S, KV = 3, 40, 2
    q = rng.normal(size=(B, S, KV * G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    vl = np.array([S, 23, 1], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    ref = jcm.chunked_attention(jq, jk, jv, causal=True, block_k=16,
                                kv_valid_len=jnp.asarray(vl))
    got = flash_prefill(tq, tk, tv, torch.tensor(vl), causal=True,
                        block_k=16)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(np32(got), np32(ref), **DTYPES[dtype][2])


def _one_group_prefill_matches(D, dtype, G=1, window=0):
    """The prefill at head_dim ``D`` with ``G`` query heads per KV head (2
    KV heads) over ragged rows, with a local ``window`` or none, against
    the reference's ``chunked_attention``."""
    rng = np.random.default_rng(D)
    B, S, KV = 2, 40, 2
    q, k, v = (rng.normal(size=(B, S, heads, D)).astype(np.float32)
               for heads in (G * KV, KV, KV))
    vl = np.array([S, 17], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    ref = jcm.chunked_attention(jq, jk, jv, causal=True, window=window,
                                block_k=16, kv_valid_len=jnp.asarray(vl))
    got = flash_prefill(tq, tk, tv, torch.tensor(vl), causal=True,
                        window=window, block_k=16)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(np32(got), np32(ref), **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_attention_matches_chunked_attention_at_head_dim_224(dtype):
    """zamba2-7b's shared block: head_dim 224, one query head per KV head,
    ragged rows; in bf16 the scaled q rounds as the reference's does."""
    _one_group_prefill_matches(224, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_attention_matches_chunked_attention_at_head_dim_128(dtype):
    """gpt3-xl's attention: head_dim 128, one query head per KV head (MHA),
    ragged rows; in bf16 the scaled q rounds as the reference's does."""
    _one_group_prefill_matches(128, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_attention_matches_chunked_attention_at_head_dim_128_group_3(
        dtype):
    """llama3.2-3b's attention: head_dim 128, 3 query heads per KV head
    (6 over 2 here), ragged rows."""
    _one_group_prefill_matches(128, dtype, G=3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
def test_prefill_attention_matches_chunked_attention_at_group_7(D, dtype):
    """7 query heads per KV head (14 over 2 here): internvl2-1b's attention
    at head_dim 64 and yi-34b's at 128, ragged rows."""
    _one_group_prefill_matches(D, dtype, G=7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D,G,window", [(128, 5, 0), (128, 5, 9),
                                        (192, 12, 0)])
def test_prefill_attention_matches_chunked_attention_at_groups_5_and_12(
        D, G, window, dtype):
    """llama4-scout's attention, head_dim 128 with 5 query heads per KV
    head (10 over 2 here), global and local (a window of 9 over ragged
    rows of 40 and 17: the short row's padded queries see no valid key in
    their window), and nemotron-4-340b's, head_dim 192 with 12 (24 over
    2)."""
    _one_group_prefill_matches(D, dtype, G=G, window=window)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Sq,Sk", [(40, 40), (37, 70), (5, 40), (70, 21)])
@pytest.mark.parametrize("G", [1, 2])
def test_prefill_attention_non_causal_matches_chunked_attention(G, Sq, Sk,
                                                                dtype):
    """seamless-m4t-medium's non-causal attention at head_dim 64: its
    encoder's self-attention (Sq == Sk) and its decoder's cross-attention
    (a prompt bucket of Sq text positions over Sk encoder frames, Sq != Sk,
    the last query and key blocks partial), one query head per KV head as
    it is served and 2, against the reference's ``chunked_attention`` with
    ``causal=False``; and with the log-sum-exp, every query's sum runs
    over all Sk keys."""
    rng = np.random.default_rng(Sq * 100 + Sk + G)
    B, KV, D = 2, 2, 64
    q = rng.normal(size=(B, Sq, G * KV, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
            for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    ref = jcm.chunked_attention(jq, jk, jv, causal=False, block_k=16)
    got = flash_prefill(tq, tk, tv, causal=False, block_k=16)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(np32(got), np32(ref), **DTYPES[dtype][2])
    out, lse = flash_prefill(tq, tk, tv, causal=False, block_k=16,
                             return_lse=True)
    assert torch.equal(out, got) and lse.shape == (B, G * KV, Sq)
    s = np.einsum("bqhd,bkhd->bhqk", np32(tq) / 8.0,
                  np.repeat(np32(tk), G, axis=2))
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(np32(lse), want, **DTYPES[dtype][2])


@pytest.mark.parametrize("D", [224, 32, 128])
def test_prefill_plain_version_scales_q_as_the_reference(D):
    """The plain prefill's bf16 scaled q is JAX's ``q * D ** -0.5`` bit for
    bit (one elementwise rounding), read out through the log-sum-exp: row
    j of a batch of one query and one key has key e_j, so its only score,
    and its log-sum-exp, is element j of the scaled q.  Multiplying by the
    f32 factor, as the port did before, differs in some elements at these
    head_dims (at 64 the factor is exact in bf16; gpt3-xl's 128 is not)."""
    rng = np.random.default_rng(D)
    H = 16
    q_row = rng.normal(size=(1, 1, H, D)).astype(np.float32)
    q = torch.tensor(np.repeat(q_row, D, axis=0)).bfloat16()
    k = torch.eye(D)[:, None, None, :].expand(D, 1, H, D).bfloat16()
    _, lse = flash_prefill(q, k, torch.zeros_like(k), return_lse=True)
    want = np32(jnp.asarray(q_row, jnp.bfloat16) * D ** -0.5)[0, 0]
    assert np.array_equal(np32(lse[:, :, 0]).T, want)
    assert not np.array_equal(np32(q[0, 0] * D ** -0.5), want)


@pytest.mark.parametrize("window,softcap", [(7, 0.0), (0, 2.5), (9, 1.5)])
def test_prefill_attention_window_softcap(window, softcap):
    """Window and softcap masks, every query row compared: a padded query
    row whose window holds no valid key averages the values its window
    admits, as the reference does."""
    rng = np.random.default_rng(7)
    B, S, H, KV, D = 2, 33, 4, 2, 16
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    vl = np.array([S, 12], np.int32)
    ref = np32(jcm.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, softcap=softcap, block_k=16,
        kv_valid_len=jnp.asarray(vl)))
    got = np32(flash_prefill(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), torch.tensor(vl),
                             window=window, softcap=softcap, block_k=16))
    np.testing.assert_allclose(got, ref, **F32_TOL)


def test_prefill_attention_without_valid_len_is_plain_causal():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
               for _ in range(3))
    ref = jcm.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, block_k=8)
    got = flash_prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        block_k=8)
    np.testing.assert_allclose(np32(got), np32(ref), **F32_TOL)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_operands(pool: str, seed=0, B=3, H=4, KV=2, D=32, P=16, page=16,
                    nb=4):
    """Pools, tables with parking entries (0) past each slot's position,
    positions, and per-(page, KV-head) scales for quantized pools."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb) \
        .astype(np.int32)
    kf = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    vf = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    if pool in ("f32", "bf16"):
        return q, kf, vf, tables, None, None
    qmax = {"int8": 127.0, "fp8": 448.0}[pool]
    ks = (np.abs(kf).max(axis=(1, 3)) / qmax + 1e-8).astype(np.float32)
    vs = (np.abs(vf).max(axis=(1, 3)) / qmax + 1e-8).astype(np.float32)
    kq = np.clip(kf / ks[:, None, :, None], -qmax, qmax)
    vq = np.clip(vf / vs[:, None, :, None], -qmax, qmax)
    if pool == "int8":
        kq, vq = np.round(kq), np.round(vq)
    return q, kq, vq, tables, ks, vs


_POOL = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16),
         "int8": (jnp.int8, torch.int8),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}

# pos 0 (all but one key masked), a window reaching into the prior page,
# softcap, both, and positions whose later table entries are parked
_COMBOS = [(0, 0.0, [0, 13, 30]), (20, 0.0, [0, 30, 47]),
           (0, 3.0, [0, 13, 30]), (12, 2.0, [5, 30, 63])]


@pytest.mark.parametrize("pool", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("window,softcap,positions", _COMBOS)
def test_paged_decode_matches_reference(pool, window, softcap, positions):
    q, kq, vq, tables, ks, vs = _paged_operands(pool)
    pos = np.asarray(positions, np.int32)
    page = kq.shape[1]
    for b, p in enumerate(pos):                  # park the unused tail
        tables[b, p // page + 1:] = 0
    jd, td = _POOL[pool]
    jk, jv = jnp.asarray(kq).astype(jd), jnp.asarray(vq).astype(jd)
    tk = torch.tensor(kq).to(td)
    tv = torch.tensor(vq).to(td)
    assert np.array_equal(np32(jk), np32(tk))    # same stored values
    jsc = {} if ks is None else {"k_scales": jnp.asarray(ks),
                                 "v_scales": jnp.asarray(vs)}
    tsc = {} if ks is None else {"k_scales": torch.tensor(ks),
                                 "v_scales": torch.tensor(vs)}
    ref = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                    jnp.asarray(pos), window=window, softcap=softcap, **jsc)
    got = paged_flash_decode(torch.tensor(q), tk, tv, torch.tensor(tables),
                             torch.tensor(pos), window=window,
                             softcap=softcap, **tsc)
    assert got.shape == (3, 1, 4, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(ref), **F32_TOL)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("window,softcap,positions", _COMBOS)
def test_paged_decode_matches_reference_at_head_dim_128(pool, window,
                                                        softcap, positions):
    """gpt3-xl's instantiation, head_dim 128 with one query head per KV
    head, on the pools it is built for (the values stored in bf16 or int8
    alike in both packages)."""
    q, kq, vq, tables, ks, vs = _paged_operands(pool, seed=128, H=2, D=128)
    pos = np.asarray(positions, np.int32)
    for b, p in enumerate(pos):                  # park the unused tail
        tables[b, p // kq.shape[1] + 1:] = 0
    jd, td = _POOL[pool]
    jk, jv = jnp.asarray(kq).astype(jd), jnp.asarray(vq).astype(jd)
    tk, tv = torch.tensor(kq).to(td), torch.tensor(vq).to(td)
    assert np.array_equal(np32(jk), np32(tk))    # same stored values
    jsc = {} if ks is None else {"k_scales": jnp.asarray(ks),
                                 "v_scales": jnp.asarray(vs)}
    tsc = {} if ks is None else {"k_scales": torch.tensor(ks),
                                 "v_scales": torch.tensor(vs)}
    ref = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                    jnp.asarray(pos), window=window, softcap=softcap, **jsc)
    got = paged_flash_decode(torch.tensor(q), tk, tv, torch.tensor(tables),
                             torch.tensor(pos), window=window,
                             softcap=softcap, **tsc)
    assert got.shape == (3, 1, 2, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(ref), **F32_TOL)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("window,softcap,positions", _COMBOS)
def test_paged_decode_matches_reference_at_head_dim_128_group_3(
        pool, window, softcap, positions):
    """llama3.2-3b's instantiation, head_dim 128 with 3 query heads per KV
    head (6 over 2 here), on the pools it is built for."""
    q, kq, vq, tables, ks, vs = _paged_operands(pool, seed=3, H=6, D=128)
    pos = np.asarray(positions, np.int32)
    for b, p in enumerate(pos):                  # park the unused tail
        tables[b, p // kq.shape[1] + 1:] = 0
    jd, td = _POOL[pool]
    jk, jv = jnp.asarray(kq).astype(jd), jnp.asarray(vq).astype(jd)
    tk, tv = torch.tensor(kq).to(td), torch.tensor(vq).to(td)
    assert np.array_equal(np32(jk), np32(tk))    # same stored values
    jsc = {} if ks is None else {"k_scales": jnp.asarray(ks),
                                 "v_scales": jnp.asarray(vs)}
    tsc = {} if ks is None else {"k_scales": torch.tensor(ks),
                                 "v_scales": torch.tensor(vs)}
    ref = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                    jnp.asarray(pos), window=window, softcap=softcap, **jsc)
    got = paged_flash_decode(torch.tensor(q), tk, tv, torch.tensor(tables),
                             torch.tensor(pos), window=window,
                             softcap=softcap, **tsc)
    assert got.shape == (3, 1, 6, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(ref), **F32_TOL)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("window,softcap,positions", _COMBOS)
@pytest.mark.parametrize("D", [64, 128])
def test_paged_decode_matches_reference_at_group_7(D, pool, window, softcap,
                                                   positions):
    """internvl2-1b's instantiation (head_dim 64) and yi-34b's (128), 7
    query heads per KV head (14 over 2 here), on the pools they are built
    for."""
    q, kq, vq, tables, ks, vs = _paged_operands(pool, seed=D + 7, H=14, D=D)
    pos = np.asarray(positions, np.int32)
    for b, p in enumerate(pos):                  # park the unused tail
        tables[b, p // kq.shape[1] + 1:] = 0
    jd, td = _POOL[pool]
    jk, jv = jnp.asarray(kq).astype(jd), jnp.asarray(vq).astype(jd)
    tk, tv = torch.tensor(kq).to(td), torch.tensor(vq).to(td)
    assert np.array_equal(np32(jk), np32(tk))    # same stored values
    jsc = {} if ks is None else {"k_scales": jnp.asarray(ks),
                                 "v_scales": jnp.asarray(vs)}
    tsc = {} if ks is None else {"k_scales": torch.tensor(ks),
                                 "v_scales": torch.tensor(vs)}
    ref = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                    jnp.asarray(pos), window=window, softcap=softcap, **jsc)
    got = paged_flash_decode(torch.tensor(q), tk, tv, torch.tensor(tables),
                             torch.tensor(pos), window=window,
                             softcap=softcap, **tsc)
    assert got.shape == (3, 1, 14, D) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(ref), **F32_TOL)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("window,softcap,positions", _COMBOS)
@pytest.mark.parametrize("D,G", [(128, 5), (192, 12)])
def test_paged_decode_matches_reference_at_groups_5_and_12(D, G, pool,
                                                           window, softcap,
                                                           positions):
    """llama4-scout's instantiation (its global layers: head_dim 128, 5
    query heads per KV head) and nemotron-4-340b's (head_dim 192, 12), 2
    KV heads here, on the pools they are built for."""
    q, kq, vq, tables, ks, vs = _paged_operands(pool, seed=D + G, H=2 * G,
                                                D=D)
    pos = np.asarray(positions, np.int32)
    for b, p in enumerate(pos):                  # park the unused tail
        tables[b, p // kq.shape[1] + 1:] = 0
    jd, td = _POOL[pool]
    jk, jv = jnp.asarray(kq).astype(jd), jnp.asarray(vq).astype(jd)
    tk, tv = torch.tensor(kq).to(td), torch.tensor(vq).to(td)
    assert np.array_equal(np32(jk), np32(tk))    # same stored values
    jsc = {} if ks is None else {"k_scales": jnp.asarray(ks),
                                 "v_scales": jnp.asarray(vs)}
    tsc = {} if ks is None else {"k_scales": torch.tensor(ks),
                                 "v_scales": torch.tensor(vs)}
    ref = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                    jnp.asarray(pos), window=window, softcap=softcap, **jsc)
    got = paged_flash_decode(torch.tensor(q), tk, tv, torch.tensor(tables),
                             torch.tensor(pos), window=window,
                             softcap=softcap, **tsc)
    assert got.shape == (3, 1, 2 * G, D) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(ref), **F32_TOL)


# ---------------------------------------------------------------------------
# routing by device
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    """CPU calls never reach the kernels: every launch counter stays 0."""
    kernels.reset_launch_counts()
    x = torch.randn(4, 64)
    rmsnorm(x, torch.ones(64))
    q, kq, vq, tables, _, _ = _paged_operands("f32")
    paged_flash_decode(torch.tensor(q), torch.tensor(kq), torch.tensor(vq),
                       torch.tensor(tables), torch.tensor([1, 2, 3]))
    q = torch.randn(1, 8, 2, 16)
    o, lse = flash_prefill(q, q, q, return_lse=True)
    flash_attention_bwd(q, q, q, o, o, lse)
    ssd_scan(q, torch.zeros(1, 8, 2), q[:, :, :1], q[:, :, :1], 4)
    assert kernels.launch_counts() == {"rmsnorm": 0, "flash_prefill": 0,
                                       "flash_bwd": 0, "paged_decode": 0,
                                       "ssd_scan": 0}


def test_non_cpu_tensors_never_take_the_plain_versions():
    """A tensor off the CPU launches the kernel or raises; with no card
    here, a tensor on the meta device must raise."""
    x = torch.empty(4, 2048, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        rmsnorm(x, torch.empty(2048, device="meta"))
    q = torch.empty(1, 8, 2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_prefill(q, q, q)
    assert kernels.launch_counts()["rmsnorm"] == 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["rmsnorm_f32", "rmsnorm_uninstantiated_d",
                                  "prefill_f32", "prefill_d16",
                                  "paged_q_f32", "paged_group_2"])
def test_kernels_refuse_what_they_are_not_built_for(case):
    """Off the CPU, a dtype, width, head_dim or query group with no kernel
    instantiation raises before any launch (the kernels are built for the
    serving path's bf16: attention at head_dim 64, paged decode there
    with 4, 2, 7 or 1 query heads per KV head, both at head_dim 128 and 224
    with one and at head_dim 128 with 3 and 7, and RMSNorm at d 256, 896,
    1024, 2048, 3072, 3584 and 7168).  Group 2 at head_dim 64, built for the card
    smoke config, passes the case checks and stops only at the device
    check; group 3 is refused."""
    kernels.reset_launch_counts()
    if case == "rmsnorm_f32":
        with pytest.raises(TypeError, match="bf16"):
            rmsnorm(_meta(4, 64, dtype=torch.float32),
                    _meta(64, dtype=torch.float32))
    elif case == "rmsnorm_uninstantiated_d":
        with pytest.raises(ValueError, match=r"d in \(256, 896, 1024, "
                                             r"2048, 3072, 3584, 5120, "
                                             r"7168\), got d=512"):
            rmsnorm(_meta(4, 512), _meta(512, dtype=torch.float32))
    elif case == "paged_group_2":
        pages = _meta(3, 4, 2, 64)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            paged_flash_decode(_meta(1, 1, 4, 64), pages, pages,
                               _meta(1, 2, dtype=torch.int32),
                               _meta(1, dtype=torch.int32))
        with pytest.raises(ValueError, match=r"\[\(64, 4\), \(64, 2\), "
                                             r"\(64, 7\), \(64, 1\), "
                                             r"\(128, 1\), "
                                             r"\(128, 3\), \(128, 7\), "
                                             r"\(128, 5\), \(192, 12\), "
                                             r"\(224, 1\)\], got D=64, "
                                             r"H=6"):
            paged_flash_decode(_meta(1, 1, 6, 64), pages, pages,
                               _meta(1, 2, dtype=torch.int32),
                               _meta(1, dtype=torch.int32))
    elif case == "prefill_f32":
        q = _meta(1, 8, 2, 64, dtype=torch.float32)
        with pytest.raises(TypeError, match="bf16"):
            flash_prefill(q, q, q)
    elif case == "prefill_d16":
        q = _meta(1, 8, 2, 16)
        with pytest.raises(ValueError, match="head_dim 64 and for head_dim "
                                             "128 and 224 with one query "
                                             "head per KV head"):
            flash_prefill(q, q, q)
    else:
        pages = _meta(3, 4, 2, 64)
        with pytest.raises(TypeError, match="bf16 q"):
            paged_flash_decode(_meta(1, 1, 2, 64, dtype=torch.float32),
                               pages, pages,
                               _meta(1, 2, dtype=torch.int32),
                               _meta(1, dtype=torch.int32))
    assert kernels.launch_counts() == {"rmsnorm": 0, "flash_prefill": 0,
                                       "flash_bwd": 0, "paged_decode": 0,
                                       "ssd_scan": 0}


@pytest.mark.parametrize("case", ["prefill_224_group_2", "paged_224_fp8",
                                  "paged_224_f32", "paged_224_group_2",
                                  "rmsnorm_d4096"])
def test_kernels_refuse_around_the_hybrid_instantiations(case):
    """What zamba2-7b's instantiations do not cover raises before any
    launch: head_dim 224 with 2 query heads per KV head, fp8 and f32
    pools at head_dim 224, and a width between those built."""
    kernels.reset_launch_counts()
    if case == "prefill_224_group_2":
        q, kv = _meta(1, 8, 4, 224), _meta(1, 8, 2, 224)
        with pytest.raises(ValueError, match="got D=224, H=4, KV=2"):
            flash_prefill(q, kv, kv)
    elif case in ("paged_224_fp8", "paged_224_f32"):
        dt = torch.float8_e4m3fn if case == "paged_224_fp8" \
            else torch.float32
        pages = _meta(3, 4, 2, 224, dtype=dt)
        with pytest.raises(TypeError, match="bf16 and int8 pools"):
            paged_flash_decode(_meta(1, 1, 2, 224), pages, pages,
                               _meta(1, 2, dtype=torch.int32),
                               _meta(1, dtype=torch.int32),
                               k_scales=_meta(3, 2, dtype=torch.float32)
                               if dt != torch.float32 else None,
                               v_scales=_meta(3, 2, dtype=torch.float32)
                               if dt != torch.float32 else None)
    elif case == "paged_224_group_2":
        pages = _meta(3, 4, 2, 224)
        with pytest.raises(ValueError, match="got D=224, H=4, KV=2"):
            paged_flash_decode(_meta(1, 1, 4, 224), pages, pages,
                               _meta(1, 2, dtype=torch.int32),
                               _meta(1, dtype=torch.int32))
    else:
        with pytest.raises(ValueError, match="got d=4096"):
            rmsnorm(_meta(4, 4096), _meta(4096, dtype=torch.float32))
    assert kernels.launch_counts() == {"rmsnorm": 0, "flash_prefill": 0,
                                       "flash_bwd": 0, "paged_decode": 0,
                                       "ssd_scan": 0}


@pytest.mark.parametrize("case", ["prefill_128_group_2", "paged_128_fp8",
                                  "paged_128_group_2", "paged_128_int8"])
def test_kernels_refuse_around_the_gpt3_instantiations(case):
    """What gpt3-xl's instantiations (head_dim 128, one query head per KV
    head; paged decode over bf16 and int8 pools) do not cover raises
    before any launch; an int8 pool at 128 passes the case checks and
    stops only at the device check."""
    kernels.reset_launch_counts()
    scales = dict(k_scales=_meta(3, 2, dtype=torch.float32),
                  v_scales=_meta(3, 2, dtype=torch.float32))
    tables, pos = _meta(1, 2, dtype=torch.int32), _meta(1, dtype=torch.int32)
    if case == "prefill_128_group_2":
        q, kv = _meta(1, 8, 4, 128), _meta(1, 8, 2, 128)
        with pytest.raises(ValueError, match="got D=128, H=4, KV=2"):
            flash_prefill(q, kv, kv)
    elif case == "paged_128_fp8":
        pages = _meta(3, 4, 2, 128, dtype=torch.float8_e4m3fn)
        with pytest.raises(TypeError, match="head_dim 128 with 1 query "
                                            "heads per KV head is built for "
                                            "bf16 and int8 pools"):
            paged_flash_decode(_meta(1, 1, 2, 128), pages, pages, tables,
                               pos, **scales)
    elif case == "paged_128_group_2":
        pages = _meta(3, 4, 2, 128)
        with pytest.raises(ValueError, match="got D=128, H=4, KV=2"):
            paged_flash_decode(_meta(1, 1, 4, 128), pages, pages, tables,
                               pos)
    else:
        pages = _meta(3, 4, 2, 128, dtype=torch.int8)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            paged_flash_decode(_meta(1, 1, 2, 128), pages, pages, tables,
                               pos, **scales)
    assert kernels.launch_counts() == {"rmsnorm": 0, "flash_prefill": 0,
                                       "flash_bwd": 0, "paged_decode": 0,
                                       "ssd_scan": 0}


@pytest.mark.parametrize("case", ["prefill_64_group_7", "prefill_128_group_7",
                                  "paged_64_group_7", "paged_64_group_7_int8",
                                  "paged_128_group_7",
                                  "paged_128_group_7_int8",
                                  "paged_64_group_7_fp8", "rmsnorm_d896"])
def test_kernels_take_the_group_7_instantiations(case):
    """internvl2-1b's and yi-34b's instantiations (7 query heads per KV
    head: the prefill at head_dim 64 and 128, paged decode there over bf16
    and int8 pools; RMSNorm at d 896) pass the case checks and stop only
    at the device check; an fp8 pool at group 7 is refused; nothing
    launches."""
    kernels.reset_launch_counts()
    scales = dict(k_scales=_meta(3, 2, dtype=torch.float32),
                  v_scales=_meta(3, 2, dtype=torch.float32))
    tables, pos = _meta(1, 2, dtype=torch.int32), _meta(1, dtype=torch.int32)
    D = 128 if "_128_" in case else 64
    if case.startswith("prefill"):
        q, kv = _meta(1, 8, 14, D), _meta(1, 8, 2, D)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            flash_prefill(q, kv, kv)
    elif case.endswith("fp8"):
        pages = _meta(3, 4, 2, D, dtype=torch.float8_e4m3fn)
        with pytest.raises(TypeError, match="head_dim 64 with 7 query "
                                            "heads per KV head is built for "
                                            "bf16 and int8 pools"):
            paged_flash_decode(_meta(1, 1, 14, D), pages, pages, tables,
                               pos, **scales)
    elif case.startswith("paged"):
        int8 = case.endswith("int8")
        pages = _meta(3, 4, 2, D, dtype=torch.int8 if int8
                      else torch.bfloat16)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            paged_flash_decode(_meta(1, 1, 14, D), pages, pages, tables,
                               pos, **(scales if int8 else {}))
    else:
        with pytest.raises(ValueError, match="expected a CUDA device"):
            rmsnorm(_meta(4, 896), _meta(896, dtype=torch.float32))
    assert kernels.launch_counts() == {"rmsnorm": 0, "flash_prefill": 0,
                                       "flash_bwd": 0, "paged_decode": 0,
                                       "ssd_scan": 0}


@pytest.mark.parametrize("case", ["prefill_cross", "prefill_encoder",
                                  "paged_64_group_1", "paged_64_group_1_int8",
                                  "paged_64_group_1_fp8"])
def test_kernels_take_the_encdec_instantiations(case):
    """seamless-m4t-medium's calls (16 heads over 16 at head_dim 64): the
    prefill non-causal at Sq == Sk (the encoder) and at Sq != Sk (the
    cross-attention, 37 text positions over 70 frames), paged decode at one
    query head per KV head over bf16 and int8 pools, pass the case checks
    and stop only at the device check; an fp8 pool there is refused;
    nothing launches."""
    kernels.reset_launch_counts()
    scales = dict(k_scales=_meta(3, 16, dtype=torch.float32),
                  v_scales=_meta(3, 16, dtype=torch.float32))
    tables, pos = _meta(1, 2, dtype=torch.int32), _meta(1, dtype=torch.int32)
    if case.startswith("prefill"):
        q = _meta(2, 37 if case == "prefill_cross" else 70, 16, 64)
        kv = _meta(2, 70, 16, 64)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            flash_prefill(q, kv, kv, causal=False)
    elif case.endswith("fp8"):
        pages = _meta(3, 4, 16, 64, dtype=torch.float8_e4m3fn)
        with pytest.raises(TypeError, match="head_dim 64 with 1 query "
                                            "heads per KV head is built for "
                                            "bf16 and int8 pools"):
            paged_flash_decode(_meta(1, 1, 16, 64), pages, pages, tables,
                               pos, **scales)
    else:
        int8 = case.endswith("int8")
        pages = _meta(3, 4, 16, 64, dtype=torch.int8 if int8
                      else torch.bfloat16)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            paged_flash_decode(_meta(1, 1, 16, 64), pages, pages, tables,
                               pos, **(scales if int8 else {}))
    assert kernels.launch_counts() == {"rmsnorm": 0, "flash_prefill": 0,
                                       "flash_bwd": 0, "paged_decode": 0,
                                       "ssd_scan": 0}


@pytest.mark.parametrize("case", ["prefill_128_group_3", "paged_128_group_3",
                                  "paged_128_group_3_int8",
                                  "paged_128_group_3_fp8",
                                  "prefill_128_group_4", "rmsnorm_d3072"])
def test_kernels_take_the_llama3b_instantiations(case):
    """llama3.2-3b's instantiations (head_dim 128 with 3 query heads per KV
    head, the prefill and paged decode over bf16 and int8 pools; RMSNorm at
    d 3072) pass the case checks and stop only at the device check; an fp8
    pool there and 4 query heads per KV head at 128 are refused; nothing
    launches."""
    kernels.reset_launch_counts()
    scales = dict(k_scales=_meta(3, 2, dtype=torch.float32),
                  v_scales=_meta(3, 2, dtype=torch.float32))
    tables, pos = _meta(1, 2, dtype=torch.int32), _meta(1, dtype=torch.int32)
    if case in ("prefill_128_group_3", "prefill_128_group_4"):
        G = 3 if case.endswith("3") else 4
        q, kv = _meta(1, 8, 2 * G, 128), _meta(1, 8, 2, 128)
        with pytest.raises(ValueError, match="expected a CUDA device"
                           if G == 3 else "got D=128, H=8, KV=2"):
            flash_prefill(q, kv, kv)
    elif case == "paged_128_group_3_fp8":
        pages = _meta(3, 4, 2, 128, dtype=torch.float8_e4m3fn)
        with pytest.raises(TypeError, match="head_dim 128 with 3 query "
                                            "heads per KV head is built for "
                                            "bf16 and int8 pools"):
            paged_flash_decode(_meta(1, 1, 6, 128), pages, pages, tables,
                               pos, **scales)
    elif case.startswith("paged"):
        int8 = case.endswith("int8")
        pages = _meta(3, 4, 2, 128, dtype=torch.int8 if int8
                      else torch.bfloat16)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            paged_flash_decode(_meta(1, 1, 6, 128), pages, pages, tables,
                               pos, **(scales if int8 else {}))
    else:
        with pytest.raises(ValueError, match="expected a CUDA device"):
            rmsnorm(_meta(4, 3072), _meta(3072, dtype=torch.float32))
    assert kernels.launch_counts() == {"rmsnorm": 0, "flash_prefill": 0,
                                       "flash_bwd": 0, "paged_decode": 0,
                                       "ssd_scan": 0}


@pytest.mark.parametrize("case", ["prefill_128_group_5", "prefill_192_group_12",
                                  "prefill_192_group_4", "paged_128_group_5",
                                  "paged_192_group_12_int8",
                                  "paged_192_group_12_fp8", "rmsnorm_d5120"])
def test_kernels_take_the_llama4_and_nemotron_instantiations(case):
    """llama4-scout's instantiations (head_dim 128 with 5 query heads per
    KV head, a window on the prefill; RMSNorm at d 5120) and
    nemotron-4-340b's (head_dim 192 with 12) pass the case checks and stop
    only at the device check; 4 query heads per KV head at 192 and an fp8
    pool there are refused; nothing launches."""
    kernels.reset_launch_counts()
    tables, pos = _meta(1, 2, dtype=torch.int32), _meta(1, dtype=torch.int32)
    D, G = (192, 12) if "192" in case else (128, 5)
    if case == "prefill_192_group_4":
        q, kv = _meta(1, 8, 8, 192), _meta(1, 8, 2, 192)
        with pytest.raises(ValueError, match="got D=192, H=8, KV=2"):
            flash_prefill(q, kv, kv)
    elif case.startswith("prefill"):
        q, kv = _meta(1, 8, 2 * G, D), _meta(1, 8, 2, D)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            flash_prefill(q, kv, kv, window=4 if G == 5 else 0)
    elif case.startswith("paged"):
        dt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(
            case.rsplit("_", 1)[-1], torch.bfloat16)
        pages = _meta(3, 4, 2, D, dtype=dt)
        scales = {} if dt == torch.bfloat16 else dict(
            k_scales=_meta(3, 2, dtype=torch.float32),
            v_scales=_meta(3, 2, dtype=torch.float32))
        error, match = (TypeError, "built for bf16 and int8 pools") \
            if dt == torch.float8_e4m3fn else (ValueError,
                                               "expected a CUDA device")
        with pytest.raises(error, match=match):
            paged_flash_decode(_meta(1, 1, 2 * G, D), pages, pages, tables,
                               pos, **scales)
    else:
        with pytest.raises(ValueError, match="expected a CUDA device"):
            rmsnorm(_meta(4, 5120), _meta(5120, dtype=torch.float32))
    assert kernels.launch_counts() == {"rmsnorm": 0, "flash_prefill": 0,
                                       "flash_bwd": 0, "paged_decode": 0,
                                       "ssd_scan": 0}


# ---------------------------------------------------------------------------
# the C interface of csrc/*.cu against _build.SIGNATURES
# ---------------------------------------------------------------------------

_CTYPE_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
                ctypes.c_longlong: "long long", ctypes.c_float: "float"}


def _c_kind(decl: str) -> str:
    """The kind of one C parameter declaration (its name dropped)."""
    words = decl.replace("*", " * ").split()
    if "*" in words:
        return "pointer"
    kind = " ".join(w for w in words[:-1] if w != "const")
    assert kind in _CTYPE_KINDS.values(), f"unmapped C type in {decl!r}"
    return kind


def _c_entry_points():
    """{name: (return type, [parameter kinds])} of every ``extern "C"``
    function in the kernel sources, and the file each one is in."""
    found, where = {}, {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))):
        with open(path) as f:
            text = f.read()
        for m in re.finditer(r'extern\s+"C"\s+([\w\s\*]+?)\s*(\w+)\s*'
                             r'\(([^)]*)\)\s*\{', text):
            ret, name, params = m.groups()
            assert name not in found, f"{name} defined twice"
            found[name] = (" ".join(ret.replace("*", " *").split())
                           .replace(" *", "*"),
                           [_c_kind(p) for p in params.split(",")
                            if p.strip()])
            where[name] = os.path.basename(path)
    return found, where


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_entry_point_matches_signature(name):
    """``ctypes`` passes each argument as ``SIGNATURES`` says: a mismatch
    in count or kind corrupts arguments only on the card, so every entry
    has a C definition with the same parameter kinds in the same order
    (and the return type ``library()`` sets: int, a C string for the error
    text)."""
    found, where = _c_entry_points()
    assert name in found, f"{name} is in SIGNATURES but in no csrc/*.cu"
    ret, kinds = found[name]
    want = [_CTYPE_KINDS[t] for t in _build.SIGNATURES[name]]
    assert kinds == want, f"{name} ({where[name]}): C {kinds} != {want}"
    assert ret == ("const char*" if name == "kernels_error_string"
                   else "int"), (name, ret)


def test_every_c_entry_point_has_a_signature():
    """No ``extern "C"`` function of the sources goes without its ctypes
    signature (``library()`` would leave its argument types to guesswork)."""
    found, where = _c_entry_points()
    missing = {n: where[n] for n in found if n not in _build.SIGNATURES}
    assert not missing, missing
    assert found, "no extern \"C\" function found in csrc/*.cu"


# ---------------------------------------------------------------------------
# the host side of a launch
# ---------------------------------------------------------------------------

def _c_dtype_codes():
    """{name: code} of ``enum DtypeCode`` in ``csrc/common.cuh``."""
    with open(os.path.join(_build.CSRC, "common.cuh")) as f:
        body = re.search(r"enum\s+DtypeCode\s*\{([^}]*)\}", f.read()).group(1)
    return {k.strip(): int(v) for k, v in
            (item.split("=") for item in body.split(",") if item.strip())}


@pytest.mark.parametrize("name", sorted(_build.DTYPE_CODES))
def test_dtype_code_matches_the_c_sources(name):
    """A tensor's dtype code is the one the C sources switch on."""
    c_names = {"float32": "kF32", "bfloat16": "kBF16", "int8": "kI8",
               "float8_e4m3fn": "kFP8"}
    code = _build.dtype_code(torch.empty(0, dtype=getattr(torch, name)))
    assert code == _build.DTYPE_CODES[name] == _c_dtype_codes()[c_names[name]]


def test_dtype_code_refuses_other_dtypes():
    with pytest.raises(TypeError, match="no kernel instantiation"):
        _build.dtype_code(torch.empty(0, dtype=torch.float16))


def test_paged_split_launch_off_cpu_raises_before_any_launch():
    """The split-size entry that the timing tool uses checks like the
    wrapper: a well-shaped call on meta tensors reaches the device check
    and raises there, at any split size, without counting a launch."""
    kernels.reset_launch_counts()
    pages = _meta(3, 16, 2, 64)
    for kps in (16, 64, 128):
        with pytest.raises(ValueError, match="CUDA device"):
            launch_split(_meta(1, 1, 8, 64), pages, pages,
                         _meta(1, 2, dtype=torch.int32),
                         _meta(1, dtype=torch.int32), 0, 0.0, None, None,
                         kps)
    assert kernels.launch_counts()["paged_decode"] == 0
