"""The split-key paged decode kernel's algorithm against the JAX package, on
the CPU.

``csrc/paged_decode.cu`` splits each slot's keys over blocks
(flash-decoding): block ``(h, b, s)`` walks the pages of split ``s`` that
hold visible keys, in tiles of 64 keys of which each of its 4 warps takes
16 with its own running max, sum and accumulator; a quantized pool's
scales multiply the score and the probability, once per key, not each
element; the warps merge at the end of the split, a split with no visible
page writes an empty partial (max -1e30, sum 0), and a combine pass merges
the partials.  ``recipe_decode`` below is a plain PyTorch model of exactly
that algorithm, using the port's own host-side ``split_plan``; it lives
here only, not in the port.  It is held against the JAX package's
``paged_attention_ref`` in f32 at ``F32_TOL``, on the same bf16, int8 and
fp8 pools.  The wrapper's plain version on CPU tensors stays
``paged_attention_ref`` itself.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import paged_attention_ref as jax_paged
from repro_torch.kernels.flash_attention import paged_flash_decode
from repro_torch.kernels.flash_attention.paged import (KERNEL_CASES,
                                                       KEYS_PER_SPLIT,
                                                       NEG_INF,
                                                       paged_attention_ref,
                                                       split_plan)
from torch_parity import F32_TOL, np32

# the kernel's instantiations: llama3.2-1b's group at head_dim 64, the
# card smoke config's, internvl2-1b's, seamless-m4t-medium's decoder's,
# gpt3-xl's, llama3.2-3b's, yi-34b's and llama4-scout's at head_dim 128,
# nemotron-4-340b's at head_dim 192 and zamba2-7b's shared block at
# head_dim 224
((_, KERNEL_GROUP, _), (_, SMOKE_GROUP, _), (VLM_HEAD_DIM, VLM_GROUP, _),
 (ENC_HEAD_DIM, ENC_GROUP, _), (GPT3_HEAD_DIM, GPT3_GROUP, _),
 (LLAMA3B_HEAD_DIM, LLAMA3B_GROUP, _), (YI_HEAD_DIM, YI_GROUP, _),
 (SCOUT_HEAD_DIM, SCOUT_GROUP, _), (NEMO_HEAD_DIM, NEMO_GROUP, _),
 (WIDE_HEAD_DIM, WIDE_GROUP, _)) = KERNEL_CASES
#: blocks over which the kernel splits a KV head's query rows at
#: nemotron-4-340b's (192, 12): 3 of 4 rows (``csrc/paged_decode.cu``)
NEMO_ROW_BLOCKS = 3

TILE, WARPS = 64, 4          # keys per ring stage; warps per block
WARP_KEYS = TILE // WARPS    # keys of a tile each warp takes
PAGE, NB, KV, D = 16, 16, 2, 64
MAX_SEQ = PAGE * NB


def _split_pages(s, kps, pos, window):
    """Pages [ja, jb) that split ``s`` walks; empty when ja >= jb."""
    pps = kps // PAGE
    n_pages = min(NB, pos // PAGE + 1)
    first = max(0, pos - window + 1) // PAGE if window > 0 else 0
    return max(s * pps, first), min((s + 1) * pps, n_pages)


def _block(qg, kp, vp, row, h, ja, jb, pos, window, softcap, ks, vs):
    """One block of the kernel: (max, sum, acc) of its split."""
    G, Dh = qg.shape
    ka, kb = ja * PAGE, jb * PAGE
    wm = torch.full((WARPS, G), NEG_INF)
    wl = torch.zeros(WARPS, G)
    wacc = torch.zeros(WARPS, G, Dh)
    for t0 in range(ka, kb, TILE):
        for w in range(WARPS):
            keys = torch.arange(t0 + w * WARP_KEYS, t0 + (w + 1) * WARP_KEYS)
            valid = (keys < kb) & (keys <= pos)
            if window > 0:
                valid &= keys > pos - window
            # keys at or past kb are zero-filled in the ring; they are
            # masked, so any finite stand-in gives the same sums
            kc = keys.clamp(max=kb - 1)
            pid = row[kc // PAGE]
            kraw = kp[pid, kc % PAGE, h].float()               # (16, Dh)
            vraw = vp[pid, kc % PAGE, h].float()
            ksc = ks[pid, h] if ks is not None else torch.ones(WARP_KEYS)
            vsc = vs[pid, h] if vs is not None else torch.ones(WARP_KEYS)
            s = (qg @ kraw.T) * ksc                             # (G, 16)
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(valid, s, torch.tensor(NEG_INF))
            m_new = torch.maximum(wm[w], s.max(dim=1).values)
            m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
            corr = torch.where(wm[w] <= NEG_INF, 0.0,
                               torch.exp(wm[w] - m_safe))
            p = torch.exp(s - m_safe[:, None])
            wl[w] = wl[w] * corr + p.sum(dim=1)
            wacc[w] = wacc[w] * corr[:, None] + (p * vsc) @ vraw
            wm[w] = m_new
    M = wm.max(dim=0).values
    f = torch.exp(wm - torch.where(M <= NEG_INF, 0.0, M))
    return M, (wl * f).sum(dim=0), (wacc * f[..., None]).sum(dim=0)


def recipe_decode(q, kp, vp, tables, pos, *, window=0, softcap=0.0,
                  k_scales=None, v_scales=None,
                  keys_per_split=KEYS_PER_SPLIT, row_blocks=1):
    """The kernel's algorithm.  Returns the output (B, 1, H, Dh) in q's
    dtype and, per (slot, KV head), which splits were empty (KV heads and
    head_dim Dh from the pools).  With ``row_blocks`` the G query rows of
    a KV head run as that many blocks of G / row_blocks rows, each with
    its own partials and combine, as the kernel runs them at (192, 12)."""
    B, _, H, _ = q.shape
    KV, Dh = kp.shape[2], kp.shape[3]
    G = H // KV
    kps, n_split = split_plan(NB, PAGE, keys_per_split)
    qr = q.float().reshape(B, KV, G, Dh) * Dh ** -0.5
    out = torch.empty(B, KV, G, Dh)
    empty = torch.zeros(B, KV, n_split, dtype=torch.bool)
    GB = G // row_blocks
    for b in range(B):
        p_b = int(pos[b])
        for h in range(KV):
            for r in range(row_blocks):
                rows = slice(r * GB, (r + 1) * GB)
                parts = []
                for s in range(n_split):
                    ja, jb = _split_pages(s, kps, p_b, window)
                    if ja >= jb:
                        empty[b, h, s] = True
                        continue
                    parts.append(_block(qr[b, h, rows], kp, vp,
                                        tables[b].long(), h, ja, jb, p_b,
                                        window, softcap, k_scales, v_scales))
                # the combine pass: empty partials skipped
                M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                L = sum(l * torch.exp(m - M) for m, l, _ in parts)
                acc = sum(a * torch.exp(m - M)[:, None]
                          for m, _, a in parts)
                out[b, h, rows] = acc / torch.clamp(L, min=1e-20)[:, None]
    return out.reshape(B, 1, H, Dh).to(q.dtype), empty


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

_POOL = {"bf16": (jnp.bfloat16, torch.bfloat16, None),
         "int8": (jnp.int8, torch.int8, 127.0),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn, 448.0)}


def _positions(kps):
    """Split and page edges, the table's last key and a slot parked at
    pos == max_seq (its whole table allocated)."""
    return np.array([0, 15, 16, kps - 1, kps, MAX_SEQ - 1, MAX_SEQ],
                    np.int32)


def _operands(pool, pos, seed=0, d=D, group=KERNEL_GROUP):
    """Seeded q (f32), pools of one type stored identically for both
    packages, tables whose entries past each slot's last page are parked
    at page 0, and per-(page, KV head) scales for quantized pools; head_dim
    ``d`` and ``group`` query heads per KV head (llama3.2-1b's by
    default)."""
    rng = np.random.default_rng(seed)
    B, H = len(pos), group * KV
    P = B * NB + 1
    q = rng.normal(size=(B, 1, H, d)).astype(np.float32)
    kf = rng.normal(size=(P, PAGE, KV, d)).astype(np.float32)
    vf = rng.normal(size=(P, PAGE, KV, d)).astype(np.float32)
    tables = np.zeros((B, NB), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b, p in enumerate(pos):
        n = min(NB, int(p) // PAGE + 1)
        tables[b, :n] = perm[b * NB:b * NB + n]
    jd, td, qmax = _POOL[pool]
    ks = vs = None
    if qmax is not None:
        ks = (np.abs(kf).max(axis=(1, 3)) / qmax + 1e-8).astype(np.float32)
        vs = (np.abs(vf).max(axis=(1, 3)) / qmax + 1e-8).astype(np.float32)
        kf = np.clip(kf / ks[:, None, :, None], -qmax, qmax)
        vf = np.clip(vf / vs[:, None, :, None], -qmax, qmax)
        if pool == "int8":
            kf, vf = np.round(kf), np.round(vf)
    jk, jv = jnp.asarray(kf).astype(jd), jnp.asarray(vf).astype(jd)
    tk, tv = torch.tensor(kf).to(td), torch.tensor(vf).to(td)
    assert np.array_equal(np32(jk), np32(tk))     # same stored values
    assert np.array_equal(np32(jv), np32(tv))
    return q, (jk, jv, tk, tv), tables, ks, vs


# window reaching back across split edges, a softcap that bites, a softcap
# of 50 (the size served models use) with a window
_MASKS = [(0, 0.0), (40, 0.0), (0, 2.0), (100, 50.0)]


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("kps", [16, 64, 128])
@pytest.mark.parametrize("window,softcap", _MASKS)
def test_split_recipe_matches_reference(pool, kps, window, softcap):
    pos = _positions(kps)
    q, (jk, jv, tk, tv), tables, ks, vs = _operands(pool, pos, seed=kps)
    jsc = {} if ks is None else {"k_scales": jnp.asarray(ks),
                                 "v_scales": jnp.asarray(vs)}
    tsc = {} if ks is None else {"k_scales": torch.tensor(ks),
                                 "v_scales": torch.tensor(vs)}
    ref = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                    jnp.asarray(pos), window=window, softcap=softcap, **jsc)
    got, empty = recipe_decode(torch.tensor(q), tk, tv, torch.tensor(tables),
                               torch.tensor(pos), window=window,
                               softcap=softcap, keys_per_split=kps, **tsc)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(ref), **F32_TOL)
    # pos 0 sees one key: every split after the first is empty
    assert bool(empty[0, :, 1:].all()) and not bool(empty[0, :, 0].any())


def _one_group_recipe_matches(pool, kps, window, softcap, d, group,
                              row_blocks=1):
    """The recipe at head_dim ``d`` with ``group`` (1, 3, 5, 7 or 12)
    query heads per KV head, in ``row_blocks`` blocks of rows, against the
    reference, on the split and page edges."""
    pos = _positions(kps)
    q, (jk, jv, tk, tv), tables, ks, vs = _operands(
        pool, pos, seed=kps + d, d=d, group=group)
    jsc = {} if ks is None else {"k_scales": jnp.asarray(ks),
                                 "v_scales": jnp.asarray(vs)}
    tsc = {} if ks is None else {"k_scales": torch.tensor(ks),
                                 "v_scales": torch.tensor(vs)}
    ref = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                    jnp.asarray(pos), window=window, softcap=softcap, **jsc)
    got, empty = recipe_decode(torch.tensor(q), tk, tv, torch.tensor(tables),
                               torch.tensor(pos), window=window,
                               softcap=softcap, keys_per_split=kps,
                               row_blocks=row_blocks, **tsc)
    assert got.shape == q.shape == (len(pos), 1, group * KV, d)
    np.testing.assert_allclose(np32(got), np32(ref), **F32_TOL)
    assert bool(empty[0, :, 1:].all()) and not bool(empty[0, :, 0].any())


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("kps", [16, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 50.0)])
def test_split_recipe_matches_reference_at_head_dim_224(pool, kps, window,
                                                        softcap):
    """zamba2-7b's instantiation, head_dim 224 with one query head per KV
    head (a key on 28 lanes, one key a step): each warp still takes 16
    keys of a tile, so the same recipe models it, on the pools it is built
    for."""
    _one_group_recipe_matches(pool, kps, window, softcap, WIDE_HEAD_DIM,
                              WIDE_GROUP)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("kps", [16, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 50.0)])
def test_split_recipe_matches_reference_at_head_dim_128(pool, kps, window,
                                                        softcap):
    """gpt3-xl's instantiation, head_dim 128 with one query head per KV
    head (a key on 16 lanes, 2 keys a step): the same 16 keys a warp takes
    of a tile, on the pools it is built for."""
    assert (GPT3_HEAD_DIM, GPT3_GROUP) == (128, 1)
    _one_group_recipe_matches(pool, kps, window, softcap, GPT3_HEAD_DIM,
                              GPT3_GROUP)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("kps", [16, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 50.0)])
def test_split_recipe_matches_reference_at_head_dim_128_group_3(
        pool, kps, window, softcap):
    """llama3.2-3b's instantiation, head_dim 128 with 3 query heads per KV
    head (a key on 16 lanes, 2 keys a step, 3 query rows of partials), on
    the pools it is built for."""
    assert (LLAMA3B_HEAD_DIM, LLAMA3B_GROUP) == (128, 3)
    _one_group_recipe_matches(pool, kps, window, softcap, LLAMA3B_HEAD_DIM,
                              LLAMA3B_GROUP)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("kps", [16, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 50.0)])
@pytest.mark.parametrize("which", ["internvl2", "yi"])
def test_split_recipe_matches_reference_at_group_7(which, pool, kps, window,
                                                   softcap):
    """internvl2-1b's instantiation, head_dim 64 with 7 query heads per KV
    head (a key on 8 lanes, 4 keys a step), and yi-34b's, head_dim 128
    with 7 (16 lanes, 2 keys a step): 7 query rows of partials, on the
    pools they are built for."""
    d, g = (VLM_HEAD_DIM, VLM_GROUP) if which == "internvl2" \
        else (YI_HEAD_DIM, YI_GROUP)
    assert (d, g) == ((64, 7) if which == "internvl2" else (128, 7))
    _one_group_recipe_matches(pool, kps, window, softcap, d, g)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("kps", [16, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 50.0)])
@pytest.mark.parametrize("which", ["llama4-scout", "nemotron"])
def test_split_recipe_matches_reference_at_groups_5_and_12(which, pool, kps,
                                                           window, softcap):
    """llama4-scout's instantiation (its global layers), head_dim 128 with
    5 query heads per KV head (16 lanes a key, 2 keys a step, 5 query rows
    of partials), and nemotron-4-340b's, head_dim 192 with 12 (a key on 24
    lanes, one key a step), its 12 rows run as 3 blocks of 4, each with
    its own partials and combine, on the pools they are built for."""
    if which == "nemotron":
        assert (NEMO_HEAD_DIM, NEMO_GROUP) == (192, 12)
        _one_group_recipe_matches(pool, kps, window, softcap, NEMO_HEAD_DIM,
                                  NEMO_GROUP, row_blocks=NEMO_ROW_BLOCKS)
    else:
        assert (SCOUT_HEAD_DIM, SCOUT_GROUP) == (128, 5)
        _one_group_recipe_matches(pool, kps, window, softcap, SCOUT_HEAD_DIM,
                                  SCOUT_GROUP)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("kps", [16, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 50.0)])
def test_split_recipe_matches_reference_at_head_dim_64_group_1(
        pool, kps, window, softcap):
    """seamless-m4t-medium's decoder instantiation, head_dim 64 with one
    query head per KV head (16 over 16: a key on 8 lanes, 4 keys a step,
    one query row of partials), on the pools it is built for and serves."""
    assert (ENC_HEAD_DIM, ENC_GROUP) == (64, 1)
    _one_group_recipe_matches(pool, kps, window, softcap, ENC_HEAD_DIM,
                              ENC_GROUP)


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("kps", [16, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 50.0)])
def test_split_recipe_matches_reference_at_group_2(pool, kps, window,
                                                   softcap):
    """The card smoke config's instantiation (and granite-moe's): head_dim
    64 with 2 query heads per KV head, the same lanes a key as at group 4
    with 2 query rows of partials, on every pool type it is built for."""
    pos = _positions(kps)
    q, (jk, jv, tk, tv), tables, ks, vs = _operands(
        pool, pos, seed=kps + 2, group=SMOKE_GROUP)
    jsc = {} if ks is None else {"k_scales": jnp.asarray(ks),
                                 "v_scales": jnp.asarray(vs)}
    tsc = {} if ks is None else {"k_scales": torch.tensor(ks),
                                 "v_scales": torch.tensor(vs)}
    ref = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                    jnp.asarray(pos), window=window, softcap=softcap, **jsc)
    got, empty = recipe_decode(torch.tensor(q), tk, tv, torch.tensor(tables),
                               torch.tensor(pos), window=window,
                               softcap=softcap, keys_per_split=kps, **tsc)
    assert got.shape == q.shape == (len(pos), 1, SMOKE_GROUP * KV, D)
    np.testing.assert_allclose(np32(got), np32(ref), **F32_TOL)
    assert bool(empty[0, :, 1:].all()) and not bool(empty[0, :, 0].any())


@pytest.mark.parametrize("kps", [16, 64, 128])
@pytest.mark.parametrize("window", [0, 40, 256])
def test_empty_splits_are_those_with_no_visible_key(kps, window):
    """A split is skipped exactly when the reference's mask admits none of
    its keys, so skipping computes the same function."""
    pos = _positions(kps)
    _, n_split = split_plan(NB, PAGE, kps)
    keys = np.arange(n_split * kps)
    for p in pos:
        visible = (keys <= p) & (keys < MAX_SEQ)
        if window > 0:
            visible &= keys > p - window
        for s in range(n_split):
            ja, jb = _split_pages(s, kps, int(p), window)
            assert (ja >= jb) == (not visible[s * kps:(s + 1) * kps].any()), \
                (p, s, window)


@pytest.mark.parametrize("page", [1, 16, 32])
@pytest.mark.parametrize("nb", [1, 3, 64, 65])
@pytest.mark.parametrize("kps", [16, 64, 128, 256])
def test_split_plan_covers_every_page_once(page, nb, kps):
    """Splits are whole pages, cover every page of the table exactly once,
    and none lies wholly past the table."""
    kps_eff, n_split = split_plan(nb, page, kps)
    assert kps_eff % page == 0 and kps_eff >= page
    assert kps_eff == max(page, kps // page * page)
    pps = kps_eff // page
    owner = [j // pps for j in range(nb)]
    assert sorted(set(owner)) == list(range(n_split))
    assert all(sum(1 for s in range(n_split)
                   if s * pps <= j < (s + 1) * pps) == 1 for j in range(nb))


def test_split_count_depends_on_the_table_alone():
    """``split_plan`` takes no positions, so the grid is the same at every
    decode step (sync-free, graph-capturable); only which splits are empty
    changes with the positions."""
    assert list(inspect.signature(split_plan).parameters) == \
        ["nb", "page", "keys_per_split"]
    kps = 64
    q, (_, _, tk, tv), tables, _, _ = _operands("bf16", _positions(kps))
    counts = set()
    for shift in (0, 40):
        pos = torch.tensor(np.minimum(_positions(kps) + shift, MAX_SEQ))
        _, empty = recipe_decode(torch.tensor(q), tk, tv,
                                 torch.tensor(tables), pos,
                                 keys_per_split=kps)
        assert empty.shape[2] == split_plan(NB, PAGE, kps)[1]
        counts.add(int(empty.sum()))
    assert len(counts) == 2


def test_cpu_wrapper_is_the_gather_reference():
    """On CPU tensors the wrapper returns ``paged_attention_ref``'s result
    itself, not the split recipe's."""
    pos = _positions(64)
    q, (_, _, tk, tv), tables, _, _ = _operands("bf16", pos)
    args = (torch.tensor(q), tk, tv, torch.tensor(tables), torch.tensor(pos))
    assert torch.equal(paged_flash_decode(*args, window=40, softcap=2.0),
                       paged_attention_ref(*args, window=40, softcap=2.0))
