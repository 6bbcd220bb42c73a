"""Shared model-building blocks of the port (PyTorch, functional).

The dense, MoE and encoder-decoder subset of the JAX package's
``models/common.py`` (cross-attention included): the
same public names and the same tensor layouts at every function, so the
tests can hold each against its counterpart.  Parameters are nested dicts
of tensors; norm scales (and the MoE router, read in f32) stay float32 and
every matrix and embedding is cast to the activations' dtype at each use
(:func:`cast`), as the JAX package casts them.  Serving keeps its weights
in the compute dtype, where the cast returns the same tensor and launches
nothing; training keeps float32 masters, and the cast is where their
gradients come back to float32.

Where the JAX package returns an updated copy of a cache (``.at[].set``),
the port writes the cache tensors in place and returns them; rows the
reference drops as out of range (``mode="drop"``) are filtered or clamped
here, since PyTorch has no drop mode and an out-of-range index on the card
is a device-side assert.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_prefill, paged_flash_decode
from ..kernels.flash_attention.prefill import query_scale
from ..kernels.rmsnorm import rmsnorm

Params = Dict[str, object]

NEG_INF = -1e30


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in ``dtype``; the same tensor when it already is (eager
    serving is host-bound, and a no-op ``Tensor.to`` still costs a call)."""
    return x if x.dtype == dtype else x.to(dtype)


# ---------------------------------------------------------------------------
# Parameter leaves: shape and logical axes declared once
# ---------------------------------------------------------------------------


class Leaf(NamedTuple):
    """One parameter leaf as a model declares it: its shape and, for each
    dim, the reference's logical axis name (``"embed"``, ``"heads"``,
    ``"mlp"``, ...; ``None`` for a dim never sharded).  A model's
    ``param_shapes()`` and ``param_axes()`` both read its one tree of
    leaves, as the reference's ``ParamBuilder`` gives its abstract tree and
    its axes from one declaration, so the two cannot drift apart."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]


def leaf(shape, axes) -> Leaf:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"leaf of shape {shape} names {len(axes)} axes "
                         f"{axes}")
    return Leaf(shape, axes)


def stack_leaves(tree, n: int):
    """Every leaf of ``tree`` with a leading layer dim of ``n``, named
    ``"layers"`` (the reference's ``_stack_tree``; no rule shards it)."""
    if isinstance(tree, Leaf):
        return Leaf((n,) + tree.shape, ("layers",) + tree.axes)
    return {k: stack_leaves(v, n) for k, v in tree.items()}


def leaf_shapes(tree):
    """The tree of ``tree``'s leaf shapes."""
    if isinstance(tree, Leaf):
        return tree.shape
    return {k: leaf_shapes(v) for k, v in tree.items()}


def leaf_axes(tree):
    """The tree of ``tree``'s leaf axis names."""
    if isinstance(tree, Leaf):
        return tree.axes
    return {k: leaf_axes(v) for k, v in tree.items()}


def norm_leaves(d: int, kind: str) -> Params:
    """A norm's scale, and its bias for LayerNorm (``init_norm``)."""
    p = {"scale": leaf((d,), ("embed",))}
    if kind == "layer":
        p["bias"] = leaf((d,), ("embed",))
    return p


def attention_leaves(d_in: int, n_heads: int, n_kv: int, head_dim: int,
                     d_out: Optional[int] = None) -> Params:
    """The four projections of an attention block (``init_attention``)."""
    d_out = d_out or d_in
    return {"wq": leaf((d_in, n_heads, head_dim), ("embed", "heads", None)),
            "wk": leaf((d_in, n_kv, head_dim), ("embed", "kv", None)),
            "wv": leaf((d_in, n_kv, head_dim), ("embed", "kv", None)),
            "wo": leaf((n_heads, head_dim, d_out), ("heads", None, "embed"))}


def embedding_leaves(vocab: int, d: int, tie: bool, max_seq: int = 0,
                     learned_pos: bool = False) -> Params:
    """Token embeddings, a learned position table, and the head when the
    embeddings are not tied (``init_embedding``)."""
    p = {"wte": leaf((vocab, d), ("vocab", "embed"))}
    if learned_pos:
        p["wpe"] = leaf((max_seq, d), (None, "embed"))
    if not tie:
        p["head"] = leaf((d, vocab), ("embed", "vocab"))
    return p


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm goes through the fused kernel (its plain version on the
    CPU); LayerNorm, which has no TPU kernel, is PyTorch's on f32 rows
    (the reference's f32 mean, biased variance and rsqrt, then the f32
    scale and bias), cast back to x's dtype."""
    if kind == "rms":
        return rmsnorm(x, p["scale"], eps)
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang = positions.float()[..., None] * inv                  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, softcap: float = 0.0,
                      block_k: int = 1024,
                      kv_valid_len: Optional[torch.Tensor] = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D); ``kv_valid_len`` (B,) masks
    key positions >= each row's valid length.  Runs the prefill attention
    kernel on the card, its plain version (key blocks of ``block_k``) on the
    CPU.  Returns (B, Sq, H, D)."""
    return flash_prefill(q, k, v, kv_valid_len, causal=causal, window=window,
                         softcap=softcap, q_offset=q_offset, block_k=block_k)


def decode_attention(q, k_cache, v_cache, *, pos, window: int = 0,
                     softcap: float = 0.0):
    """Single-token attention against a dense cache.

    q: (B, 1, H, D); caches: (B, Smax, KV, D); pos: (B,) the new token's
    position (cache entries > pos are invalid).
    """
    B, _, H, D = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    # in q's dtype by the factor rounded to it, as the reference scales q
    qr = q.reshape(B, KV, G, D) * query_scale(D, q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(Smax, device=q.device)[None, :]
    valid = k_pos <= pos[:, None]
    if window > 0:
        valid &= k_pos > (pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def dense_cache_write(cache: torch.Tensor, new: torch.Tensor,
                      pos: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Write one token's K (or V) per slot into a dense cache, in place.

    cache: (B, Smax, KV, D); new: (B, KV, D); pos: (B,); rows:
    ``arange(B)`` on the cache's device.  A frozen slot parked at
    ``pos == Smax`` writes nothing (the reference drops that scatter): its
    row rewrites the old value."""
    S = cache.shape[1]
    slot = torch.clamp(pos, max=S - 1)
    keep = (pos < S)[:, None, None]
    cache[rows, slot] = torch.where(keep, new, cache[rows, slot])
    return cache


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) @ w: (d, H, D) -> (B, S, H, D)."""
    d, H, D = w.shape
    return (x @ cast(w, x.dtype).reshape(d, H * D)).view(x.shape[0],
                                                          x.shape[1], H, D)


def attention_block(p: Params, x: torch.Tensor, *, cfg_theta: float,
                    positional: str, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    block_k: int = 1024, kv_x: Optional[torch.Tensor] = None,
                    return_kv: bool = False,
                    kv_valid_len: Optional[torch.Tensor] = None):
    """Attention block over x (B, S, d), and over a cross input ``kv_x``
    (B, Sk, d) when given: projections (k and v from ``kv_x``), RoPE (on k
    only for self-attention), attention, output projection.  A cross
    input drops the causal mask (``causal and kv_x is None``), as the
    reference does; with ``return_kv`` the (k, v) returned are then the
    cross input's.  ``kv_valid_len`` (B,) masks key positions >= the
    per-row valid length (batched bucketed prefill).  Attention is
    differentiable under the JAX package's own condition for its Pallas
    training kernels (no softcap, no ``q_offset``, no ``kv_valid_len``;
    see ``flash_prefill``); a cross input takes that path too (the
    reference differentiates its jnp attention there)."""
    kv_src = x if kv_x is None else kv_x
    q = project_heads(x, p["wq"])
    k = project_heads(kv_src, p["wk"])
    v = project_heads(kv_src, p["wv"])
    if positional == "rope":
        positions = q_offset + torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, positions, cfg_theta)
        if kv_x is None:
            k = apply_rope(k, positions, cfg_theta)
    o = chunked_attention(q, k, v, causal=causal and kv_x is None,
                          window=window, q_offset=q_offset, softcap=softcap,
                          block_k=block_k, kv_valid_len=kv_valid_len)
    H, D, d = p["wo"].shape
    out = o.reshape(x.shape[0], x.shape[1], H * D) \
        @ cast(p["wo"], x.dtype).reshape(H * D, d)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def apply_mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    def w(name):
        return cast(p[name], x.dtype)
    if activation == "swiglu":
        h = F.silu(x @ w("w_gate")) * (x @ w("w_up"))
    else:
        u = x @ w("w_up")
        if activation == "gelu":
            h = F.gelu(u, approximate="tanh")
        elif activation == "relu2":
            h = torch.square(F.relu(u))
        else:
            raise ValueError(activation)
    return h @ w("w_down")


def mlp_leaves(d: int, d_ff: int, activation: str) -> Params:
    """Leaves of one dense MLP (the reference's ``init_mlp``)."""
    p = {"w_up": leaf((d, d_ff), ("embed", "mlp")),
         "w_down": leaf((d_ff, d), ("mlp", "embed"))}
    if activation == "swiglu":
        p["w_gate"] = leaf((d, d_ff), ("embed", "mlp"))
    return p


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity-bounded in training)
# ---------------------------------------------------------------------------

def moe_leaves(d: int, d_ff: int, n_experts: int, activation: str,
               shared_expert: bool) -> Params:
    """Leaves of one MoE layer (the reference's ``init_moe``): the router
    (d, E), each expert's MLP stacked on a leading E dim, and the optional
    shared expert's dense MLP."""
    p: Params = {"router": leaf((d, n_experts), ("embed", "experts"))}
    for name, w in mlp_leaves(d, d_ff, activation).items():
        p[name] = leaf((n_experts,) + w.shape, ("experts",) + w.axes)
    if shared_expert:
        p["shared"] = mlp_leaves(d, d_ff, activation)
    return p


def route_top_k(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """Token-choice routing of xt (T, d): (f32 logits, softmax probs, top-k
    weights renormalised by ``max(sum, 1e-9)``, top-k experts), the k
    choices in descending order with the lower expert first on a tie, as
    ``lax.top_k`` orders them (a stable descending sort)."""
    logits = xt.float() @ router.float()                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_w, top_e


def expert_ranks(flat_e: torch.Tensor, n_experts: int):
    """(order, row, rank, counts) of the routed pairs ``flat_e`` (T * K,):
    the pairs sorted by expert (``order[i]`` is the pair at sorted row i,
    ``row`` its inverse), each pair's rank within its expert and each
    expert's pair count.  The sort is stable, so within an expert the pairs
    keep the flat order and a pair's rank (its row less its expert's start)
    is the reference's ``cumsum(one_hot) - one_hot``."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    row = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=flat_e.device))
    counts = torch.zeros(n_experts, dtype=torch.long,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    rank = row - (torch.cumsum(counts, 0) - counts)[flat_e]
    return order, row, rank, counts


def apply_moe(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, activation: str, shared_expert: bool,
              drop: bool = True):
    """The reference's ``apply_moe``: x (B, S, d) -> (y, aux).

    Routing by :func:`route_top_k` (f32 logits).  A routed pair (token t,
    choice j) takes its rank within its expert in the flat (T * K) order,
    token-major then the j-th choice; with ``drop`` (training) it counts
    only below the capacity ``C = max(int(cf * T * K / E), 1)``, without
    (serving) every pair counts.  The combine sums the kept pairs'
    outputs in f32, weighted by their top-k weights, and casts back; the
    shared expert, when configured, adds a dense MLP.  aux: the Switch load
    balance, the router z-loss and the dropped fraction, by the reference's
    formulas.

    Layout: where the reference scatters into an (E, C, d) buffer (at
    serving's C = T * K, E times the routed work), the port computes the
    same function over the T * K pairs sorted by expert, the reference's
    order kept within an expert (:func:`expert_ranks`).  The three expert
    products are ``torch._grouped_mm`` over those rows with offsets from
    the per-expert counts; a dropped pair is
    computed and masked out of the combine.  Every shape is fixed by
    (B, S): no host sync, so a decode step or prefill bucket stays
    capturable in a CUDA graph."""
    B, S, d = x.shape
    T, K, E = B * S, top_k, n_experts
    xt = x.reshape(T, d)
    logits, probs, top_w, top_e = route_top_k(xt, p["router"], K)
    flat_e = top_e.reshape(T * K)
    order, row, rank, counts = expert_ranks(flat_e, E)
    offs = torch.cumsum(counts, 0).to(torch.int32)

    def grouped(a, w):
        return torch._grouped_mm(a, cast(w, a.dtype), offs=offs)

    xs = xt[order // K]                                       # (T*K, d)
    if activation == "swiglu":
        h = F.silu(grouped(xs, p["w_gate"])) * grouped(xs, p["w_up"])
    else:
        u = grouped(xs, p["w_up"])
        if activation == "gelu":
            h = F.gelu(u, approximate="tanh")
        elif activation == "relu2":
            h = torch.square(F.relu(u))
        else:
            raise ValueError(activation)
    yp = grouped(h, p["w_down"])[row]                         # flat order
    if drop:
        C = max(int(capacity_factor * T * K / E), 1)
        keep = rank < C
        yp = torch.where(keep[:, None], yp, torch.zeros((), dtype=yp.dtype,
                                                        device=yp.device))
        # the mean as XLA computes the reference's (a division by a
        # constant becomes a product with its f32 reciprocal), so that the
        # dropped fraction is the reference's bit for bit
        dropped = 1.0 - keep.float().sum() * (1.0 / (T * K))
    else:
        dropped = torch.zeros((), device=x.device)
    y = (yp.reshape(T, K, d).float() * top_w[..., None]).sum(1)
    y = y.reshape(B, S, d).to(x.dtype)
    if shared_expert:
        y = y + apply_mlp(p["shared"], x, activation)

    aux = {"load_balance": E * (probs.mean(0)
                                * (counts.float() / max(T * K, 1))).sum(),
           "router_z": torch.logsumexp(logits, dim=-1).square().mean(),
           "dropped_frac": dropped}
    return y, aux


# ---------------------------------------------------------------------------
# KV cache slot updates (continuous batching)
# ---------------------------------------------------------------------------

def _staged(src, device) -> torch.Tensor:
    """Host array ``src`` as the tensor a copy to ``device`` reads: in
    pinned memory for a CUDA device, so that the copy can be queued
    without waiting (PyTorch's pinned-memory cache keeps the buffer until
    the copy has run)."""
    host = torch.from_numpy(np.ascontiguousarray(src))
    return host.pin_memory() if torch.device(device).type == "cuda" \
        else host


def to_device(src, device) -> torch.Tensor:
    """A copy of host array ``src`` on ``device``, queued on the current
    stream without waiting (``torch.tensor(..., device=...)`` synchronises
    the stream)."""
    return _staged(src, device).to(device, non_blocking=True, copy=True)


def upload(dst: torch.Tensor, src) -> torch.Tensor:
    """Copy host array ``src`` into ``dst`` in place, staged as
    :func:`to_device` stages it."""
    return dst.copy_(_staged(src, dst.device), non_blocking=True)


def write_cache_slot(pool: Params, sub: Params, slot: int,
                     axes: Params) -> Params:
    """Write a single-sequence cache ``sub`` (batch dim of size 1) into row
    ``slot`` of the pooled cache, in place."""
    for key, ax in axes.items():
        pool[key].narrow(ax, int(slot), 1).copy_(sub[key])
    return pool


def write_cache_slots(pool: Params, sub: Params, slots,
                      axes: Params) -> Params:
    """Batched :func:`write_cache_slot`: rows ``slots`` (N,) of the pool get
    the N rows of ``sub``, in place.  ``slots`` lives on the host; rows with
    an out-of-range slot (the padded admission rows carry ``slot ==
    n_slots``) are skipped, as the reference drops them."""
    slots = np.asarray(slots)
    for key, ax in axes.items():
        p = pool[key]
        rows = np.nonzero(slots < p.shape[ax])[0]
        if rows.size:
            idx = to_device(np.stack([slots[rows].astype(np.int64), rows]),
                            p.device)
            src = sub[key].index_select(ax, idx[1])
            p.index_copy_(ax, idx[0], src.to(p.dtype))
    return pool


# ---------------------------------------------------------------------------
# Paged KV cache (block-table indirection; serve/kv_pages.py owns the pool)
# ---------------------------------------------------------------------------

def _page_slots(block_tables, pos, page: int):
    """(page id, offset) of each slot's write at ``pos``.  The table column
    clamps to its last entry, as the reference's gather does, for a frozen
    slot parked one past the table."""
    col = torch.clamp(pos // page, max=block_tables.shape[1] - 1)
    arange = torch.arange(pos.shape[0], device=pos.device)
    pids = block_tables[arange, col].long()
    return pids, (pos % page).long()


def paged_cache_write(pages: torch.Tensor, new: torch.Tensor,
                      block_tables: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """Write one token's K (or V) per slot into the page pool, in place.

    pages: (P, page, KV, D); new: (B, KV, D); block_tables: (B, nb);
    pos: (B,).  Distinct live slots own distinct pages; frozen slots may
    collide only on the parking page 0, which no live slot reads.
    """
    pids, off = _page_slots(block_tables, pos, pages.shape[1])
    pages[pids, off] = new.to(pages.dtype)
    return pages


def kv_qmax(dtype) -> float:
    """Clip point of a quantized KV storage dtype (127 for int8, the max
    finite for float8 variants)."""
    if dtype.is_floating_point:
        return float(torch.finfo(dtype).max)
    return float(torch.iinfo(dtype).max)


def paged_cache_write_quant(pages: torch.Tensor, scales: torch.Tensor,
                            new: torch.Tensor, block_tables: torch.Tensor,
                            pos: torch.Tensor):
    """Quantizing variant of :func:`paged_cache_write`, in place.

    pages: (P, page, KV, D) int8 / fp8; scales: (P, KV) float32 absmax
    scales per (page, KV head); new: (B, KV, D).  Returns (pages, scales).

    Scale discipline: the first write into a page (``pos % page == 0``)
    resets its scale to the token's absmax (and zeroes the page's stale
    remainder); later writes only widen it, re-quantizing the page's
    existing entries onto the wider scale.
    """
    qmax = kv_qmax(pages.dtype)
    is_int = not pages.dtype.is_floating_point
    pids, off = _page_slots(block_tables, pos, pages.shape[1])
    arange = torch.arange(new.shape[0], device=new.device)
    newf = new.float()
    tok_scale = torch.clamp(newf.abs().amax(dim=-1) / qmax, min=1e-8)
    eff_old = torch.where((off == 0)[:, None], 0.0, scales[pids])
    new_scale = torch.maximum(eff_old, tok_scale)              # (B, KV)
    ratio = (eff_old / new_scale)[:, None, :, None]
    block = pages[pids].float() * ratio                        # (B, page, KV, D)
    if is_int:
        block = torch.round(block)
    q_tok = newf / new_scale[:, :, None]
    if is_int:
        q_tok = torch.round(q_tok)
    block[arange, off] = q_tok
    pages[pids] = torch.clamp(block, -qmax, qmax).to(pages.dtype)
    scales[pids] = new_scale
    return pages, scales


def paged_decode_attention(q, k_pages, v_pages, block_tables, *, pos,
                           window: int = 0, softcap: float = 0.0,
                           k_scales=None, v_scales=None):
    """Single-token attention against a paged cache: the paged decode
    kernel on the card, its gather-based plain version on the CPU.

    q: (B, 1, H, D); pools (P, page, KV, D); block_tables (B, nb); pos (B,).
    With ``k_scales``/``v_scales`` (P, KV) the pools hold quantized values.
    """
    return paged_flash_decode(q, k_pages, v_pages, block_tables, pos,
                              window=window, softcap=softcap,
                              k_scales=k_scales, v_scales=v_scales)


def gather_last_positions(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); lens: (B,) valid lengths.  Returns (B, 1, d) at the
    last valid position per row (right-padded batched prefill)."""
    idx = torch.clamp(lens.long() - 1, 0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def gather_tail_window(x: torch.Tensor, lens: torch.Tensor,
                       W: int) -> torch.Tensor:
    """Last ``W`` valid positions per row, zero-filled left of position 0.

    x: (B, S, ...); lens: (B,).  Returns (B, W, ...) holding positions
    ``lens - W .. lens - 1``: the conv-window tail of a right-padded batched
    prefill, where ``x[:, -W:]`` would capture padding instead.
    """
    pos = lens.long()[:, None] - W + torch.arange(W, device=x.device)[None]
    idx = torch.clamp(pos, 0, x.shape[1] - 1)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    gathered = x[rows, idx]                                   # (B, W, ...)
    keep = (pos >= 0).reshape(pos.shape + (1,) * (x.dim() - 2))
    return torch.where(keep, gathered, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def gather_ring_window(k: torch.Tensor, lens: torch.Tensor,
                       W: int) -> torch.Tensor:
    """Ring-arranged last ``W`` window: slot ``p % W`` holds position p.

    k: (B, S, ...); lens: (B,) per-row valid lengths.  Ring slot r gets the
    largest valid position congruent to r mod W, zeros where that position
    is negative: a local-attention layer's ring cache after a right-padded
    batched prefill (the reference's ``common.gather_ring_window``)."""
    r = torch.arange(W, device=k.device)[None, :]
    last = lens.long()[:, None] - 1
    pos = last - torch.remainder(last - r, W)                 # (B, W)
    idx = torch.clamp(pos, 0, k.shape[1] - 1)
    rows = torch.arange(k.shape[0], device=k.device)[:, None]
    gathered = k[rows, idx]                                   # (B, W, ...)
    keep = (pos >= 0).reshape(pos.shape + (1,) * (k.dim() - 2))
    return torch.where(keep, gathered, torch.zeros((), dtype=k.dtype,
                                                   device=k.device))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(p: Params, tokens: torch.Tensor, dtype,
                 pos_offset: int = 0) -> torch.Tensor:
    """Token embeddings of ``tokens`` (..., S) in ``dtype``; with a learned
    position table (``p["wpe"]``) plus the rows of positions
    ``pos_offset .. pos_offset + S - 1``, each table cast to ``dtype``
    before the sum, as the reference adds them.  A position past the
    table's rows raises: the reference's ``jnp.take`` fills such a row with
    NaN, and on the card the index would be a device-side assert."""
    x = cast(p["wte"][tokens], dtype)
    if "wpe" in p:
        S, rows = tokens.shape[-1], p["wpe"].shape[0]
        check_positions(pos_offset + S, rows)
        x = x + cast(p["wpe"][pos_offset:pos_offset + S], dtype)
    return x


def check_positions(n: int, rows: int) -> None:
    """Raise unless positions ``0 .. n - 1`` have rows in a learned position
    table of ``rows`` rows."""
    if n > rows:
        raise ValueError(f"positions up to {n - 1} need a learned position "
                         f"table of {n} rows; wpe has {rows} "
                         f"(max_train_seq)")


_VOCAB_PAD = 512


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits, padded to a multiple of 512 as the
    reference pads them (for its vocab sharding); pad columns hold -1e30.
    The padding is appended to the logits, never to the weight, by a
    concatenation that gradients pass through."""
    if "head" in p:
        logits = x @ cast(p["head"], x.dtype)        # head: (d, V)
    else:
        logits = x @ cast(p["wte"], x.dtype).t()     # wte: (V, d)
    V = logits.shape[-1]
    Vp = -(-V // _VOCAB_PAD) * _VOCAB_PAD
    if Vp != V:
        pad = logits.new_full(logits.shape[:-1] + (Vp - V,), -1e30)
        logits = torch.cat([logits, pad], dim=-1)
    return logits


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Token-level cross entropy in f32 with optional z-loss; logits
    (B, S, V), targets (B, S); the mean over tokens (over ``mask``ed
    tokens when given)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    if mask is None:
        return nll.sum() / nll.numel()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss(model, params: Params, batch, remat: bool = True):
    """The next-token loss of the reference's language models: embed
    ``batch["tokens"]`` in the model's compute dtype (behind
    ``batch["patch_embeds"]``, for a model that has ``_embed_input``), run
    ``model.forward_hidden`` (with ``remat``), drop the patch positions,
    then the final norm and the unembedding (``model.logits``), then the
    mean cross entropy with z-loss 1e-4 against ``batch["targets"]`` (over
    ``batch["mask"]`` when given).  An MoE model adds its layer-mean load
    balance and router z-loss at the config's weights and reports the
    three aux terms.  Returns (loss, metrics)."""
    cfg = model.cfg
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    patch = batch.get("patch_embeds")
    if patch is None:
        x = embed_tokens(params["embed"], tokens, model.compute_dtype)
    else:
        x = model._embed_input(params, tokens, patch)
    x, aux = model.forward_hidden(params, x, remat=remat)
    logits = model.logits(params, x[:, x.shape[1] - tokens.shape[1]:])
    targets = torch.as_tensor(batch["targets"], device=model.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=model.device)
    loss = softmax_cross_entropy(logits, targets, mask, z_loss=1e-4)
    metrics = {"ce_loss": loss}
    if cfg.is_moe:
        loss = (loss + cfg.moe.aux_loss_weight * aux["load_balance"]
                + cfg.moe.router_z_loss_weight * aux["router_z"])
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics
