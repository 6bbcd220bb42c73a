"""One rank's sharded prefill and decode step of the decoder families:
dense, VLM and MoE.

What the reference gets from GSPMD when it jits ``DecoderLM.prefill`` and
the dense-cache branch of ``DecoderLM.decode_step`` on parameters laid out
by ``param_specs`` and caches laid out by ``cache_specs``, written out
over ``torch.distributed`` with no autograd.  The weights are used as the
sharded train step uses them (:class:`~repro_torch.parallel.train_step.
ShardedStep`: FSDP gathers on use, heads and ``d_ff`` computed locally
over ``model`` between f and g, the MoE layer's experts over ``model``
with every routed pair kept, as serving keeps them).  The batch's rows
are split over the data axes where ``batch_specs`` splits them.

* **The cache** holds, on each rank, its block by ``cache_specs``: its
  rows, every KV head, and a slice of the sequence (``max_seq``, or a
  local layer's ring of ``W`` slots) over ``model``, or over the data and
  model axes where the batch does not split (one long sequence).  That is
  context parallelism: the layout that lets the ``decode_32k`` and
  ``long_500k`` cells fit.  A ``max_seq`` below ``_SEQ_MIN`` (1024) makes
  ``cache_specs`` split head_dim instead, which this step refuses.
* **Prefill** is the model's own (``DecoderLM.prefill`` with the rank's
  hooks: weights made whole on use, f and g, the cache write); it runs
  the flash prefill kernel on the rank's heads and returns its rows'
  last-position logits and its cache blocks.  Its
  attention computes the rank's KV heads, and the cache keeps all KV heads
  for a slice of the sequence, so an all-to-all over ``model`` turns heads
  into sequence (:func:`~repro_torch.parallel.collectives.all_to_all`).
  Where the KV heads do not split over ``model`` (fewer KV heads than
  ranks), every rank projects all of them and keeps its slice.
* **Decode** gathers the new token's q, k and v over ``model`` (every
  head); the rank that owns the token's position writes its K/V; each
  rank attends over its slice of the sequence for every head and yields
  float32 ``(max, sum, out)`` partials, which are combined over the axes
  that hold the sequence; the rank keeps its heads of the output for the
  row-parallel ``wo``.  A local layer's ring slot s holds the position
  ``pos - (pos - s) % W`` (``DecoderLM._ring_attention``'s validity).
  The partial attention is plain PyTorch, as the reference's dense-cache
  decode is (no kernel computes it there).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..models import common as cm
from ..models.transformer import unstack_layers
from ..kernels.flash_attention.prefill import query_scale
from . import collectives as coll
from .sharding import (batch_specs, cache_specs, entry_names, local_slices,
                       mesh_coords)
from .train_step import ShardedStep


class SeqBlock(NamedTuple):
    """A cache leaf's sequence block on this rank: the first position (or
    ring slot), the count, and the process group of the mesh axes the
    sequence is split over (None for one rank)."""
    start: int
    size: int
    group: object


class ShardedServe:
    """One rank's sharded ``prefill`` and ``decode_step`` for a dense, VLM
    or MoE ``DecoderLM`` on a (data, model) ``DeviceMesh`` (``"pod"`` may
    lead), serving ``batch`` sequences in a cache of ``max_seq``
    positions (the cache layout is ``cache_specs`` of that cache).  Every
    rank of the mesh builds it, in the same order (it makes the process
    groups it needs).  The parameters are the rank's blocks by
    ``param_specs``; :meth:`local_rows` cuts a global input."""

    def __init__(self, model, mesh, batch: int, max_seq: int):
        self.plan = plan = ShardedStep(model, mesh)
        self.model, self.cfg = model, model.cfg
        self.batch, self.max_seq = batch, max_seq
        # serving keeps every routed pair and reads no aux term
        self.hooks = dict(plan.hooks)
        if "moe" in self.hooks:
            self.hooks["moe"] = plan.moe_shard(over_data=False)
        self.split = bool(batch_specs({"tokens": (batch,)}, plan.sizes)
                          ["tokens"])
        self.rows = batch // plan.dp if self.split else batch
        struct = model._cache_struct(batch, max_seq)
        self.cache_specs = cache_specs(struct, plan.sizes)
        coords = mesh_coords(mesh)
        self.seq: Dict[str, SeqBlock] = {}
        for name, leaf in struct.items():
            spec = self.cache_specs[name]
            dim = 3 if len(leaf.shape) == 6 else 2
            split = [d for d, e in enumerate(spec) if entry_names(e)]
            if any(d not in (dim - 1, dim) for d in split):
                raise NotImplementedError(
                    f"{self.cfg.name}: cache_specs splits {name} "
                    f"{leaf.shape} as {spec}; the sharded decode takes "
                    f"caches split over rows and sequence (max_seq of "
                    f"1024 or more)")
            names = entry_names(spec[dim]) if dim < len(spec) else ()
            cut = local_slices(leaf.shape, spec, plan.sizes, coords)[dim]
            self.seq[name] = SeqBlock(cut.start, cut.stop - cut.start,
                                      plan.group(names))

    # -- inputs ------------------------------------------------------------
    def local_rows(self, x) -> torch.Tensor:
        """This rank's rows of a global input (leading dim ``batch``), on
        the model's device."""
        x = torch.as_tensor(x, device=self.model.device)
        if self.split:
            i = self.plan.data_index
            x = x[i * self.rows:(i + 1) * self.rows]
        return x

    def local_cache(self, cache) -> Dict[str, torch.Tensor]:
        """This rank's blocks of a global cache tree, by ``cache_specs``
        (contiguous copies)."""
        coords = mesh_coords(self.plan.mesh)
        return {k: v[local_slices(v.shape, self.cache_specs[k],
                                  self.plan.sizes, coords)].contiguous()
                for k, v in cache.items()}

    def init_cache(self) -> Dict[str, torch.Tensor]:
        """Zeroed cache blocks of this rank."""
        coords = mesh_coords(self.plan.mesh)
        out = {}
        for k, s in self.model._cache_struct(self.batch,
                                             self.max_seq).items():
            cut = local_slices(s.shape, self.cache_specs[k],
                               self.plan.sizes, coords)
            out[k] = torch.zeros(tuple(c.stop - c.start for c in cut),
                                 dtype=s.dtype, device=self.model.device)
        return out

    def _ring(self) -> int:
        return min(self.cfg.attn_window, self.max_seq)

    def _rope(self, t, positions):
        cfg = self.cfg
        return cm.apply_rope(t, positions, cfg.rope_theta) \
            if cfg.positional == "rope" else t

    # -- prefill -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, patch_embeds=None):
        """Prefill this rank's rows ``tokens`` (rows, S) behind
        ``patch_embeds`` (rows, P, d) when given: returns (their
        last-position logits (rows, Vp), this rank's cache blocks), the
        reference's ``DecoderLM.prefill`` as its sharded jit computes it:
        the model's own prefill on the layers' weights made whole, with
        the tensor-parallel hooks, and each layer's keys and values
        written into the rank's sequence block (:meth:`_seq_block`)."""
        plan = self.plan
        tokens = torch.as_tensor(tokens, device=self.model.device)
        B, S = tokens.shape[0], tokens.shape[1] + (
            0 if patch_embeds is None else patch_embeds.shape[1])
        if B != self.rows or S > self.max_seq:
            raise ValueError(f"prefill of {(B, S)} on a rank of {self.rows} "
                             f"rows and max_seq {self.max_seq}")

        def write(dst, t, name):
            dst.copy_(self._seq_block(t, self.seq[name]))
        return self.model.prefill(
            plan.whole(params), tokens, patch_embeds, max_seq=self.max_seq,
            tp=self.hooks, layer_use=plan.layer_weights,
            kv_heads=plan.kv_heads, cache=self.init_cache(),
            cache_write=write)

    def _seq_block(self, t: torch.Tensor, blk: SeqBlock) -> torch.Tensor:
        """This rank's sequence block (rows, size, KV, D) of a layer's keys
        or values ``t`` (rows, S, KV_r, D): the rank's KV heads, or every
        KV head where they are not split over ``model``.  Positions past S
        are zeros.  With the KV heads split, the model ranks' heads are
        exchanged by one all-to-all into each rank's sequence slice."""
        plan = self.plan
        B, S = t.shape[0], t.shape[1]
        tp = plan.sizes["model"] if plan.kv_tp else 1
        base = blk.start - (plan.model_rank * blk.size if tp > 1 else 0)
        seg = t.new_zeros((B, tp * blk.size) + tuple(t.shape[2:]))
        n = max(0, min(S, base + tp * blk.size) - base)
        if n:
            seg[:, :n] = t[:, base:base + n]
        if tp == 1:
            return seg
        parts = seg.view((B, tp, blk.size) + tuple(t.shape[2:])).movedim(1, 0)
        got = coll.all_to_all(parts.contiguous(), plan.model_group)
        return got.movedim(0, 2).reshape((B, blk.size, tp * t.shape[2])
                                         + tuple(t.shape[3:]))

    # -- decode ------------------------------------------------------------
    def _embed_token(self, e, tokens, pos):
        if "wpe" in e:
            row = torch.clamp(pos, max=e["wpe"].shape[0] - 1)
            return cm.cast(e["wte"][tokens[:, None]] + e["wpe"][row[:, None]],
                           self.model.compute_dtype)
        return cm.embed_tokens(e, tokens[:, None], self.model.compute_dtype)

    def _partial(self, q, kc, vc, valid, blk: SeqBlock) -> torch.Tensor:
        """Attention of q (rows, 1, H, D) over this rank's block (rows,
        size, KV, D), ``valid`` (rows, size): float32 (max, sum, out)
        partials combined over the axes holding the sequence; returns
        (rows, 1, H, D) in q's dtype."""
        B, _, H, D = q.shape
        KV = kc.shape[2]
        qr = q.reshape(B, KV, H // KV, D) * query_scale(D, q.dtype)
        s = torch.einsum("bkgd,bskd->bkgs", qr.float(), kc.float())
        s = torch.where(valid[:, None, None, :], s, cm.NEG_INF)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1)
        o = torch.einsum("bkgs,bskd->bkgd", p, vc.float())
        if blk.group is not None:
            m_all = coll.all_gather(m[None], blk.group)
            l_all = coll.all_gather(l[None], blk.group)
            o_all = coll.all_gather(o[None], blk.group)
            w = torch.exp(m_all - m_all.amax(0))
            l = (w * l_all).sum(0)
            o = (w[..., None] * o_all).sum(0)
        return (o / l[..., None]).reshape(B, 1, H, D).to(q.dtype)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor,
                    pos: torch.Tensor):
        """One decode step of this rank's rows: tokens, pos (rows,) int32;
        returns (logits (rows, Vp), cache) with the rank's cache blocks
        written in place, the dense-cache branch of the reference's
        ``DecoderLM.decode_step`` as its sharded jit computes it."""
        cfg, model, plan = self.cfg, self.model, self.plan
        whole = plan.whole(params)
        B = tokens.shape[0]
        x = self._embed_token(whole["embed"], tokens, pos)
        rows = torch.arange(B, device=tokens.device)
        for layer, lp in enumerate(unstack_layers(params["layers"],
                                                  cfg.n_layers)):
            g, i = divmod(layer, model.group)
            ring = model._layer_window(i) > 0
            w = plan.layer_weights(lp)
            a = w["attn"]
            h = cm.apply_norm(w["norm_attn"], x, cfg.norm)
            q = cm.project_heads(h, a["wq"])
            k = cm.project_heads(h, a["wk"])
            v = cm.project_heads(h, a["wv"])
            if plan.attn_tp:
                q = coll.all_gather(q, plan.model_group, 2)
            if plan.kv_tp:
                k = coll.all_gather(k, plan.model_group, 2)
                v = coll.all_gather(v, plan.model_group, 2)
            q, k = self._rope(q, pos[:, None]), self._rope(k, pos[:, None])
            if model.group == 1:
                kname, vname = "k", "v"
            else:
                kname, vname = ("k_local", "v_local") if ring \
                    else ("k_global", "v_global")
            blk = self.seq[kname]
            kc, vc = (cache[kname][g, i], cache[vname][g, i]) if ring \
                else (cache[kname][g], cache[vname][g])
            slots = blk.start + torch.arange(blk.size, device=pos.device)
            if ring:
                W = self._ring()
                at = pos % W
                abs_pos = pos[:, None] - torch.remainder(
                    pos[:, None] - slots[None], W)
                valid = (abs_pos >= 0) & (abs_pos <= pos[:, None])
            else:
                at = pos
                valid = slots[None] <= pos[:, None]
            local = at - blk.start
            own = ((local >= 0) & (local < blk.size))[:, None, None]
            at = torch.clamp(local, 0, blk.size - 1)
            kc[rows, at] = torch.where(own, k[:, 0], kc[rows, at])
            vc[rows, at] = torch.where(own, v[:, 0], vc[rows, at])
            o = self._partial(q, kc, vc, valid, blk)
            H, D, d = a["wo"].shape
            if plan.attn_tp:
                h0 = plan.model_rank * H
                o = o[:, :, h0:h0 + H]
            out = o.reshape(B, 1, H * D) @ cm.cast(a["wo"], x.dtype).reshape(
                H * D, d)
            x = x + (plan.g(out) if plan.attn_tp else out)
            x, _ = model._mlp_block(w, x, drop=False, tp=self.hooks)
        return model.logits(whole, x)[:, 0], cache


def gather_rows(x: torch.Tensor, serve: ShardedServe) -> torch.Tensor:
    """The global rows of a per-rank output (logits, tokens) on every
    rank: the data ranks' blocks all-gathered (a collective over the data
    axes; every rank calls it)."""
    if not serve.split:
        return x
    return coll.all_gather(x, serve.plan.data_group, 0)


__all__ = ["ShardedServe", "SeqBlock", "gather_rows"]
