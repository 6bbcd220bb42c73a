"""One rank's sharded prefill and decode step of every family: the
decoders (dense, VLM, MoE), the SSM, the hybrid and the encoder-decoder.

What the reference gets from GSPMD when it jits a model's ``prefill`` and
the dense-cache branch of its ``decode_step`` on parameters laid out by
``param_specs`` and caches laid out by ``cache_specs``, written out over
``torch.distributed`` with no autograd.  The weights are used as the
sharded train step uses them (:class:`~repro_torch.parallel.train_step.
ShardedStep`: FSDP gathers on use, heads, ``d_ff`` and ``inner`` computed
locally over ``model`` between f and g, the MoE layer's experts over
``model`` with every routed pair kept, as serving keeps them).  The
batch's rows are split over the data axes where ``batch_specs`` splits
them, and stay whole on every data rank where they do not.

* **Attention caches** (self-attention K/V, a ring's slots, the
  encoder-decoder's cross K/V over the frames) hold, on each rank, its
  block by ``cache_specs``: its rows, every KV head, and a slice of the
  sequence (``max_seq``, a local layer's ring of ``W`` slots, or the
  ``F`` frames) over ``model``, or over the data and model axes where the
  batch does not split (one long sequence).  That is context parallelism:
  the layout that lets the ``decode_32k`` and ``long_500k`` cells fit.  A
  sequence below ``_SEQ_MIN`` (1024) makes ``cache_specs`` split head_dim
  instead, which this step refuses.
* **The Mamba2 caches.**  ``cache_specs`` gives the SSM state
  ``(L, B, nh, N, P)`` no sequence dim, so it splits P (head_dim) over
  ``model``; the conv window ``(L, B, W - 1, C)`` is split as one block
  of its channels (over ``model``, or the data and model axes).  Both
  stay in that layout, so a rank's resident bytes are the reference's
  shards; the small tensors move instead.
* **Prefill** is the model's own (``prefill`` with the rank's hooks:
  weights made whole on use, f and g, the cache write), on the rank's
  heads.  The cache keeps all KV heads for a slice of the sequence, so
  an all-to-all over ``model`` turns heads into sequence
  (:func:`~repro_torch.parallel.collectives.all_to_all`); where the KV
  heads do not split over ``model`` (fewer KV heads than ranks), every
  rank projects all of them and keeps its slice.  A Mamba2 layer's final
  state comes out head-split, and one all-to-all turns heads into P; its
  conv tail's columns are gathered over ``model`` into the cache's
  channel order and the rank keeps its block.
* **Decode.**  Attention gathers the new token's q, k and v over
  ``model`` (every head); the rank that owns the token's position writes
  its K/V; each rank attends over its slice of the sequence for every
  head and yields float32 ``(max, sum, out)`` partials, combined over the
  axes that hold the sequence; the rank keeps its heads of the output for
  the row-parallel ``wo``.  A local layer's ring slot s holds the
  position ``pos - (pos - s) % W`` (``DecoderLM._ring_attention``'s
  validity).  Cross-attention is the same over the frames, every frame
  valid and nothing written.  A Mamba2 layer is the model's own
  ``mamba_decode_step`` on the rank's heads, with hooks that keep the
  caches in their layout: the conv window is gathered over the window's
  axes and the rank convolves its own heads' and B/C columns; the SSD
  update runs in the state's P-split layout, which is elementwise in P:
  the token's x moves from heads to P by one all-to-all, and y back.
  The partial attention and the SSD update are plain PyTorch, as the
  reference's dense-cache decode is (no kernel computes them there).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..models import common as cm
from ..models.ssm import mamba_decode_step
from ..models.transformer import _tp_hooks, unstack_layers
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
    """One rank's sharded ``prefill`` and ``decode_step`` for a model of
    any family on a (data, model) ``DeviceMesh`` (``"pod"`` may lead),
    serving ``batch`` sequences in a cache of ``max_seq`` positions (the
    cache layout is ``cache_specs`` of that cache).  Every rank of the
    mesh builds it, in the same order (it makes the process groups it
    needs).  The parameters are the rank's blocks by ``param_specs``;
    :meth:`local_rows` cuts a global input."""

    def __init__(self, model, mesh, batch: int, max_seq: int):
        self.plan = plan = ShardedStep(model, mesh)
        self.model, self.cfg = model, model.cfg
        self.batch, self.max_seq = batch, max_seq
        # serving keeps every routed pair and reads no aux term
        self.hooks = dict(plan.hooks)
        if "moe" in self.hooks:
            self.hooks["moe"] = plan.moe_shard(over_data=False)
        self.mamba = self.hooks.get("mamba")
        self.bc_split = self.mamba is not None and \
            plan.uses["layers"]["mamba"]["w_bc"].model_local
        self.split = bool(batch_specs({"tokens": (batch,)}, plan.sizes)
                          ["tokens"])
        self.rows = batch // plan.dp if self.split else batch
        struct = model._cache_struct(batch, max_seq)
        self.cache_specs = cache_specs(struct, plan.sizes)
        coords = mesh_coords(mesh)
        self.seq: Dict[str, SeqBlock] = {}
        for name, leaf in struct.items():
            spec = self.cache_specs[name]
            split = {d for d, e in enumerate(spec) if entry_names(e)}
            cut = local_slices(leaf.shape, spec, plan.sizes, coords)
            if name == "ssm":       # (L, B, nh, N, P): rows, P over model
                ok = split <= {1, 4} and self.mamba is not None and \
                    4 in split and entry_names(spec[4]) == ("model",)
            elif name == "conv":    # (L, B, W - 1, C): rows, channels
                ok = split <= {1, 3} and (3 in split) == (
                    self.mamba is not None)
                names = entry_names(spec[3]) if 3 in split else ()
                self.conv_cut, self.conv_group = cut[3], plan.group(names)
            else:                   # attention: rows, the sequence
                dim = 3 if len(leaf.shape) == 6 else 2
                ok = split <= {dim - 1, dim}
                names = entry_names(spec[dim]) if dim < len(spec) else ()
                self.seq[name] = SeqBlock(cut[dim].start,
                                          cut[dim].stop - cut[dim].start,
                                          plan.group(names))
            if not ok:
                raise NotImplementedError(
                    f"{self.cfg.name}: cache_specs splits {name} "
                    f"{leaf.shape} as {spec}; the sharded decode takes "
                    f"attention caches split over rows and sequence "
                    f"(max_seq of 1024 or more), the SSM state over rows "
                    f"and P with the heads over model, the conv window "
                    f"over rows and channels")
        if self.mamba is not None:
            # the decode keeps the state and the conv window in the cache's
            # layout (:func:`~repro_torch.models.ssm.mamba_decode_step`)
            self.mamba = self.mamba._replace(
                window=self._window, to_state=self._to_state,
                from_state=self._from_state)

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
    def prefill(self, params, tokens: torch.Tensor, extra=None):
        """Prefill this rank's rows ``tokens`` (rows, S), behind a VLM's
        patch rows or over an encoder-decoder's frames ``extra`` (rows,
        P or F, d) when given: returns (their last-position logits (rows,
        Vp), this rank's cache blocks), the reference's ``prefill`` as its
        sharded jit computes it: the model's own prefill on the layers'
        weights made whole, with the tensor-parallel hooks, and each
        layer's cache leaves written into the rank's blocks
        (:meth:`_write`)."""
        plan, fam = self.plan, self.cfg.family
        tokens = torch.as_tensor(tokens, device=self.model.device)
        B, S = tokens.shape[0], tokens.shape[1] + (
            extra.shape[1] if extra is not None and fam != "encdec" else 0)
        if B != self.rows or (fam != "ssm" and S > self.max_seq):
            raise ValueError(f"prefill of {(B, S)} on a rank of {self.rows} "
                             f"rows and max_seq {self.max_seq}")
        kw = dict(max_seq=self.max_seq, tp=self.hooks,
                  cache=self.init_cache(), cache_write=self._write)
        if fam != "ssm":
            kw["kv_heads"] = plan.kv_heads
        if fam in ("ssm", "hybrid"):
            return self.model.prefill(plan.whole(params, shared=True),
                                      tokens, layer_use=plan.layer_weights,
                                      **kw)
        if fam == "encdec":
            return self.model.prefill(
                plan.whole(params), tokens, extra, enc_fwd=plan.enc_layer,
                layer_use=lambda lp: plan.layer_weights(lp,
                                                        key="dec_layers"),
                **kw)
        return self.model.prefill(plan.whole(params), tokens, extra,
                                  layer_use=plan.layer_weights, **kw)

    def _write(self, dst: torch.Tensor, t: torch.Tensor, name: str) -> None:
        """A layer's cache leaf ``name`` computed on this rank (keys or
        values of its KV heads, a final state of its heads, a conv tail of
        its columns) into its block ``dst``."""
        if name == "ssm":
            dst.copy_(self._state_block(t))
        elif name == "conv":
            cx = self.mamba.nh * self.cfg.ssm.head_dim
            dst.copy_(self._conv_channels(t[..., :cx], t[..., cx:])
                      [..., self.conv_cut])
        else:
            dst.copy_(self._seq_block(t, self.seq[name]))

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

    def _state_block(self, t: torch.Tensor) -> torch.Tensor:
        """A Mamba2 layer's final state of the rank's heads (rows, nh_r, N,
        P) as its cache block (rows, nh, N, P / tp): one all-to-all over
        ``model`` turns heads into P."""
        tp = self.plan.sizes["model"]
        B, hl, N, P = t.shape
        parts = t.reshape(B, hl, N, tp, P // tp).movedim(3, 0)
        got = coll.all_to_all(parts.contiguous(), self.plan.model_group)
        return got.movedim(0, 1).reshape(B, tp * hl, N, P // tp)

    def _to_state(self, x: torch.Tensor) -> torch.Tensor:
        """The token's x of the rank's heads (rows, nh_r, P) in the state's
        layout (rows, nh, P / tp): one all-to-all over ``model``."""
        tp = self.plan.sizes["model"]
        B, hl, P = x.shape
        parts = x.reshape(B, hl, tp, P // tp).movedim(2, 0)
        got = coll.all_to_all(parts.contiguous(), self.plan.model_group)
        return got.movedim(0, 1).reshape(B, tp * hl, P // tp)

    def _from_state(self, y: torch.Tensor) -> torch.Tensor:
        """:meth:`_to_state` reversed: y (rows, nh, P / tp) back to the
        rank's heads (rows, nh_r, P)."""
        tp = self.plan.sizes["model"]
        B, nh, Pl = y.shape
        parts = y.reshape(B, tp, nh // tp, Pl).movedim(1, 0)
        got = coll.all_to_all(parts.contiguous(), self.plan.model_group)
        return got.permute(1, 2, 0, 3).reshape(B, nh // tp, tp * Pl)

    def _conv_channels(self, xs: torch.Tensor,
                       bc: torch.Tensor) -> torch.Tensor:
        """A Mamba2 conv input of the rank's x columns ``xs`` and B/C
        columns ``bc`` (every B/C column where ``w_bc`` is whole) as every
        channel in the cache's order, [x | B C], gathered over ``model``
        by one all-gather."""
        cx = xs.shape[-1]
        mine = torch.cat([xs, bc], -1) if self.bc_split else xs
        got = coll.all_gather(mine[None], self.plan.model_group).unbind(0)
        xs_all = torch.cat([t[..., :cx] for t in got], -1)
        bc_all = torch.cat([t[..., cx:] for t in got], -1) \
            if self.bc_split else bc
        return torch.cat([xs_all, bc_all], -1)

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

    def _attn_out(self, o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
        """The rank's heads of every head's output o (rows, 1, H, D)
        through the row-parallel ``wo`` (its heads' rows), summed by g."""
        plan = self.plan
        H, D, d = wo.shape
        if plan.attn_tp:
            h0 = plan.model_rank * H
            o = o[:, :, h0:h0 + H]
        out = o.reshape(o.shape[0], 1, H * D) @ cm.cast(wo, o.dtype).reshape(
            H * D, d)
        return plan.g(out) if plan.attn_tp else out

    def _query(self, a, h) -> torch.Tensor:
        q = cm.project_heads(h, a["wq"])
        return coll.all_gather(q, self.plan.model_group, 2) \
            if self.plan.attn_tp else q

    def _self_attend(self, a, h, kc, vc, blk: SeqBlock, pos, rows,
                     ring: bool = False) -> torch.Tensor:
        """A self-attention block's output for one token a row (h normed,
        (rows, 1, d)) over the rank's sequence block of ``kc`` / ``vc``,
        the token's K/V written by the rank that owns its position (a
        ring's slot ``pos % W``)."""
        plan = self.plan
        q = self._query(a, h)
        k = cm.project_heads(h, a["wk"])
        v = cm.project_heads(h, a["wv"])
        if plan.kv_tp:
            k = coll.all_gather(k, plan.model_group, 2)
            v = coll.all_gather(v, plan.model_group, 2)
        q, k = self._rope(q, pos[:, None]), self._rope(k, pos[:, None])
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
        return self._attn_out(self._partial(q, kc, vc, valid, blk), a["wo"])

    def _cross_attend(self, a, h, kc, vc, blk: SeqBlock) -> torch.Tensor:
        """A cross-attention block's output for one token a row over the
        rank's block of the frames' K/V, every frame valid."""
        valid = torch.ones(kc.shape[:2], dtype=torch.bool, device=kc.device)
        return self._attn_out(self._partial(self._query(a, h), kc, vc, valid,
                                            blk), a["wo"])

    def _mlp(self, p, h, activation: str) -> torch.Tensor:
        f, g = _tp_hooks(self.hooks, "mlp")
        return g(cm.apply_mlp(p, f(h), activation))

    def _window(self, conv: torch.Tensor, xs: torch.Tensor,
                bc: torch.Tensor):
        """The decode shard's ``window``: a Mamba2 layer's conv window
        block ``conv`` (rows, W - 1, its channels) gathered over the
        window's axes, with the token's channels (:meth:`_conv_channels`
        of its x columns ``xs`` and B/C columns ``bc``) behind it; returns
        the past window's x and B/C columns of the rank and its new
        block."""
        sh = self.mamba
        win = coll.all_gather(conv, self.conv_group, conv.dim() - 1)
        full = torch.cat([win, self._conv_channels(xs, bc)[:, None]], 1)
        cx, cb = xs.shape[-1], bc.shape[-1]
        x0 = sh.h0 * self.cfg.ssm.head_dim
        b0 = sh.width + (self.plan.model_rank * cb if self.bc_split else 0)
        return (full[:, :-1, x0:x0 + cx], full[:, :-1, b0:b0 + cb],
                full[:, 1:, self.conv_cut])

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor,
                    pos: torch.Tensor):
        """One decode step of this rank's rows: tokens, pos (rows,) int32;
        returns (logits (rows, Vp), cache) with the rank's cache blocks
        written in place, the dense-cache branch of the reference's
        ``decode_step`` as its sharded jit computes it."""
        cfg, model, plan = self.cfg, self.model, self.plan
        fam = cfg.family
        whole = plan.whole(params, shared=True)
        B = tokens.shape[0]
        x = self._embed_token(whole["embed"], tokens, pos)
        rows = torch.arange(B, device=tokens.device)
        if fam in ("ssm", "hybrid"):
            layers = unstack_layers(params["layers"], cfg.n_layers)
            groups = model._groups() if fam == "hybrid" \
                else [(None, range(cfg.n_layers))]
            emb = x
            for a, group in groups:
                if a is not None:
                    sp = whole["shared"]
                    un = cm.apply_norm(sp["norm_attn"],
                                       torch.cat([x, emb], -1), "rms")
                    x = x + self._self_attend(
                        sp["attn"], un, cache["k"][a], cache["v"][a],
                        self.seq["k"], pos, rows)
                    un = cm.apply_norm(sp["norm_mlp"],
                                       torch.cat([x, emb], -1), "rms")
                    x = x + self._mlp(sp["mlp"], un, "gelu")
                for layer in group:
                    w = plan.layer_weights(layers[layer])
                    h = cm.apply_norm(w["norm"], x, cfg.norm)
                    ssm, conv = cache["ssm"][layer], cache["conv"][layer]
                    out, (ssm_new, conv_new) = mamba_decode_step(
                        w["mamba"], h, (ssm, conv), cfg, tp=self.mamba)
                    x = x + out
                    ssm.copy_(ssm_new)
                    conv.copy_(conv_new)
            return model.logits(whole, x)[:, 0], cache
        if fam == "encdec":
            for layer, lp in enumerate(unstack_layers(params["dec_layers"],
                                                      cfg.n_layers)):
                w = plan.layer_weights(lp, key="dec_layers")
                h = cm.apply_norm(w["norm_attn"], x, cfg.norm)
                x = x + self._self_attend(w["attn"], h, cache["k"][layer],
                                          cache["v"][layer], self.seq["k"],
                                          pos, rows)
                h = cm.apply_norm(w["norm_cross"], x, cfg.norm)
                x = x + self._cross_attend(
                    w["cross"], h, cache["cross_k"][layer],
                    cache["cross_v"][layer], self.seq["cross_k"])
                h = cm.apply_norm(w["norm_mlp"], x, cfg.norm)
                x = x + self._mlp(w["mlp"], h, cfg.activation)
            return model.logits(whole, x)[:, 0], cache
        for layer, lp in enumerate(unstack_layers(params["layers"],
                                                  cfg.n_layers)):
            g, i = divmod(layer, model.group)
            ring = model._layer_window(i) > 0
            w = plan.layer_weights(lp)
            h = cm.apply_norm(w["norm_attn"], x, cfg.norm)
            if model.group == 1:
                kname, vname = "k", "v"
            else:
                kname, vname = ("k_local", "v_local") if ring \
                    else ("k_global", "v_global")
            kc, vc = (cache[kname][g, i], cache[vname][g, i]) if ring \
                else (cache[kname][g], cache[vname][g])
            x = x + self._self_attend(w["attn"], h, kc, vc, self.seq[kname],
                                      pos, rows, ring)
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
