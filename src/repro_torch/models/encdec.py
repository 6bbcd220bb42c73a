"""Encoder-decoder transformer of the port (seamless-m4t backbone): the JAX
package's ``models/encdec.py:EncDecLM``.

The speech/text frontend is a stub, as there: the encoder takes
precomputed frame embeddings ``frames`` (B, F, d).  Encoder: a learned
position table ``enc_pos`` of ``encoder_frontend_len`` rows added to the
frames, then bidirectional self-attention layers and a final norm.
Decoder: learned token positions (``embed/wpe``), then layers of causal
self-attention, cross-attention to the encoder's output (the memory:
queries from the decoder, keys and values projected from the memory, no
causal mask) and an MLP.  Parameters keep the reference's stacked layout
(``enc_layers`` and ``dec_layers``, each leaf with a leading layer dim);
training (``loss``) runs each layer under ``torch.utils.checkpoint`` when
``remat`` is on, as the reference wraps each layer in ``jax.checkpoint``.

Serving keeps a self-attention cache ("k", "v": (L, B, max_seq, KV, D),
paged by the engine when it pages) beside the cross-attention K/V of the
memory ("cross_k", "cross_v": (L, B, F, KV, D), dense slot rows at every
cache type and never quantized, as in the reference).  Prefill encodes the
frames once and fills both; a decode step attends over its own cache
through the paged decode kernel (pages) or the plain dense attention, and
over the dense cross K/V through the plain ``common.decode_attention`` at
``pos = F - 1`` (the reference has no Pallas kernel there).  Frames take no
cache position: text position t sits at t.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import common as cm
from .common import Params
from .transformer import (AbstractParams, LeafSpec, _meta, init_params,
                          init_scale, resolve_device, unstack_layers)


def _init_scale(name: str, per_layer_shape) -> float:
    """``transformer.init_scale``, and 0.02 for the encoder's position
    table, as the reference draws it."""
    return 0.02 if name == "enc_pos" else init_scale(name, per_layer_shape)


class EncDecLM(AbstractParams):
    """Encoder-decoder LM over stacked (n_layers, ...) parameters."""

    #: the prefill inputs beside the tokens that a request may carry
    #: (``serve.engine``): the stubbed frontend's frame embeddings
    prefill_extras = ("frames",)

    def __init__(self, cfg: ModelConfig, block_k: int = 1024,
                 device="cuda"):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM runs the encdec family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        self.block_k = block_k
        self.device = resolve_device(device)
        self.head_dim = cfg.resolved_head_dim
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)

    # -- params ----------------------------------------------------------
    def param_leaves(self) -> Params:
        """Every parameter leaf (shape and logical axes), in the
        reference's tree layout."""
        cfg = self.cfg
        d = cfg.d_model

        def layer(cross: bool):
            p = {"norm_attn": cm.norm_leaves(d, cfg.norm),
                 "attn": cm.attention_leaves(d, cfg.n_heads, cfg.n_kv_heads,
                                             self.head_dim),
                 "norm_mlp": cm.norm_leaves(d, cfg.norm),
                 "mlp": cm.mlp_leaves(d, cfg.d_ff, cfg.activation)}
            if cross:
                p["norm_cross"] = cm.norm_leaves(d, cfg.norm)
                p["cross"] = cm.attention_leaves(d, cfg.n_heads,
                                                 cfg.n_kv_heads,
                                                 self.head_dim)
            return p
        return {"embed": cm.embedding_leaves(cfg.vocab_size, d,
                                             cfg.tie_embeddings,
                                             max_seq=cfg.max_train_seq,
                                             learned_pos=True),
                "enc_pos": cm.leaf((cfg.encoder_frontend_len, d),
                                   (None, "embed")),
                "enc_final_norm": cm.norm_leaves(d, cfg.norm),
                "final_norm": cm.norm_leaves(d, cfg.norm),
                "enc_layers": cm.stack_leaves(layer(False),
                                              cfg.n_encoder_layers),
                "dec_layers": cm.stack_leaves(layer(True), cfg.n_layers)}

    def leaf_dtype(self, name: str, dtype=None) -> torch.dtype:
        """Norm scales and biases stay float32; every other matrix and
        embedding holds ``dtype``, by default the compute dtype (serving;
        training passes ``self.param_dtype``)."""
        return torch.float32 if name in ("scale", "bias") \
            else (dtype or self.compute_dtype)

    def init(self, generator: Optional[torch.Generator] = None,
             dtype=None) -> Params:
        """Random weights on the model's device, drawn from ``generator``
        (seed 0 when None): fan-in-scaled normals for the matrices, 0.02
        for the embeddings, the head and ``enc_pos``, ones / zeros for norm
        scales / biases.  Matrices hold ``dtype`` (see
        :meth:`leaf_dtype`)."""
        return init_params(self.param_shapes(),
                           lambda name: self.leaf_dtype(name, dtype),
                           self.device, generator, zeros=("bias",),
                           ones=("scale",), scale=_init_scale,
                           stacked_keys=("enc_layers", "dec_layers"))

    # -- encoder ---------------------------------------------------------
    def _enc_body(self, lp: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = cm.apply_norm(lp["norm_attn"], x, cfg.norm)
        x = x + cm.attention_block(lp["attn"], h, cfg_theta=0.0,
                                   positional="learned", causal=False,
                                   block_k=self.block_k)
        h = cm.apply_norm(lp["norm_mlp"], x, cfg.norm)
        return x + cm.apply_mlp(lp["mlp"], h, cfg.activation)

    def encode(self, params: Params, frames,
               remat: bool = True) -> torch.Tensor:
        """frames: (B, F, d) stubbed frontend embeddings -> the memory
        (B, F, d) in the compute dtype.  The frames and ``enc_pos[:F]``
        are each cast to the compute dtype, then summed, as the reference
        sums them."""
        cfg = self.cfg
        frames = torch.as_tensor(frames, device=self.device)
        dt = self.compute_dtype
        x = cm.cast(frames, dt) \
            + cm.cast(params["enc_pos"][:frames.shape[1]], dt)
        for lp in unstack_layers(params["enc_layers"],
                                 cfg.n_encoder_layers):
            x = checkpoint(self._enc_body, lp, x, use_reentrant=False) \
                if remat else self._enc_body(lp, x)
        return cm.apply_norm(params["enc_final_norm"], x, cfg.norm)

    # -- decoder ---------------------------------------------------------
    def _dec_body(self, lp: Params, x: torch.Tensor, memory: torch.Tensor,
                  q_offset: int = 0) -> torch.Tensor:
        cfg = self.cfg
        h = cm.apply_norm(lp["norm_attn"], x, cfg.norm)
        x = x + cm.attention_block(lp["attn"], h, cfg_theta=0.0,
                                   positional="learned", causal=True,
                                   q_offset=q_offset, block_k=self.block_k)
        h = cm.apply_norm(lp["norm_cross"], x, cfg.norm)
        x = x + cm.attention_block(lp["cross"], h, cfg_theta=0.0,
                                   positional="learned", causal=False,
                                   kv_x=memory, block_k=self.block_k)
        h = cm.apply_norm(lp["norm_mlp"], x, cfg.norm)
        return x + cm.apply_mlp(lp["mlp"], h, cfg.activation)

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = cm.apply_norm(params["final_norm"], x, self.cfg.norm)
        return cm.unembed(params["embed"], x)

    # -- training --------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             rng=None, remat: bool = True):
        """Mean next-token cross entropy with z-loss 1e-4 over the
        decoder's tokens (``batch``: "frames", "tokens", "targets",
        optional "mask"), as the reference's ``EncDecLM.loss``: the frames
        are encoded once, and every decoder layer attends to that memory.
        ``rng`` is accepted for its signature (the model draws nothing).
        Returns (loss, {"loss", "ce_loss"})."""
        cfg = self.cfg
        memory = self.encode(params, batch["frames"], remat=remat)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = cm.embed_tokens(params["embed"], tokens, self.compute_dtype)
        for lp in unstack_layers(params["dec_layers"], cfg.n_layers):
            x = checkpoint(self._dec_body, lp, x, memory,
                           use_reentrant=False) \
                if remat else self._dec_body(lp, x, memory)
        targets = torch.as_tensor(batch["targets"], device=self.device)
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        loss = cm.softmax_cross_entropy(self.logits(params, x), targets,
                                        mask, z_loss=1e-4)
        return loss, {"loss": loss, "ce_loss": loss}

    # -- serving ---------------------------------------------------------
    def _cache_struct(self, B: int, max_seq: int,
                      check: bool = True) -> Dict[str, LeafSpec]:
        """The cache leaves; ``check`` raises for positions past the
        learned table (``input_specs`` describes any shape, as the
        reference's does)."""
        cfg = self.cfg
        if check:
            cm.check_positions(max_seq, cfg.max_train_seq)
        L, KV, D = cfg.n_layers, cfg.n_kv_heads, self.head_dim
        dt = self.compute_dtype
        return {"k": LeafSpec((L, B, max_seq, KV, D), dt),
                "v": LeafSpec((L, B, max_seq, KV, D), dt),
                "cross_k": LeafSpec((L, B, cfg.encoder_frontend_len, KV, D),
                                    dt),
                "cross_v": LeafSpec((L, B, cfg.encoder_frontend_len, KV, D),
                                    dt)}

    def _extra_inputs(self, B: int):
        cfg = self.cfg
        return {"frames": _meta((B, cfg.encoder_frontend_len, cfg.d_model),
                                self.compute_dtype)}, 0

    def init_cache(self, B: int, max_seq: int) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self._cache_struct(B, max_seq).items()}

    def prefill(self, params: Params, tokens: torch.Tensor, frames=None,
                max_seq: Optional[int] = None, remat: bool = True,
                prompt_lens: Optional[torch.Tensor] = None):
        """Encode ``frames`` (B, F, d), run the decoder over the prompts
        (B, S), build the caches: returns (last-position logits (B, Vp),
        cache {"k", "v": positions 0 .. S - 1 of max_seq; "cross_k",
        "cross_v": the memory's K/V of every layer}).

        ``prompt_lens`` (B,) enables batched bucketed prefill: rows are
        right-padded to S, self-attention masks keys past each row's
        length and the logits are taken at its last valid position
        (cross-attention is per query, so a padded position only changes
        its own unused output).  ``remat`` is accepted for the reference's
        signature; inference keeps no activations."""
        if frames is None:
            raise ValueError(f"{self.cfg.name}: prefill needs the encoder's "
                             f"frames (B, F, d_model)")
        cfg = self.cfg
        memory = self.encode(params, frames, remat=False)
        tokens = torch.as_tensor(tokens, device=self.device)
        x = cm.embed_tokens(params["embed"], tokens, self.compute_dtype)
        B, S = x.shape[0], x.shape[1]
        cache = self.init_cache(B, max_seq or S)
        lens = None if prompt_lens is None else torch.as_tensor(
            prompt_lens, device=self.device).to(torch.int32)
        layers = unstack_layers(params["dec_layers"], cfg.n_layers)
        for layer, lp in enumerate(layers):
            h = cm.apply_norm(lp["norm_attn"], x, cfg.norm)
            h, (k, v) = cm.attention_block(
                lp["attn"], h, cfg_theta=0.0, positional="learned",
                causal=True, block_k=self.block_k, return_kv=True,
                kv_valid_len=lens)
            x = x + h
            h = cm.apply_norm(lp["norm_cross"], x, cfg.norm)
            h, (ck, cv) = cm.attention_block(
                lp["cross"], h, cfg_theta=0.0, positional="learned",
                causal=False, kv_x=memory, block_k=self.block_k,
                return_kv=True)
            x = x + h
            h = cm.apply_norm(lp["norm_mlp"], x, cfg.norm)
            x = x + cm.apply_mlp(lp["mlp"], h, cfg.activation)
            cache["k"][layer, :, :S] = k
            cache["v"][layer, :, :S] = v
            cache["cross_k"][layer] = ck
            cache["cross_v"][layer] = cv
        last = x[:, -1:] if lens is None \
            else cm.gather_last_positions(x, lens)
        return self.logits(params, last)[:, 0], cache

    def cache_slot_axes(self):
        """Batch-axis index per cache leaf (for slot-wise admission)."""
        return {"k": 1, "v": 1, "cross_k": 1, "cross_v": 1}

    def paged_cache_keys(self):
        """Self-attention K/V grows with max_seq and is paged; the cross
        K/V is a fixed F-row block a slot and stays dense."""
        return ["k", "v"]

    def cache_max_seq(self, cache) -> int:
        return cache["k"].shape[2]

    def decode_step(self, params: Params, cache, tokens: torch.Tensor,
                    pos: torch.Tensor, block_tables=None):
        """One decode step; tokens, pos: (B,) int32.  Returns (logits
        (B, Vp), cache) with the cache written in place.

        With ``block_tables`` (B, nb) the "k"/"v" leaves are page pools
        (L, P, page, KV, D) shared by all slots, with "k_scale"/"v_scale"
        (L, P, KV) siblings when quantized; self-attention reads go
        through the paged decode kernel.  Cross-attention reads the dense
        "cross_k"/"cross_v" rows of every slot at ``pos = F - 1`` (every
        frame visible) through ``common.decode_attention``."""
        cfg = self.cfg
        B = tokens.shape[0]
        e = params["embed"]
        # the reference's order: both rows added in the parameter dtype,
        # then cast; a frozen slot parked one past a cache of the table's
        # length reads the last row (the reference reads NaN; its logits
        # are never used)
        row = torch.clamp(pos, max=e["wpe"].shape[0] - 1)
        x = cm.cast(e["wte"][tokens[:, None]] + e["wpe"][row[:, None]],
                    self.compute_dtype)
        paged = block_tables is not None
        arange = torch.arange(B, device=tokens.device)
        cross_pos = torch.full((B,), cache["cross_k"].shape[2] - 1,
                               dtype=torch.int32, device=tokens.device)
        layers = unstack_layers(params["dec_layers"], cfg.n_layers)
        for layer, lp in enumerate(layers):
            kc, vc = cache["k"][layer], cache["v"][layer]
            ks = cache["k_scale"][layer] if "k_scale" in cache else None
            vs = cache["v_scale"][layer] if "v_scale" in cache else None
            h = cm.apply_norm(lp["norm_attn"], x, cfg.norm)
            q = cm.project_heads(h, lp["attn"]["wq"])
            k = cm.project_heads(h, lp["attn"]["wk"])
            v = cm.project_heads(h, lp["attn"]["wv"])
            if paged:
                if ks is not None:
                    cm.paged_cache_write_quant(kc, ks, k[:, 0],
                                               block_tables, pos)
                    cm.paged_cache_write_quant(vc, vs, v[:, 0],
                                               block_tables, pos)
                else:
                    cm.paged_cache_write(kc, k[:, 0], block_tables, pos)
                    cm.paged_cache_write(vc, v[:, 0], block_tables, pos)
                o = cm.paged_decode_attention(q, kc, vc, block_tables,
                                              pos=pos, k_scales=ks,
                                              v_scales=vs)
            else:
                cm.dense_cache_write(kc, k[:, 0], pos, arange)
                cm.dense_cache_write(vc, v[:, 0], pos, arange)
                o = cm.decode_attention(q, kc, vc, pos=pos)
            x = x + self._out(o, lp["attn"]["wo"])
            h = cm.apply_norm(lp["norm_cross"], x, cfg.norm)
            q = cm.project_heads(h, lp["cross"]["wq"])
            o = cm.decode_attention(q, cache["cross_k"][layer],
                                    cache["cross_v"][layer], pos=cross_pos)
            x = x + self._out(o, lp["cross"]["wo"])
            h = cm.apply_norm(lp["norm_mlp"], x, cfg.norm)
            x = x + cm.apply_mlp(lp["mlp"], h, cfg.activation)
        return self.logits(params, x)[:, 0], cache

    @staticmethod
    def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
        """One decode token's attention output (B, 1, H, D) through the
        output projection ``wo`` (H, D, d)."""
        H, D, d = wo.shape
        return o.reshape(o.shape[0], 1, H * D) \
            @ cm.cast(wo, o.dtype).reshape(H * D, d)
