"""Decoder-only transformer LM of the port: the dense path of the JAX
package's ``models/transformer.py:DecoderLM``.

Parameters keep the reference's stacked layout: every layer leaf has a
leading ``n_layers`` dim, and the layer loop runs over views of it.  The
serving entry points (``prefill``, ``decode_step``) match the reference's
signatures and cache layouts; the caches are written in place.  Training
(``forward_hidden``, ``loss``) runs each layer under
``torch.utils.checkpoint`` when ``remat`` is on, as the reference wraps
each layer group in ``jax.checkpoint``.  Serving holds its matrices in the
compute dtype, training in ``cfg.param_dtype`` (``init(dtype=)``).  MoE
layers, local/global ring caches and the VLM prefix raise
``NotImplementedError`` until their slices land (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import common as cm
from .common import Params


class LeafSpec(NamedTuple):
    """Shape and dtype of one cache leaf (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_scale(name: str, per_layer_shape) -> float:
    """Standard deviation of a random leaf: 0.02 for embeddings, else
    1/sqrt(fan-in), the fan-in being the per-layer leaf's first dim (as the
    reference draws them)."""
    return 0.02 if name in ("wte", "head") else per_layer_shape[0] ** -0.5


def init_params(shapes, leaf_dtype, device, generator=None, *,
                zeros=(), ones=(), scale=init_scale) -> Params:
    """Random weights for a tree of (stacked) leaf shapes, drawn in tree
    order from ``generator`` (seed 0 when None): leaves named in ``zeros``
    or ``ones`` are filled; every other leaf is a normal scaled by
    ``scale(name, per_layer_shape)``, drawn in float32 and stored in
    ``leaf_dtype(name)``.  Leaves under ``layers`` carry a leading
    ``n_layers`` dim, which the fan-in skips."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

    def build(tree, stacked: bool):
        out = {}
        for name, val in tree.items():
            if isinstance(val, dict):
                out[name] = build(val, stacked or name == "layers")
                continue
            shape, dt = val, leaf_dtype(name)
            if name in zeros or name in ones:
                fill = torch.zeros if name in zeros else torch.ones
                out[name] = fill(shape, dtype=dt, device=device)
                continue
            w = torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32)
            out[name] = w.mul_(scale(name, shape[1:] if stacked else shape)
                               ).to(dt)
        return out

    return build(shapes, False)


def resolve_device(device) -> torch.device:
    """The entry points' device; a CUDA device must exist (no silent
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available; pass device='cpu' to run the "
                           f"plain PyTorch path")
    return dev


def unstack_layers(tree, n: int):
    """The ``n`` layers of a stacked parameter tree, as views from one
    ``unbind`` per leaf (one call per leaf, not one per layer and leaf;
    and in training the gradients of all layers come back to a leaf in one
    stack, not as ``n`` full-size zero-padded copies)."""
    if isinstance(tree, dict):
        per = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(torch.unbind(tree, 0))


class DecoderLM:
    """Dense decoder LM over stacked (n_layers, ...) parameters."""

    def __init__(self, cfg: ModelConfig, block_k: int = 1024,
                 device="cuda"):
        if cfg.family != "dense" or cfg.is_moe:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} (MoE / VLM) is not "
                f"ported yet (ROADMAP.md queue 1, the rest of the decoder "
                f"family)")
        if cfg.attn_window:
            raise NotImplementedError(
                f"{cfg.name}: local/global ring caches are not ported yet "
                f"(ROADMAP.md queue 1, the rest of the decoder family)")
        if cfg.positional == "learned":
            raise NotImplementedError(
                f"{cfg.name}: learned positions are not ported yet "
                f"(ROADMAP.md queue 1, the rest of the decoder family)")
        self.cfg = cfg
        self.block_k = block_k
        self.device = resolve_device(device)
        self.head_dim = cfg.resolved_head_dim
        self.group = 1
        self.n_groups = cfg.n_layers
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)

    # -- params ----------------------------------------------------------
    def param_shapes(self) -> Params:
        """Shape of every parameter leaf, in the reference's tree layout."""
        cfg = self.cfg
        L, d, H, KV, D = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, self.head_dim)
        embed = {"wte": (cfg.vocab_size, d)}
        if not cfg.tie_embeddings:
            embed["head"] = (d, cfg.vocab_size)

        def norm():
            p = {"scale": (L, d)}
            if cfg.norm == "layer":
                p["bias"] = (L, d)
            return p

        mlp = {"w_up": (L, d, cfg.d_ff), "w_down": (L, cfg.d_ff, d)}
        if cfg.activation == "swiglu":
            mlp["w_gate"] = (L, d, cfg.d_ff)
        final = {"scale": (d,)}
        if cfg.norm == "layer":
            final["bias"] = (d,)
        return {"embed": embed, "final_norm": final,
                "layers": {"norm_attn": norm(),
                           "attn": {"wq": (L, d, H, D), "wk": (L, d, KV, D),
                                    "wv": (L, d, KV, D), "wo": (L, H, D, d)},
                           "norm_mlp": norm(), "mlp": mlp}}

    def leaf_dtype(self, name: str, dtype=None) -> torch.dtype:
        """Norm scales and biases stay float32 (read in f32 by the norm);
        every matrix and embedding holds ``dtype``, by default the compute
        dtype (serving; training passes ``self.param_dtype``)."""
        return torch.float32 if name in ("scale", "bias") \
            else (dtype or self.compute_dtype)

    def init(self, generator: Optional[torch.Generator] = None,
             dtype=None) -> Params:
        """Random weights on the model's device, drawn from ``generator``
        (seed 0 when None): fan-in-scaled normals for the matrices (fan-in
        = the per-layer leaf's first dim, as the reference draws them),
        0.02 for embeddings, ones / zeros for norm scales / biases.
        Matrices hold ``dtype`` (see :meth:`leaf_dtype`)."""
        return init_params(self.param_shapes(),
                           lambda name: self.leaf_dtype(name, dtype),
                           self.device, generator,
                           zeros=("bias",), ones=("scale",))

    # -- forward ---------------------------------------------------------
    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = cm.apply_norm(params["final_norm"], x, self.cfg.norm)
        return cm.unembed(params["embed"], x)

    def _mlp_block(self, lp: Params, x: torch.Tensor) -> torch.Tensor:
        h = cm.apply_norm(lp["norm_mlp"], x, self.cfg.norm)
        return x + cm.apply_mlp(lp["mlp"], h, self.cfg.activation)

    def _layer_fwd(self, lp: Params, x: torch.Tensor,
                   q_offset: int) -> torch.Tensor:
        cfg = self.cfg
        h = cm.apply_norm(lp["norm_attn"], x, cfg.norm)
        h = cm.attention_block(
            lp["attn"], h, cfg_theta=cfg.rope_theta,
            positional=cfg.positional, causal=True,
            softcap=cfg.attn_logit_softcap, q_offset=q_offset,
            block_k=self.block_k)
        return self._mlp_block(lp, x + h)

    def forward_hidden(self, params: Params, x: torch.Tensor,
                       q_offset: int = 0, remat: bool = True
                       ) -> Tuple[torch.Tensor, Dict]:
        """Run the layer stack on embedded input x (B, S, d).  With
        ``remat`` each layer runs under ``torch.utils.checkpoint``: only
        its input is kept, and the backward recomputes the rest.  Returns
        (x, aux) with aux empty (a dense model has no MoE losses)."""
        for lp in unstack_layers(params["layers"], self.cfg.n_layers):
            if remat:
                x = checkpoint(self._layer_fwd, lp, x, q_offset,
                               use_reentrant=False)
            else:
                x = self._layer_fwd(lp, x, q_offset)
        return x, {}

    # -- training --------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             rng=None, remat: bool = True):
        """Mean next-token cross entropy with z-loss 1e-4 over ``batch``
        ("tokens", "targets", optional "mask"), as the reference's
        ``DecoderLM.loss``.  ``rng`` is accepted for its signature (a dense
        model draws nothing).  Returns (loss, metrics)."""
        if batch.get("patch_embeds") is not None:
            raise NotImplementedError("the VLM patch prefix is not ported "
                                      "yet (ROADMAP.md queue 1)")
        return cm.lm_loss(self, params, batch, remat)

    # -- serving ---------------------------------------------------------
    def _cache_struct(self, B: int, max_seq: int) -> Dict[str, LeafSpec]:
        cfg = self.cfg
        shape = (self.n_groups, B, max_seq, cfg.n_kv_heads, self.head_dim)
        return {"k": LeafSpec(shape, self.compute_dtype),
                "v": LeafSpec(shape, self.compute_dtype)}

    def init_cache(self, B: int, max_seq: int) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self._cache_struct(B, max_seq).items()}

    def prefill(self, params: Params, tokens: torch.Tensor,
                patch_embeds=None, max_seq: Optional[int] = None,
                remat: bool = True,
                prompt_lens: Optional[torch.Tensor] = None):
        """Process prompts (B, S); return (last-position logits (B, Vp),
        cache {"k", "v"} of (L, B, max_seq, KV, D)).

        ``prompt_lens`` (B,) enables batched bucketed prefill: rows are
        right-padded to S, attention masks padded keys, and the logits are
        taken at each row's last valid position.  ``remat`` is accepted for
        the reference's signature; inference keeps no activations.
        """
        if patch_embeds is not None:
            raise NotImplementedError("the VLM patch prefix is not ported "
                                      "yet (ROADMAP.md queue 1)")
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        x = cm.embed_tokens(params["embed"], tokens, self.compute_dtype)
        B, S = tokens.shape
        max_seq = max_seq or S
        cache = self.init_cache(B, max_seq)
        valid_len = None if prompt_lens is None else \
            torch.as_tensor(prompt_lens, device=self.device).to(torch.int32)
        layers = unstack_layers(params["layers"], cfg.n_layers)
        for layer, lp in enumerate(layers):
            h = cm.apply_norm(lp["norm_attn"], x, cfg.norm)
            h, (k, v) = cm.attention_block(
                lp["attn"], h, cfg_theta=cfg.rope_theta,
                positional=cfg.positional, causal=True,
                softcap=cfg.attn_logit_softcap, block_k=self.block_k,
                return_kv=True, kv_valid_len=valid_len)
            x = self._mlp_block(lp, x + h)
            cache["k"][layer, :, :S] = k
            cache["v"][layer, :, :S] = v
        last = x[:, -1:] if valid_len is None \
            else cm.gather_last_positions(x, valid_len)
        return self.logits(params, last)[:, 0], cache

    def cache_slot_axes(self):
        """Batch-axis index per cache leaf (for slot-wise admission)."""
        return {"k": 1, "v": 1}

    def cache_max_seq(self, cache) -> int:
        return cache["k"].shape[2]

    def paged_cache_keys(self):
        """Cache leaves holding unbounded (max_seq) KV, eligible for the
        block-table page pool."""
        return ["k", "v"]

    def decode_step(self, params: Params, cache, tokens: torch.Tensor,
                    pos: torch.Tensor, block_tables=None):
        """One decode step; tokens, pos: (B,) int32.  Returns (logits
        (B, Vp), cache) with the cache written in place.

        With ``block_tables`` (B, nb) the "k"/"v" leaves are page pools
        (L, P, page, KV, D) shared by all slots, with "k_scale"/"v_scale"
        (L, P, KV) siblings when quantized; reads go through the paged
        decode kernel and writes scatter one token into each slot's page.
        """
        cfg = self.cfg
        B = tokens.shape[0]
        x = cm.embed_tokens(params["embed"], tokens[:, None],
                            self.compute_dtype)
        paged = block_tables is not None
        arange = torch.arange(B, device=tokens.device)
        layers = unstack_layers(params["layers"], cfg.n_layers)
        for layer, lp in enumerate(layers):
            kc, vc = cache["k"][layer], cache["v"][layer]
            ks = cache["k_scale"][layer] if "k_scale" in cache else None
            vs = cache["v_scale"][layer] if "v_scale" in cache else None
            h = cm.apply_norm(lp["norm_attn"], x, cfg.norm)
            q = cm.project_heads(h, lp["attn"]["wq"])
            k = cm.project_heads(h, lp["attn"]["wk"])
            v = cm.project_heads(h, lp["attn"]["wv"])
            if cfg.positional == "rope":
                q = cm.apply_rope(q, pos[:, None], cfg.rope_theta)
                k = cm.apply_rope(k, pos[:, None], cfg.rope_theta)
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
            H, D, d = lp["attn"]["wo"].shape
            x = x + o.reshape(B, 1, H * D) \
                @ cm.cast(lp["attn"]["wo"], x.dtype).reshape(H * D, d)
            x = self._mlp_block(lp, x)
        return self.logits(params, x)[:, 0], cache
