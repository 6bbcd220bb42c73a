"""Zamba2-style hybrid LM of the port: the serving path of the JAX package's
``models/hybrid.py:HybridLM``.

A Mamba2 backbone of ``n_layers`` blocks and one *shared* attention + MLP
block, whose weights are reused at every application: it runs before each
group of ``attn_every`` Mamba2 blocks and once more before the leftover
tail, on ``concat(hidden, embedding)`` (2 d_model wide), projecting back to
d_model (arXiv:2411.15242).  Each application keeps its own KV cache.  The
Mamba2 blocks are ``models/ssm.py``'s; the shared block is built from
``models/common.py``'s attention and MLP, so the four serving kernels run
at this model's shapes: RMSNorm at d_model and at 2 d_model (the shared
norms; the blocks' gate norms at d_inner), the SSD scan, and prefill and
paged decode attention at head_dim 2 d_model / n_heads.

Parameters keep the reference's tree: ``embed``, ``shared``,
``final_norm`` and ``layers`` stacked over ``n_layers``.  The cache holds
the recurrent state as dense slot rows (``ssm``, ``conv``) and the shared
block's KV per application (``k``, ``v``), which a paged engine pools.
Every cache leaf is written in place, so a captured decode step keeps its
addresses.  Training (``forward_hidden``, ``loss``) follows the reference:
each group (the shared block and its ``attn_every`` Mamba2 blocks) runs
under ``torch.utils.checkpoint`` when ``remat`` is on, the tail outside
it, on f32 masters (``init(dtype=)``); the shared block's attention goes
through the differentiable flash attention (forward with its log-sum-exp,
then the flash backward) and the Mamba2 blocks' scans through the SSD
scan's autograd ``Function``.  A sharded step or prefill
(``parallel.train_step`` / ``serve_step``) passes its tensor-parallel
hooks (``tp``: f and g around the shared block's attention and MLP, the
Mamba2 blocks' ``MambaShard``) and takes the place of a group
(``layer_fwd``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import common as cm
from .common import Params
from .ssm import (init_mamba_params, mamba_block, mamba_decode_step,
                  mamba_layer, mamba_leaf_dtype, mamba_param_leaves)
from .transformer import (AbstractParams, LeafSpec, _same, _tp_hooks,
                          _write_leading, resolve_device, unstack_layers)


class HybridLM(AbstractParams):
    """Mamba2 blocks and one shared attention block over stacked params."""

    def __init__(self, cfg: ModelConfig, block_k: int = 1024,
                 device="cuda"):
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: HybridLM takes the hybrid family, "
                             f"got {cfg.family!r}")
        self.cfg = cfg
        self.block_k = block_k
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)
        s = cfg.ssm
        self.d_inner = s.expand * cfg.d_model
        self.nh = self.d_inner // s.head_dim
        self.conv_ch = self.d_inner + 2 * s.n_groups * s.state_dim
        per = cfg.attn_every
        self.n_groups = cfg.n_layers // per          # full groups
        self.tail = cfg.n_layers % per               # leftover mamba layers
        # the shared block runs before each group and once before the tail
        self.n_attn = self.n_groups + (1 if self.tail else 0)
        self.attn_d = 2 * cfg.d_model
        if self.attn_d % cfg.n_heads:
            raise ValueError(f"{cfg.name}: 2 d_model ({self.attn_d}) is not a "
                             f"multiple of n_heads ({cfg.n_heads})")
        self.attn_head_dim = self.attn_d // cfg.n_heads

    def _groups(self):
        """(application, its Mamba2 layers) in the reference's order: each
        group of ``attn_every`` layers, then the tail."""
        per, L = self.cfg.attn_every, self.cfg.n_layers
        return [(a, range(a * per, min((a + 1) * per, L)))
                for a in range(self.n_attn)]

    # -- params ----------------------------------------------------------
    def param_leaves(self) -> Params:
        """Every parameter leaf (shape and logical axes), in the
        reference's tree layout."""
        cfg = self.cfg
        d, A = cfg.d_model, self.attn_d
        shared = {"norm_attn": cm.norm_leaves(A, "rms"),
                  "attn": cm.attention_leaves(A, cfg.n_heads, cfg.n_kv_heads,
                                              self.attn_head_dim, d_out=d),
                  "norm_mlp": cm.norm_leaves(A, "rms"),
                  "mlp": {"w_up": cm.leaf((A, cfg.d_ff), ("embed", "mlp")),
                          "w_down": cm.leaf((cfg.d_ff, d),
                                            ("mlp", "embed"))}}
        layer = {"norm": cm.norm_leaves(d, cfg.norm),
                 "mamba": mamba_param_leaves(cfg)}
        return {"embed": cm.embedding_leaves(cfg.vocab_size, d,
                                             cfg.tie_embeddings),
                "shared": shared,
                "final_norm": cm.norm_leaves(d, cfg.norm),
                "layers": cm.stack_leaves(layer, cfg.n_layers)}

    def leaf_dtype(self, name: str, dtype=None) -> torch.dtype:
        """The Mamba2 family's leaf dtypes (``ssm.mamba_leaf_dtype``): norm
        scales, ``dt_bias``, ``A_log`` and ``D`` in float32, every other
        leaf in ``dtype``, by default the compute dtype."""
        return mamba_leaf_dtype(name, dtype or self.compute_dtype)

    def init(self, generator: Optional[torch.Generator] = None,
             dtype=None, put=None) -> Params:
        """Random weights on the model's device, drawn from ``generator``
        (seed 0 when None) as ``ssm.init_mamba_params`` draws them (the
        shared block's matrices fan-in-scaled normals), in their leaf
        dtypes (:meth:`leaf_dtype`): ``dtype`` defaults to the compute
        dtype (serving); training passes ``self.param_dtype``; ``put``
        takes each leaf as it is drawn."""
        return init_mamba_params(self.param_shapes(),
                                 dtype or self.compute_dtype, self.device,
                                 generator, put=put)

    # -- the shared block ------------------------------------------------
    def _shared_fwd(self, sp: Params, h: torch.Tensor, emb: torch.Tensor,
                    kv_valid_len: Optional[torch.Tensor] = None,
                    tp: Optional[Dict] = None,
                    kv_heads: Optional[Tuple[int, int]] = None):
        """The shared block over a whole sequence; returns (h, (k, v)).
        ``tp``'s ``"attn"`` and ``"mlp"`` hooks (f, g) wrap the blocks a
        rank computes its heads or ``d_ff`` columns of; ``kv_heads`` as
        ``common.attention_block`` takes it."""
        cfg = self.cfg
        f, g = _tp_hooks(tp, "attn")
        un = f(cm.apply_norm(sp["norm_attn"], torch.cat([h, emb], dim=-1),
                             "rms"))
        attn_out, kv = cm.attention_block(
            sp["attn"], un, cfg_theta=cfg.rope_theta, positional="rope",
            causal=True, block_k=self.block_k, return_kv=True,
            kv_valid_len=kv_valid_len, kv_heads=kv_heads)
        h = h + g(attn_out)
        f, g = _tp_hooks(tp, "mlp")
        un = f(cm.apply_norm(sp["norm_mlp"], torch.cat([h, emb], dim=-1),
                             "rms"))
        return h + g(cm.apply_mlp(sp["mlp"], un, "gelu")), kv

    def _shared_decode(self, sp: Params, h: torch.Tensor, emb: torch.Tensor,
                       kc, vc, pos, rows, block_tables=None, ks=None,
                       vs=None) -> torch.Tensor:
        """The shared block for one token per slot, its KV written into
        this application's cache (dense rows, or pages through
        ``block_tables``, quantized with ``ks``/``vs``) in place."""
        cfg = self.cfg
        un = cm.apply_norm(sp["norm_attn"], torch.cat([h, emb], dim=-1),
                           "rms")
        q = cm.project_heads(un, sp["attn"]["wq"])
        k = cm.project_heads(un, sp["attn"]["wk"])
        v = cm.project_heads(un, sp["attn"]["wv"])
        q = cm.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = cm.apply_rope(k, pos[:, None], cfg.rope_theta)
        if block_tables is not None:
            if ks is not None:
                cm.paged_cache_write_quant(kc, ks, k[:, 0], block_tables, pos)
                cm.paged_cache_write_quant(vc, vs, v[:, 0], block_tables, pos)
            else:
                cm.paged_cache_write(kc, k[:, 0], block_tables, pos)
                cm.paged_cache_write(vc, v[:, 0], block_tables, pos)
            o = cm.paged_decode_attention(q, kc, vc, block_tables, pos=pos,
                                          k_scales=ks, v_scales=vs)
        else:
            cm.dense_cache_write(kc, k[:, 0], pos, rows)
            cm.dense_cache_write(vc, v[:, 0], pos, rows)
            o = cm.decode_attention(q, kc, vc, pos=pos)
        H, D, d = sp["attn"]["wo"].shape
        h = h + o.reshape(h.shape[0], 1, H * D) \
            @ cm.cast(sp["attn"]["wo"], h.dtype).reshape(H * D, d)
        un = cm.apply_norm(sp["norm_mlp"], torch.cat([h, emb], dim=-1),
                           "rms")
        return h + cm.apply_mlp(sp["mlp"], un, "gelu")

    # -- forward ---------------------------------------------------------
    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = cm.apply_norm(params["final_norm"], x, self.cfg.norm)
        return cm.unembed(params["embed"], x)

    def _group_fwd(self, shared: Params, layers, x: torch.Tensor,
                   emb: torch.Tensor, tp: Optional[Dict] = None
                   ) -> torch.Tensor:
        """One application of the shared block, then its Mamba2 layers
        (a rank's part with ``tp``)."""
        x = self._shared_fwd(shared, x, emb, tp=tp)[0]
        for lp in layers:
            x = mamba_layer(lp, x, self.cfg, tp=(tp or {}).get("mamba"))
        return x

    def forward_hidden(self, params: Params, x: torch.Tensor,
                       remat: bool = True,
                       layer_fwd: Optional[Callable] = None):
        """Run the stack on embedded input x (B, S, d), which is also the
        ``emb`` every application of the shared block reads.  With
        ``remat`` each full group runs under ``torch.utils.checkpoint``
        (only its input is kept, the backward recomputes the rest), as the
        reference wraps its scanned group in ``jax.checkpoint``; the tail
        runs outside it, as there.  ``layer_fwd(shared, layers, x, emb)``
        takes the place of :meth:`_group_fwd` (a sharded step's, which
        makes the shared block and the layers whole inside the
        checkpoint).  Returns (x, {})."""
        layer_fwd = layer_fwd or self._group_fwd
        layers = unstack_layers(params["layers"], self.cfg.n_layers)
        emb, shared = x, params["shared"]
        for a, group in self._groups():
            lps = [layers[i] for i in group]
            if remat and a < self.n_groups:
                x = checkpoint(layer_fwd, shared, lps, x, emb,
                               use_reentrant=False)
            else:
                x = layer_fwd(shared, lps, x, emb)
        return x, {}

    def loss(self, params: Params, batch, rng=None, remat: bool = True):
        """Mean next-token cross entropy with z-loss 1e-4 over ``batch``
        ("tokens", "targets", optional "mask"), as the reference's
        ``HybridLM.loss``.  ``rng`` is accepted for its signature.  Returns
        (loss, metrics)."""
        return cm.lm_loss(self, params, batch, remat)

    # -- serving ---------------------------------------------------------
    def _cache_struct(self, B: int, max_seq: int,
                      check: bool = True) -> Dict[str, LeafSpec]:
        cfg = self.cfg
        s = cfg.ssm
        kv = (self.n_attn, B, max_seq, cfg.n_kv_heads, self.attn_head_dim)
        return {"ssm": LeafSpec((cfg.n_layers, B, self.nh, s.state_dim,
                                 s.head_dim), torch.float32),
                "conv": LeafSpec((cfg.n_layers, B, s.conv_width - 1,
                                  self.conv_ch), self.compute_dtype),
                "k": LeafSpec(kv, self.compute_dtype),
                "v": LeafSpec(kv, self.compute_dtype)}

    def init_cache(self, B: int, max_seq: int) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self._cache_struct(B, max_seq).items()}

    def prefill(self, params: Params, tokens: torch.Tensor,
                max_seq: Optional[int] = None, remat: bool = True,
                prompt_lens: Optional[torch.Tensor] = None, *,
                tp: Optional[Dict] = None,
                layer_use: Optional[Callable] = None,
                kv_heads: Optional[Tuple[int, int]] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_write: Optional[Callable] = None):
        """Process prompts (B, S); return (last-position logits (B, Vp),
        cache {"ssm" (L, B, nh, N, P) f32, "conv" (L, B, W-1, C), "k"/"v"
        (n_attn, B, max_seq, KV, D) zero past S}), as the reference pads
        them.

        ``prompt_lens`` (B,) enables batched bucketed prefill: rows are
        right-padded to S, attention masks padded keys, the Mamba2 blocks
        hold their state at each row's length, and the logits are taken at
        each row's last valid position.  ``remat`` is accepted for the
        reference's signature; inference keeps no activations.

        The keywords run one rank's part of a sharded prefill
        (``parallel.serve_step``), as ``DecoderLM.prefill`` takes them:
        ``tp`` the hooks (see :meth:`_group_fwd`), ``layer_use`` makes a
        Mamba2 layer's blocks whole (``params["shared"]`` comes whole),
        ``kv_heads`` the KV heads the rank's query heads read, ``cache``
        the blocks to fill, ``cache_write(dst, t, name)`` a leaf's
        writer."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        x = cm.embed_tokens(params["embed"], tokens, self.compute_dtype)
        B, S = tokens.shape
        lens = None if prompt_lens is None else \
            torch.as_tensor(prompt_lens, device=self.device).to(torch.int32)
        if cache is None:
            struct = self._cache_struct(B, max_seq or S)
            cache = {k: (torch.zeros if k in ("k", "v") else torch.empty)(
                spec.shape, dtype=spec.dtype, device=self.device)
                for k, spec in struct.items()}
        write = cache_write or _write_leading
        use = layer_use or _same
        shard = (tp or {}).get("mamba")
        layers = unstack_layers(params["layers"], cfg.n_layers)
        emb, shared = x, params["shared"]
        for a, group in self._groups():
            x, (k, v) = self._shared_fwd(shared, x, emb, kv_valid_len=lens,
                                         tp=tp, kv_heads=kv_heads)
            write(cache["k"][a], k, "k")
            write(cache["v"][a], v, "v")
            for layer in group:
                lp = use(layers[layer])
                h = cm.apply_norm(lp["norm"], x, cfg.norm)
                out, (hf, tail) = mamba_block(lp["mamba"], h, cfg,
                                              return_state=True,
                                              seq_lens=lens, tp=shard)
                x = x + out
                write(cache["ssm"][layer], hf, "ssm")
                write(cache["conv"][layer], tail, "conv")
        last = x[:, -1:] if lens is None \
            else cm.gather_last_positions(x, lens)
        return self.logits(params, last)[:, 0], cache

    def cache_slot_axes(self):
        """Batch-axis index per cache leaf (for slot-wise admission)."""
        return {"ssm": 1, "conv": 1, "k": 1, "v": 1}

    def paged_cache_keys(self):
        """The shared block's KV grows with max_seq and is paged; the
        recurrent state is constant-size per slot and stays dense."""
        return ["k", "v"]

    def cache_max_seq(self, cache) -> int:
        return cache["k"].shape[2]

    def decode_step(self, params: Params, cache, tokens: torch.Tensor,
                    pos: torch.Tensor, block_tables=None):
        """One decode step; tokens, pos: (B,) int32.  Returns (logits
        (B, Vp), cache) with every leaf written in place.

        With ``block_tables`` (B, nb) the "k"/"v" leaves are page pools
        (n_attn, P, page, KV, D) shared by all slots, with "k_scale" /
        "v_scale" (n_attn, P, KV) siblings when quantized; reads go through
        the paged decode kernel.  The recurrent state is read and written
        as dense slot rows either way."""
        cfg = self.cfg
        x = cm.embed_tokens(params["embed"], tokens[:, None],
                            self.compute_dtype)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        quant = "k_scale" in cache
        layers = unstack_layers(params["layers"], cfg.n_layers)
        emb, shared = x, params["shared"]
        for a, group in self._groups():
            x = self._shared_decode(
                shared, x, emb, cache["k"][a], cache["v"][a], pos, rows,
                block_tables=block_tables,
                ks=cache["k_scale"][a] if quant else None,
                vs=cache["v_scale"][a] if quant else None)
            for layer in group:
                lp = layers[layer]
                ssm, conv = cache["ssm"][layer], cache["conv"][layer]
                h = cm.apply_norm(lp["norm"], x, cfg.norm)
                out, (ssm_new, conv_new) = mamba_decode_step(
                    lp["mamba"], h, (ssm, conv), cfg)
                x = x + out
                ssm.copy_(ssm_new)
                conv.copy_(conv_new)
        return self.logits(params, x)[:, 0], cache
