"""Decoder-only transformer LM of the port: the dense and MoE paths of the
JAX package's ``models/transformer.py:DecoderLM``.

Parameters keep the reference's stacked layout: every layer leaf has a
leading ``n_layers`` dim, and the layer loop runs over views of it.  The
serving entry points (``prefill``, ``decode_step``) match the reference's
signatures and cache layouts; the caches are written in place.  Training
(``forward_hidden``, ``loss``) runs each layer under
``torch.utils.checkpoint`` when ``remat`` is on, as the reference wraps
each layer group in ``jax.checkpoint``.  Serving holds its matrices in the
compute dtype, training in ``cfg.param_dtype`` (``init(dtype=)``).
Positions are rotary (``positional="rope"``) or a learned table
``embed/wpe`` of ``max_train_seq`` rows added to the token embeddings
(``"learned"``, gpt3-xl); a position past that table raises, at the cache
(``init_cache``, and so at engine construction) and at ``prefill`` /
``loss`` (``common.embed_tokens``).  An MoE config (``cfg.is_moe``) takes
``common.apply_moe`` for every layer's MLP: capacity-bounded in training,
every routed pair kept in prefill and decode, its aux terms averaged over
the layers as the reference's scan averages them.  A VLM config
(``family="vlm"``) takes precomputed patch embeddings (``patch_embeds``,
(B, P, d)) in ``prefill`` and ``loss``: cast to the compute dtype and
placed before the token embeddings, so text position t sits at P + t;
the loss is taken over the text positions only.  A config with a local
attention window and a global layer every ``global_attn_every`` layers
(llama4-scout-17b-a16e) groups its layers as the reference does (the flat
stack read in groups of ``global_attn_every``; the last layer of a group
is global): a local layer attends over its window and keeps a ring cache
of ``W = min(attn_window, max_seq)`` positions, dense beside the page
pool (slot ``p % W`` holds position p; decode is the reference's plain
ring attention), a global layer keeps the full "k_global"/"v_global"
cache, paged when the engine pages.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.flash_attention.prefill import query_scale
from . import common as cm
from .common import Params


class LeafSpec(NamedTuple):
    """Shape and dtype of one cache leaf (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_scale(name: str, per_layer_shape) -> float:
    """Standard deviation of a random leaf: 0.02 for embeddings (tokens,
    learned positions, the head) and the MoE router, else 1/sqrt(fan-in),
    the fan-in being the per-layer leaf's first dim (as the reference draws
    them: E for the stacked experts' leaves)."""
    return 0.02 if name in ("wte", "wpe", "head", "router") \
        else per_layer_shape[0] ** -0.5


#: a leaf of more values than this is drawn in parts, so that its float32
#: draw never sits whole beside the model's weights: a stacked leaf a layer
#: at a time (yi-34b's w_gate: 8.8e9 values, 35 GB in float32, computed),
#: an unstacked one in blocks of whole rows of at most this many values
#: (nemotron-4-340b's wte and head: 4.7e9 values each); the largest leaf of
#: every smaller registered config (zamba2-7b's w_z, 2.1e9) is one draw
DRAW_WHOLE_MAX = 1 << 32


def init_params(shapes, leaf_dtype, device, generator=None, *,
                zeros=(), ones=(), scale=init_scale,
                stacked_keys=("layers",), put=None) -> Params:
    """Random weights for a tree of (stacked) leaf shapes, drawn in tree
    order from ``generator`` (seed 0 when None): leaves named in ``zeros``
    or ``ones`` are filled; every other leaf is a normal scaled by
    ``scale(name, per_layer_shape)``, drawn in float32 and stored in
    ``leaf_dtype(name)``, in one draw; past ``DRAW_WHOLE_MAX`` values a
    stacked leaf takes one draw a layer and an unstacked one a draw per
    block of ``DRAW_WHOLE_MAX // row`` whole rows (the last block the
    rest), in order from the first row.  Leaves under a subtree named in
    ``stacked_keys`` (``layers``; an encoder-decoder's ``enc_layers`` and
    ``dec_layers``) carry a leading layer dim, which the fan-in skips.
    ``put(path, leaf)``, when given, takes each leaf as soon as it is made
    (``path`` as ``tree.flatten`` names it) and the tree keeps what it
    returns: a sharded state keeps a rank's block, so that no more than
    one whole leaf is on the device at a time."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    keep = put or (lambda path, leaf: leaf)

    def make(name, shape, stacked: bool) -> torch.Tensor:
        dt = leaf_dtype(name)
        if name in zeros or name in ones:
            fill = torch.zeros if name in zeros else torch.ones
            return fill(shape, dtype=dt, device=device)
        std = scale(name, shape[1:] if stacked else shape)
        if math.prod(shape) > DRAW_WHOLE_MAX:
            w = torch.empty(shape, dtype=dt, device=device)
            parts = w if stacked else w.split(
                max(1, DRAW_WHOLE_MAX // math.prod(shape[1:])))
            for part in parts:
                part.copy_(torch.randn(
                    part.shape, generator=generator, device=device,
                    dtype=torch.float32).mul_(std))
            return w
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(std).to(dt)

    def build(tree, stacked: bool, prefix: str):
        out = {}
        for name, val in tree.items():
            path = f"{prefix}/{name}" if prefix else name
            if isinstance(val, dict):
                out[name] = build(val, stacked or name in stacked_keys, path)
            else:
                out[name] = keep(path, make(name, val, stacked))
        return out

    return build(shapes, False, "")


def meta_params(shapes, leaf_dtype) -> Params:
    """The tree of leaf ``shapes`` as ``device="meta"`` tensors in
    ``leaf_dtype(name)``: shapes and dtypes only, nothing allocated or
    drawn (the reference's ``ParamBuilder.ABSTRACT``)."""
    return {name: meta_params(val, leaf_dtype) if isinstance(val, dict)
            else torch.empty(val, dtype=leaf_dtype(name), device="meta")
            for name, val in shapes.items()}


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class AbstractParams:
    """What the model classes derive from their ``param_leaves()``:
    ``param_shapes()``, ``param_axes()`` (the reference's logical axis
    names, which ``parallel.sharding`` maps onto a mesh) and
    ``abstract_params(dtype=None)``, the tree of shapes as meta tensors in
    the dtypes ``init(dtype=)`` gives (``leaf_dtype``); from their
    ``_cache_struct`` and ``_extra_inputs``, ``input_specs(shape)``."""

    def _extra_inputs(self, B: int) -> Tuple[Dict[str, torch.Tensor], int]:
        """A family's inputs beside the tokens in training and prefill, as
        meta tensors, and how many of the shape's positions they take."""
        return {}, 0

    def input_specs(self, shape) -> Dict[str, object]:
        """Meta-tensor stand-ins (shapes and dtypes only) for every input
        of the entry point a ``ShapeConfig`` names, the reference's
        ``input_specs``: for ``kind`` "train" int32 ``tokens`` and
        ``targets`` (B, S), for "prefill" the ``tokens``, each beside the
        family's extra inputs (a VLM's patch rows, which take P of the S
        positions; an encoder-decoder's frames); for "decode" int32
        ``tokens`` and ``pos`` (B,) and the ``cache`` of
        ``_cache_struct(B, S)``."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": _meta((B,)), "pos": _meta((B,)),
                    "cache": {k: _meta(s.shape, s.dtype) for k, s in
                              self._cache_struct(B, S,
                                                 check=False).items()}}
        extra, taken = self._extra_inputs(B)
        specs = {"tokens": _meta((B, S - taken))}
        if shape.kind == "train":
            specs["targets"] = _meta((B, S - taken))
        specs.update(extra)
        return specs

    def param_shapes(self) -> Params:
        """Shape of every parameter leaf, in the reference's tree layout."""
        return cm.leaf_shapes(self.param_leaves())

    def param_axes(self) -> Params:
        """Logical axis names of every parameter leaf's dims, in the
        reference's tree layout (its ``param_axes()``)."""
        return cm.leaf_axes(self.param_leaves())

    def abstract_params(self, dtype=None) -> Params:
        return meta_params(self.param_shapes(),
                           lambda name: self.leaf_dtype(name, dtype))


def resolve_device(device) -> torch.device:
    """The entry points' device; a CUDA device must exist (no silent
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available; pass device='cpu' to run the "
                           f"plain PyTorch path")
    return dev


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _tp_hooks(tp: Optional[Dict], block: str) -> Tuple[Callable, Callable]:
    """The (f, g) hooks of ``block`` in ``tp``, identity where none."""
    return (tp or {}).get(block, (_same, _same))


def _write_leading(dst: torch.Tensor, t: torch.Tensor, name: str) -> None:
    """A layer's keys or values ``t`` (B, S, KV, D) into the leading S
    positions of its cache block ``dst`` (B, max_seq, KV, D)."""
    dst[:, :t.shape[1]] = t


def unstack_layers(tree, n: int):
    """The ``n`` layers of a stacked parameter tree, as views from one
    ``unbind`` per leaf (one call per leaf, not one per layer and leaf;
    and in training the gradients of all layers come back to a leaf in one
    stack, not as ``n`` full-size zero-padded copies)."""
    if isinstance(tree, dict):
        per = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(torch.unbind(tree, 0))


class DecoderLM(AbstractParams):
    """Dense or MoE decoder LM over stacked (n_layers, ...) parameters."""

    #: the prefill inputs beside the tokens that a request may carry
    #: (``serve.engine``): a VLM's patch embeddings
    prefill_extras = ("patch_embeds",)

    def __init__(self, cfg: ModelConfig, block_k: int = 1024,
                 device="cuda"):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.name}: DecoderLM runs the dense, MoE and "
                             f"VLM families, not {cfg.family!r}")
        self.cfg = cfg
        self.block_k = block_k
        self.device = resolve_device(device)
        self.head_dim = cfg.resolved_head_dim
        if cfg.attn_window and cfg.global_attn_every:
            self.group = cfg.global_attn_every
            if cfg.n_layers % self.group:
                raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                                 f"whole groups of {self.group}")
        else:
            self.group = 1
        self.n_groups = cfg.n_layers // self.group
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)

    # -- layer flags -----------------------------------------------------
    def _layer_window(self, idx_in_group: int) -> int:
        """Attention window of a layer (0 = full/global): the last layer of
        each group is global."""
        cfg = self.cfg
        if not cfg.attn_window:
            return 0
        return 0 if idx_in_group == self.group - 1 else cfg.attn_window

    # -- params ----------------------------------------------------------
    def param_leaves(self) -> Params:
        """Every parameter leaf (shape and logical axes), in the
        reference's tree layout."""
        cfg = self.cfg
        d = cfg.d_model
        layer = {"norm_attn": cm.norm_leaves(d, cfg.norm),
                 "attn": cm.attention_leaves(d, cfg.n_heads, cfg.n_kv_heads,
                                             self.head_dim),
                 "norm_mlp": cm.norm_leaves(d, cfg.norm)}
        if cfg.is_moe:
            layer["moe"] = cm.moe_leaves(d, cfg.d_ff, cfg.moe.n_experts,
                                         cfg.activation,
                                         cfg.moe.shared_expert)
        else:
            layer["mlp"] = cm.mlp_leaves(d, cfg.d_ff, cfg.activation)
        return {"embed": cm.embedding_leaves(
                    cfg.vocab_size, d, cfg.tie_embeddings,
                    max_seq=cfg.max_train_seq,
                    learned_pos=cfg.positional == "learned"),
                "final_norm": cm.norm_leaves(d, cfg.norm),
                "layers": cm.stack_leaves(layer, cfg.n_layers)}

    def leaf_dtype(self, name: str, dtype=None) -> torch.dtype:
        """Norm scales and biases and the MoE router stay float32 (read in
        f32 by the norm and by the routing); every other matrix and
        embedding holds ``dtype``, by default the compute dtype (serving;
        training passes ``self.param_dtype``)."""
        return torch.float32 if name in ("scale", "bias", "router") \
            else (dtype or self.compute_dtype)

    def init(self, generator: Optional[torch.Generator] = None,
             dtype=None, put=None) -> Params:
        """Random weights on the model's device, drawn from ``generator``
        (seed 0 when None): fan-in-scaled normals for the matrices (fan-in
        = the per-layer leaf's first dim, as the reference draws them),
        0.02 for embeddings, ones / zeros for norm scales / biases.
        Matrices hold ``dtype`` (see :meth:`leaf_dtype`); ``put`` takes
        each leaf as it is drawn (:func:`init_params`)."""
        return init_params(self.param_shapes(),
                           lambda name: self.leaf_dtype(name, dtype),
                           self.device, generator,
                           zeros=("bias",), ones=("scale",), put=put)

    def _extra_inputs(self, B: int):
        cfg = self.cfg
        if cfg.family != "vlm":
            return {}, 0
        P = cfg.vision_prefix_len
        return {"patch_embeds": _meta((B, P, cfg.d_model),
                                      self.compute_dtype)}, P

    # -- forward ---------------------------------------------------------
    def _embed_input(self, params: Params, tokens: torch.Tensor,
                     patch_embeds=None) -> torch.Tensor:
        """Token embeddings (B, S, d) in the compute dtype, with the patch
        rows (B, P, d), cast to the compute dtype, placed before them."""
        x = cm.embed_tokens(params["embed"], tokens, self.compute_dtype)
        if patch_embeds is None:
            return x
        patch = torch.as_tensor(patch_embeds, device=self.device)
        return torch.cat([cm.cast(patch, self.compute_dtype), x], dim=1)

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = cm.apply_norm(params["final_norm"], x, self.cfg.norm)
        return cm.unembed(params["embed"], x)

    def _mlp_block(self, lp: Params, x: torch.Tensor, drop: bool = True,
                   tp: Optional[Dict] = None):
        """x plus the layer's MLP, or its MoE layer (capacity-bounded with
        ``drop``, as in training; prefill and decode keep every pair);
        returns (x, the MoE aux dict, empty for a dense layer).  ``tp``'s
        ``"mlp"`` hooks, when given, wrap a dense block (see
        :meth:`_layer_fwd`); its ``"moe"`` entry, when given, is the rank's
        part of the MoE layer (a ``common.MoeShard``: a sharded step's
        expert-parallel layer)."""
        cfg = self.cfg
        h = cm.apply_norm(lp["norm_mlp"], x, cfg.norm)
        if not cfg.is_moe:
            f, g = _tp_hooks(tp, "mlp")
            return x + g(cm.apply_mlp(lp["mlp"], f(h), cfg.activation)), {}
        h, aux = cm.apply_moe(
            lp["moe"], h, n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor,
            activation=cfg.activation, shared_expert=cfg.moe.shared_expert,
            drop=drop, shard=(tp or {}).get("moe", cm.MoeShard()))
        return x + h, aux

    def _layer_fwd(self, lp: Params, x: torch.Tensor, q_offset: int,
                   window: int = 0, tp: Optional[Dict] = None):
        """One layer.  ``tp`` holds tensor-parallel hooks by block
        (``"attn"``, ``"mlp"``): a pair (f, g), f applied to the block's
        normed input and g to its output (Megatron's pair, where a rank
        computes its heads or columns of ``d_ff`` from ``lp``), and
        ``"moe"``, the rank's part of the MoE layer (see
        :meth:`_mlp_block`); a block without hooks runs as it is."""
        cfg = self.cfg
        f, g = _tp_hooks(tp, "attn")
        h = f(cm.apply_norm(lp["norm_attn"], x, cfg.norm))
        h = cm.attention_block(
            lp["attn"], h, cfg_theta=cfg.rope_theta,
            positional=cfg.positional, causal=True, window=window,
            softcap=cfg.attn_logit_softcap, q_offset=q_offset,
            block_k=self.block_k)
        return self._mlp_block(lp, x + g(h), tp=tp)

    def forward_hidden(self, params: Params, x: torch.Tensor,
                       q_offset: int = 0, remat: bool = True,
                       layer_fwd: Optional[Callable] = None
                       ) -> Tuple[torch.Tensor, Dict]:
        """Run the layer stack on embedded input x (B, S, d).  With
        ``remat`` each layer runs under ``torch.utils.checkpoint``: only
        its input is kept, and the backward recomputes the rest (the MoE
        layer's routing included).  ``layer_fwd`` takes the place of
        :meth:`_layer_fwd` (its arguments and result; a sharded step's,
        which makes the layer's weights whole inside the checkpoint).
        Returns (x, aux): aux is empty for a dense model; for an MoE model
        each of ``load_balance``, ``router_z`` and ``dropped_frac`` summed
        over the layers and divided by ``n_layers``, as the reference's
        scan reduces them."""
        L = self.cfg.n_layers
        layer_fwd = layer_fwd or self._layer_fwd
        total: Dict[str, torch.Tensor] = {}
        for layer, lp in enumerate(unstack_layers(params["layers"], L)):
            window = self._layer_window(layer % self.group)
            if remat:
                x, aux = checkpoint(layer_fwd, lp, x, q_offset, window,
                                    use_reentrant=False)
            else:
                x, aux = layer_fwd(lp, x, q_offset, window)
            for k, v in aux.items():
                total[k] = total[k] + v if k in total else v
        # divided as XLA divides by a constant: times its f32 reciprocal
        return x, {k: v * (1.0 / L) for k, v in total.items()}

    # -- training --------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             rng=None, remat: bool = True):
        """Mean next-token cross entropy with z-loss 1e-4 over ``batch``
        ("tokens", "targets", optional "mask" and "patch_embeds": the loss
        then covers the text positions only), as the reference's
        ``DecoderLM.loss``, plus an MoE model's weighted load balance and
        router z-loss (its three aux terms in the metrics).  ``rng`` is
        accepted for its signature (the model draws nothing).  Returns
        (loss, metrics)."""
        return cm.lm_loss(self, params, batch, remat)

    # -- serving ---------------------------------------------------------
    def _cache_struct(self, B: int, max_seq: int,
                      check: bool = True) -> Dict[str, LeafSpec]:
        """The cache leaves: "k"/"v" (L, B, max_seq, KV, D); with local
        layers, their rings "k_local"/"v_local" (n_groups, group - 1, B, W,
        KV, D), W = min(attn_window, max_seq), and the global layers'
        "k_global"/"v_global" (n_groups, B, max_seq, KV, D).  ``check``
        raises for positions past a learned table (``input_specs``
        describes any shape, as the reference's does)."""
        cfg = self.cfg
        if check and cfg.positional == "learned":
            cm.check_positions(max_seq, cfg.max_train_seq)
        KV, D, dt = cfg.n_kv_heads, self.head_dim, self.compute_dtype
        full = LeafSpec((self.n_groups, B, max_seq, KV, D), dt)
        if self.group == 1:
            return {"k": full, "v": full}
        W = min(cfg.attn_window, max_seq)
        ring = LeafSpec((self.n_groups, self.group - 1, B, W, KV, D), dt)
        return {"k_local": ring, "v_local": ring, "k_global": full,
                "v_global": full}

    def init_cache(self, B: int, max_seq: int) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self._cache_struct(B, max_seq).items()}

    def prefill(self, params: Params, tokens: torch.Tensor,
                patch_embeds=None, max_seq: Optional[int] = None,
                remat: bool = True,
                prompt_lens: Optional[torch.Tensor] = None, *,
                tp: Optional[Dict] = None,
                layer_use: Optional[Callable] = None,
                kv_heads: Optional[Tuple[int, int]] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_write: Optional[Callable] = None):
        """Process prompts (B, S) behind ``patch_embeds`` (B, P, d) when
        given; return (last-position logits (B, Vp), cache {"k", "v"} of
        (L, B, max_seq, KV, D) holding positions 0 .. P + S - 1; with
        local layers, the global layers' "k_global"/"v_global" so and the
        local layers' rings, see :meth:`_cache_struct`).

        ``prompt_lens`` (B,) enables batched bucketed prefill: rows are
        right-padded to S, attention masks keys past ``P + prompt_lens``,
        the logits are taken at each row's last valid position,
        ``P + prompt_len - 1``, and a ring takes each row's last W valid
        positions (``common.gather_ring_window``).  ``remat`` is accepted
        for the reference's signature; inference keeps no activations.

        The keywords run one rank's part of a sharded prefill
        (``parallel.serve_step``): ``tp`` the tensor-parallel hooks, as
        :meth:`_layer_fwd` takes them; ``layer_use`` makes a layer's blocks
        whole for use; ``kv_heads`` the KV heads the rank's query heads
        read (``common.attention_block``); ``cache`` the cache blocks to
        fill (by default a new cache of ``max_seq``); ``cache_write(dst,
        t, name)`` writes a layer's keys or values t (B, S or W, KV, D)
        into ``dst``, the layer's block of cache leaf ``name`` (by default
        into its leading positions).
        """
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._embed_input(params, tokens, patch_embeds)
        B, S = x.shape[0], x.shape[1]
        P = S - tokens.shape[1]                      # patch positions
        max_seq = max_seq or S
        if cache is None:
            cache = self.init_cache(B, max_seq)
        write = cache_write or _write_leading
        use = layer_use or _same
        f, g = _tp_hooks(tp, "attn")
        valid_len = None
        if prompt_lens is not None:
            valid_len = torch.as_tensor(prompt_lens, device=self.device
                                        ).to(torch.int32) + P
        # a ring takes each row's valid tail
        lens = valid_len if valid_len is not None else torch.full(
            (B,), S, dtype=torch.int32, device=self.device)
        layers = unstack_layers(params["layers"], cfg.n_layers)
        for layer, lp in enumerate(layers):
            grp, i = divmod(layer, self.group)
            window = self._layer_window(i)
            lp = use(lp)
            h = f(cm.apply_norm(lp["norm_attn"], x, cfg.norm))
            h, (k, v) = cm.attention_block(
                lp["attn"], h, cfg_theta=cfg.rope_theta,
                positional=cfg.positional, causal=True, window=window,
                softcap=cfg.attn_logit_softcap, block_k=self.block_k,
                return_kv=True, kv_valid_len=valid_len, kv_heads=kv_heads)
            x, _ = self._mlp_block(lp, x + g(h), drop=False, tp=tp)
            if self.group == 1:
                keys = (("k", k), ("v", v))
            elif window:
                W = min(cfg.attn_window, max_seq)
                keys = (("k_local", cm.gather_ring_window(k, lens, W)),
                        ("v_local", cm.gather_ring_window(v, lens, W)))
            else:
                keys = (("k_global", k), ("v_global", v))
            for name, t in keys:
                ring = name.endswith("_local")
                write(cache[name][grp, i] if ring else cache[name][grp], t,
                      name)
        last = x[:, -1:] if valid_len is None \
            else cm.gather_last_positions(x, valid_len)
        return self.logits(params, last)[:, 0], cache

    def cache_slot_axes(self):
        """Batch-axis index per cache leaf (for slot-wise admission)."""
        if self.group == 1:
            return {"k": 1, "v": 1}
        return {"k_local": 2, "v_local": 2, "k_global": 1, "v_global": 1}

    def cache_max_seq(self, cache) -> int:
        return cache["k" if self.group == 1 else "k_global"].shape[2]

    def paged_cache_keys(self):
        """Cache leaves holding unbounded (max_seq) KV, eligible for the
        block-table page pool; the local layers' rings stay dense
        (bounded W)."""
        return ["k", "v"] if self.group == 1 else ["k_global", "v_global"]

    def decode_step(self, params: Params, cache, tokens: torch.Tensor,
                    pos: torch.Tensor, block_tables=None):
        """One decode step; tokens, pos: (B,) int32.  Returns (logits
        (B, Vp), cache) with the cache written in place.

        With ``block_tables`` (B, nb) the leaves of
        :meth:`paged_cache_keys` are page pools (L, P, page, KV, D) shared
        by all slots (n_groups for "k_global"/"v_global"), with
        "<leaf>_scale" (L, P, KV) siblings when quantized; reads go
        through the paged decode kernel and writes scatter one token into
        each slot's page.  A local layer writes its ring at ``pos % W``
        and attends over it (:meth:`_ring_attention`) on either cache.
        """
        cfg = self.cfg
        B = tokens.shape[0]
        e = params["embed"]
        if "wpe" in e:
            # the reference's order: both rows added in the parameter
            # dtype, then cast.  A frozen slot parked one past a cache of
            # the table's length reads the last row, where the reference
            # reads NaN; its logits are never used
            row = torch.clamp(pos, max=e["wpe"].shape[0] - 1)
            x = cm.cast(e["wte"][tokens[:, None]] + e["wpe"][row[:, None]],
                        self.compute_dtype)
        else:
            x = cm.embed_tokens(e, tokens[:, None], self.compute_dtype)
        paged = block_tables is not None
        arange = torch.arange(B, device=tokens.device)
        layers = unstack_layers(params["layers"], cfg.n_layers)
        kkey, vkey = self.paged_cache_keys()
        for layer, lp in enumerate(layers):
            g, i = divmod(layer, self.group)
            ring = self._layer_window(i) > 0
            if ring:
                kc, vc = cache["k_local"][g, i], cache["v_local"][g, i]
                ks = vs = None
            else:
                kc, vc = cache[kkey][g], cache[vkey][g]
                ks = cache[f"{kkey}_scale"][g] \
                    if f"{kkey}_scale" in cache else None
                vs = cache[f"{vkey}_scale"][g] \
                    if f"{vkey}_scale" in cache else None
            h = cm.apply_norm(lp["norm_attn"], x, cfg.norm)
            q = cm.project_heads(h, lp["attn"]["wq"])
            k = cm.project_heads(h, lp["attn"]["wk"])
            v = cm.project_heads(h, lp["attn"]["wv"])
            if cfg.positional == "rope":
                q = cm.apply_rope(q, pos[:, None], cfg.rope_theta)
                k = cm.apply_rope(k, pos[:, None], cfg.rope_theta)
            if ring:
                W = kc.shape[1]
                kc[arange, pos % W] = k[:, 0]
                vc[arange, pos % W] = v[:, 0]
                s = torch.arange(W, device=pos.device)[None, :]
                abs_pos = pos[:, None] - torch.remainder(pos[:, None] - s, W)
                o = self._ring_attention(q, kc, vc, abs_pos, pos)
            elif paged:
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
            x, _ = self._mlp_block(lp, x, drop=False)
        return self.logits(params, x)[:, 0], cache

    def _ring_attention(self, q, kc, vc, abs_pos, pos):
        """Attention over a ring cache (B, W, KV, D) whose slot s holds
        absolute position ``abs_pos[b, s]``: the reference's plain jnp
        attention (q scaled in its own dtype, f32 scores and softmax over
        the slots at positions 0 .. pos; no kernel computes it there)."""
        B, _, H, D = q.shape
        KV = kc.shape[2]
        qr = q.reshape(B, KV, H // KV, D) * query_scale(D, q.dtype)
        s = torch.einsum("bkgd,bskd->bkgs", qr.float(), kc.float())
        valid = (abs_pos >= 0) & (abs_pos <= pos[:, None])
        s = torch.where(valid[:, None, None, :], s, cm.NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskd->bkgd", p, vc.float())
        return o.reshape(B, 1, H, D).to(q.dtype)
