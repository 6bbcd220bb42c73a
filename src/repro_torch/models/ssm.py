"""Mamba2 (SSD, state-space duality) blocks and LM stack of the port: the
JAX package's ``models/ssm.py:MambaLM``, serving and training.

The chunked SSD scan (``ssd_chunked``) goes through the ``ssd_scan`` kernel
wrapper: its plain version on the CPU, the Hopper kernel on the card; under
autograd its backward recomputes the plain f32 chunked form, as the
reference differentiates its jnp scan.  The one-token recurrence, the
depthwise causal convolution and its decode step are plain PyTorch, as the
reference leaves them to XLA.  Parameters keep the reference's stacked
layout (every layer leaf has a leading ``n_layers`` dim) and the layer loop
runs over views of it, as in ``DecoderLM``.  The recurrent caches (SSM
state, conv window) are written in place.  Training (``forward_hidden``,
``loss``) runs each layer under ``torch.utils.checkpoint`` when ``remat``
is on, as the reference wraps its scanned layer in ``jax.checkpoint``, on
f32 masters (``init(dtype=)``).

A tensor-parallel rank runs its part of each block (``MambaShard``: the
sharded step, prefill and decode of ``parallel.train_step`` /
``serve_step``):
its heads of ``inner``, the B/C columns gathered after the conv, the gate
norm over the whole ``d_inner`` from a summed sum of squares, and
``out_proj`` row-parallel.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.ssd_scan import ssd_scan
from . import common as cm
from .common import Params
from .transformer import (AbstractParams, LeafSpec, _same, _write_leading,
                          init_params, init_scale, resolve_device,
                          unstack_layers)

_DT_BIAS = -4.6  # softplus^-1(0.01): default timestep at init
#: leaves held in float32 whatever the compute dtype: the reference reads
#: dt_bias and A_log as f32 (a bf16 A_log would change every decay) and
#: the norm scales in f32; D is cast to the activations' dtype at use
_F32_LEAVES = ("scale", "dt_bias", "A_log", "D")


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(xb: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xb: (B, S, H, P) dt-scaled inputs; a: (B, S, H) log-decay (dt * A,
    negative); Bm, Cm: (B, S, G, N) input/output projections (G groups,
    H % G == 0); h0: optional initial state (B, H, N, P).  Returns (y
    (B, S, H, P), final_state (B, H, N, P) float32).
    """
    return ssd_scan(xb, a, Bm, Cm, chunk, h0=h0)


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD recurrence.

    h: (B, H, N, P) state; x: (B, H, P) dt-scaled input; a: (B, H) log
    decay; Bm, Cm: (B, G, N).  Returns (y (B, H, P), h_new).
    """
    B, H, N, P = h.shape
    G = Bm.shape[1]
    hpg = H // G
    hr = h.reshape(B, G, hpg, N, P)
    xr = x.reshape(B, G, hpg, P).float()
    ar = a.reshape(B, G, hpg).float()
    upd = torch.einsum("bgi,bghp->bghip", Bm.float(), xr)
    h_new = torch.exp(ar)[..., None, None] * hr + upd
    y = torch.einsum("bgi,bghip->bghp", Cm.float(), h_new)
    return y.reshape(B, H, P).to(x.dtype), h_new.reshape(B, H, N, P)


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (W, C), b: (C,).  Left-padded depthwise causal
    conv: out[t] = sum_j w[j] x[t - W + 1 + j] + b, a cross-correlation as
    ``lax.conv_general_dilated`` computes it (the taps are not flipped)."""
    W, C = w.shape
    xt = F.pad(x.transpose(1, 2), (W - 1, 0))                 # (B, C, S+W-1)
    out = F.conv1d(xt, cm.cast(w, x.dtype).t()[:, None, :], groups=C)
    return out.transpose(1, 2) + cm.cast(b, x.dtype)


def conv_decode_step(window: torch.Tensor, x_new: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor):
    """window: (B, W-1, C) past inputs; x_new: (B, C).  Returns (y,
    new_window)."""
    full = torch.cat([window, x_new[:, None]], dim=1)         # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full, cm.cast(w, x_new.dtype)) \
        + cm.cast(b, x_new.dtype)
    return y, full[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return s, d_in, d_in // s.head_dim, s.n_groups * s.state_dim


class MambaShard(NamedTuple):
    """One tensor-parallel rank's part of a Mamba2 block (its heads of
    ``inner`` over ``model``); no shard is the whole block.  ``h0``,
    ``nh``: the rank's first head and its heads (``w_z``, ``w_x``, the x
    conv, ``gate_norm`` and ``out_proj`` hold their columns or rows; the
    per-head leaves ``w_dt``, ``dt_bias``, ``A_log`` and ``D`` are whole
    and sliced here); ``g0``, ``ng``: the B/C groups those heads read.
    ``f`` / ``g``: Megatron's pair, f on the block's input, g on
    ``out_proj``'s partial sums.  ``gather``: the model ranks' B/C columns
    after the conv, concatenated on the last dim (identity where
    ``w_bc`` is whole).  ``norm_sum``: the sum over the model ranks of the
    gate norm's sums of squares, its gradient summed too; ``width`` the
    whole ``d_inner`` it is taken over.

    A sharded decode (:func:`mamba_decode_step`) keeps the caches in their
    own layout and sets three more: ``window(conv, xs, bc)`` gives, from
    the rank's block of the conv window and the token's x and B/C columns,
    the past window's x and B/C columns of the rank and its new block;
    ``to_state`` moves the token's dt-scaled x of the rank's heads into the
    SSM state's layout and ``from_state`` moves y back."""
    h0: int
    nh: int
    g0: int
    ng: int
    width: int
    f: Callable
    g: Callable
    gather: Callable
    norm_sum: Callable
    window: Optional[Callable] = None
    to_state: Optional[Callable] = None
    from_state: Optional[Callable] = None


def split_rmsnorm(x: torch.Tensor, scale: torch.Tensor, total: Callable,
                  width: int, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of rows whose ``width`` columns are split over ranks, x the
    rank's columns: the ``rmsnorm`` kernel's recipe in plain f32 (the mean
    of squares, rsqrt, times the f32 scale, cast back), the sum of squares
    summed over the ranks by ``total``."""
    x32 = x.float()
    var = total(x32.square().sum(-1, keepdim=True)) / width
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _own(t: torch.Tensor, tp: Optional[MambaShard]) -> torch.Tensor:
    """The rank's heads (last dim) of a whole per-head leaf."""
    return t if tp is None else t.narrow(-1, tp.h0, tp.nh)


def _gated_out(p: Params, y: torch.Tensor, z: torch.Tensor,
               tp: Optional[MambaShard] = None) -> torch.Tensor:
    y = y * F.silu(z)
    if tp is None:
        y = cm.apply_norm(p["gate_norm"], y, "rms")
    else:
        y = split_rmsnorm(y, p["gate_norm"]["scale"], tp.norm_sum, tp.width)
    out = y @ cm.cast(p["out_proj"], y.dtype)
    return out if tp is None else tp.g(out)


def _groups(t: torch.Tensor, cfg: ModelConfig,
            tp: Optional[MambaShard]) -> torch.Tensor:
    """(..., G N) B or C columns as (..., G, N), the rank's groups."""
    s = cfg.ssm
    t = t.reshape(t.shape[:-1] + (s.n_groups, s.state_dim))
    return t if tp is None else t.narrow(-2, tp.g0, tp.ng)


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                h0: Optional[torch.Tensor] = None, return_state: bool = False,
                seq_lens: Optional[torch.Tensor] = None,
                tp: Optional[MambaShard] = None):
    """Full-sequence Mamba2 block.  x: (B, S, d).  ``tp``: a rank's part
    (:class:`MambaShard`; its heads, states and conv columns).

    ``seq_lens`` (B,) marks per-row valid lengths for right-padded batched
    prefill: padded positions get ``dt = 0``, which makes the SSD
    recurrence the identity there, so the final state is the state at each
    row's true length; the conv tail is gathered from the last valid
    positions instead of the padded end.  With ``return_state`` returns
    (out, (final SSM state, conv tail (B, W-1, C))).
    """
    s, d_in, nh, gn = _dims(cfg)
    B_, S, _ = x.shape
    if tp is not None:
        x = tp.f(x)
        nh, d_in = tp.nh, tp.nh * s.head_dim
    z = x @ cm.cast(p["w_z"], x.dtype)
    xs = x @ cm.cast(p["w_x"], x.dtype)
    bc = x @ cm.cast(p["w_bc"], x.dtype)
    dt = x @ cm.cast(_own(p["w_dt"], tp), x.dtype)
    conv_in = torch.cat([xs, bc], dim=-1)
    xs = F.silu(causal_conv(xs, p["conv_x_w"], p["conv_x_b"]))
    bc_c = F.silu(causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"]))
    if tp is not None:
        bc_c = tp.gather(bc_c)
    Bm, Cm = bc_c[..., :gn], bc_c[..., gn:]
    dt = F.softplus(dt.float() + _own(p["dt_bias"], tp).float() + _DT_BIAS)
    if seq_lens is not None:
        # padded positions: dt = 0 -> log-decay 0 and no input update
        valid = torch.arange(S, device=x.device)[None, :] \
            < seq_lens.to(x.device)[:, None]
        dt = dt * valid[..., None]
    A = -torch.exp(_own(p["A_log"], tp).float())              # (nh,)
    a = dt * A                                                # (B, S, nh)
    xh = xs.reshape(B_, S, nh, s.head_dim)
    xb = xh * dt[..., None].to(xh.dtype)
    y, h_final = ssd_chunked(xb, a, _groups(Bm, cfg, tp),
                             _groups(Cm, cfg, tp), s.chunk_size, h0=h0)
    y = y + cm.cast(_own(p["D"], tp), y.dtype)[None, None, :, None] * xh
    out = _gated_out(p, y.reshape(B_, S, d_in), z, tp)
    if not return_state:
        return out
    # conv tail: the last W-1 raw conv inputs, at each row's true end
    W1 = s.conv_width - 1
    if seq_lens is not None:
        tail = cm.gather_tail_window(conv_in, seq_lens, W1)
    else:
        tail = conv_in[:, -W1:]
        if S < W1:
            tail = F.pad(tail, (0, 0, W1 - S, 0))
    return out, (h_final, tail)


def mamba_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                tp: Optional[MambaShard] = None) -> torch.Tensor:
    """A residual layer of the training forward: x + mamba_block(norm(x)),
    ``lp`` holding the layer's ``norm`` and ``mamba`` leaves (a rank's
    part with ``tp``)."""
    h = cm.apply_norm(lp["norm"], x, cfg.norm)
    return x + mamba_block(lp["mamba"], h, cfg, tp=tp)


def mamba_param_leaves(cfg: ModelConfig) -> Params:
    """Leaves of one Mamba2 block, in the reference's ``init_mamba_block``
    layout."""
    s, d_in, nh, gn = _dims(cfg)
    d, bc = cfg.d_model, 2 * gn
    leaf = cm.leaf
    return {"w_z": leaf((d, d_in), ("embed", "inner")),
            "w_x": leaf((d, d_in), ("embed", "inner")),
            "w_bc": leaf((d, bc), ("embed", "inner")),
            "w_dt": leaf((d, nh), ("embed", None)),
            "conv_x_w": leaf((s.conv_width, d_in), (None, "inner")),
            "conv_x_b": leaf((d_in,), ("inner",)),
            "conv_bc_w": leaf((s.conv_width, bc), (None, "inner")),
            "conv_bc_b": leaf((bc,), ("inner",)),
            "dt_bias": leaf((nh,), (None,)), "A_log": leaf((nh,), (None,)),
            "D": leaf((nh,), (None,)),
            "gate_norm": {"scale": leaf((d_in,), ("inner",))},
            "out_proj": leaf((d_in, d), ("inner", "embed"))}


def mamba_leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """Norm scales, ``dt_bias``, ``A_log`` and ``D`` stay float32 (the
    reference reads the first three in f32 from its f32 masters);
    projections, conv weights and biases and the embedding hold ``dtype``
    (the reference casts them to the compute dtype at use)."""
    return torch.float32 if name in _F32_LEAVES else dtype


def init_mamba_params(shapes: Params, dtype: torch.dtype, device,
                      generator: Optional[torch.Generator],
                      put=None) -> Params:
    """Random weights for a tree holding Mamba2 blocks, as the reference's
    initializers draw them: fan-in-scaled normals for the projections, 0.5
    for the conv weights, 0.02 for the embedding; zeros for the conv
    biases, ``dt_bias`` and ``A_log`` (A = -1); ones for ``D`` and norm
    scales.  ``put`` takes each leaf as it is drawn
    (``transformer.init_params``)."""
    return init_params(
        shapes, lambda name: mamba_leaf_dtype(name, dtype), device,
        generator, zeros=("conv_x_b", "conv_bc_b", "dt_bias", "A_log"),
        ones=("D", "scale"),
        scale=lambda name, per: 0.5 if name.startswith("conv_")
        else init_scale(name, per), put=put)


def mamba_decode_step(p: Params, x: torch.Tensor, cache, cfg: ModelConfig,
                      tp: Optional[MambaShard] = None):
    """One-token Mamba2 step.  x: (B, 1, d); cache = (ssm_state, conv_window).

    The conv window stores concat(x_seg, bc_seg) raw conv inputs; the two
    depthwise convs run on their own segments (identical to the fused
    form).  ``tp``: a rank's part (:class:`MambaShard` with its decode
    hooks): its heads of x, z and y, the B/C columns gathered after the
    conv, the state and conv window as the rank's blocks of the cache.
    Returns (out (B, 1, d), (ssm_state, conv_window)), both new."""
    s, d_in, nh, gn = _dims(cfg)
    h, conv_win = cache
    B_ = x.shape[0]
    x1 = x[:, 0] if tp is None else tp.f(x[:, 0])
    z = x1 @ cm.cast(p["w_z"], x.dtype)
    xs = x1 @ cm.cast(p["w_x"], x.dtype)
    bc = x1 @ cm.cast(p["w_bc"], x.dtype)
    dt = x1 @ cm.cast(p["w_dt"], x.dtype)                    # every head
    if tp is None:
        win_x, win_bc = conv_win[..., :d_in], conv_win[..., d_in:]
    else:
        win_x, win_bc, conv_win = tp.window(conv_win, xs, bc)
    xs_out, win_x = conv_decode_step(win_x, xs, p["conv_x_w"], p["conv_x_b"])
    bc_out, win_bc = conv_decode_step(win_bc, bc,
                                      p["conv_bc_w"], p["conv_bc_b"])
    if tp is None:
        conv_win = torch.cat([win_x, win_bc], dim=-1)
    xs = F.silu(xs_out)
    bc_out = F.silu(bc_out)
    if tp is not None:
        bc_out = tp.gather(bc_out)
    Bm, Cm = bc_out[..., :gn], bc_out[..., gn:]
    dt = F.softplus(dt.float() + p["dt_bias"].float() + _DT_BIAS)
    A = -torch.exp(p["A_log"].float())
    a = dt * A                                                # (B, nh)
    xh = xs.reshape(B_, -1, s.head_dim)
    xb = xh * _own(dt, tp)[..., None].to(xh.dtype)
    y, h = ssd_decode_step(h, xb if tp is None else tp.to_state(xb), a,
                           Bm.reshape(B_, s.n_groups, s.state_dim),
                           Cm.reshape(B_, s.n_groups, s.state_dim))
    if tp is not None:
        y = tp.from_state(y)
    y = y + cm.cast(_own(p["D"], tp), y.dtype)[None, :, None] * xh
    out = _gated_out(p, y.reshape(B_, -1), z, tp)
    return out[:, None], (h, conv_win)


# ---------------------------------------------------------------------------
# Mamba2 LM (mamba2-370m)
# ---------------------------------------------------------------------------

class MambaLM(AbstractParams):
    """Attention-free Mamba2 LM over stacked (n_layers, ...) parameters."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: MambaLM takes the ssm family, got "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)
        s = cfg.ssm
        self.d_inner = s.expand * cfg.d_model
        self.nh = self.d_inner // s.head_dim
        self.conv_ch = self.d_inner + 2 * s.n_groups * s.state_dim

    # -- params ----------------------------------------------------------
    def param_leaves(self) -> Params:
        """Every parameter leaf (shape and logical axes), in the
        reference's tree layout."""
        cfg = self.cfg
        layer = {"norm": cm.norm_leaves(cfg.d_model, cfg.norm),
                 "mamba": mamba_param_leaves(cfg)}
        return {"embed": cm.embedding_leaves(cfg.vocab_size, cfg.d_model,
                                             cfg.tie_embeddings),
                "final_norm": cm.norm_leaves(cfg.d_model, cfg.norm),
                "layers": cm.stack_leaves(layer, cfg.n_layers)}

    def leaf_dtype(self, name: str, dtype=None) -> torch.dtype:
        """See :func:`mamba_leaf_dtype`; ``dtype`` defaults to the compute
        dtype."""
        return mamba_leaf_dtype(name, dtype or self.compute_dtype)

    def init(self, generator: Optional[torch.Generator] = None,
             dtype=None, put=None) -> Params:
        """Random weights on the model's device, drawn from ``generator``
        (seed 0 when None) as :func:`init_mamba_params` draws them, in
        their leaf dtypes (:meth:`leaf_dtype`): ``dtype`` defaults to the
        compute dtype (serving); training passes ``self.param_dtype``;
        ``put`` takes each leaf as it is drawn."""
        return init_mamba_params(self.param_shapes(),
                                 dtype or self.compute_dtype, self.device,
                                 generator, put=put)

    # -- forward ---------------------------------------------------------
    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = cm.apply_norm(params["final_norm"], x, self.cfg.norm)
        return cm.unembed(params["embed"], x)

    def _layer_fwd(self, lp: Params, x: torch.Tensor) -> torch.Tensor:
        return mamba_layer(lp, x, self.cfg)

    def forward_hidden(self, params: Params, x: torch.Tensor,
                       remat: bool = True,
                       layer_fwd: Optional[Callable] = None):
        """Run the layer stack on embedded input x (B, S, d).  With
        ``remat`` each layer (its norm and block) runs under
        ``torch.utils.checkpoint``: only its input is kept, and the
        backward recomputes the rest.  ``layer_fwd(lp, x)`` takes the place
        of a layer (a sharded step's, which makes the layer's weights
        whole inside the checkpoint).  Returns (x, {})."""
        layer_fwd = layer_fwd or self._layer_fwd
        for lp in unstack_layers(params["layers"], self.cfg.n_layers):
            if remat:
                x = checkpoint(layer_fwd, lp, x, use_reentrant=False)
            else:
                x = layer_fwd(lp, x)
        return x, {}

    def loss(self, params: Params, batch, rng=None, remat: bool = True):
        """Mean next-token cross entropy with z-loss 1e-4 over ``batch``
        ("tokens", "targets", optional "mask"), as the reference's
        ``MambaLM.loss``.  ``rng`` is accepted for its signature.  Returns
        (loss, metrics)."""
        return cm.lm_loss(self, params, batch, remat)

    # -- serving ---------------------------------------------------------
    def _cache_struct(self, B: int, max_seq: int = 0,
                      check: bool = True) -> Dict[str, LeafSpec]:
        cfg = self.cfg
        s = cfg.ssm
        return {"ssm": LeafSpec((cfg.n_layers, B, self.nh, s.state_dim,
                                 s.head_dim), torch.float32),
                "conv": LeafSpec((cfg.n_layers, B, s.conv_width - 1,
                                  self.conv_ch), self.compute_dtype)}

    def init_cache(self, B: int, max_seq: int = 0) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self._cache_struct(B, max_seq).items()}

    def prefill(self, params: Params, tokens: torch.Tensor,
                max_seq: Optional[int] = None, remat: bool = True,
                prompt_lens: Optional[torch.Tensor] = None, *,
                tp: Optional[Dict] = None,
                layer_use: Optional[Callable] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_write: Optional[Callable] = None):
        """Process prompts (B, S); return (last-position logits (B, Vp),
        cache {"ssm" (L, B, nh, N, P) f32, "conv" (L, B, W-1, C)}).

        ``prompt_lens`` (B,) enables batched bucketed prefill: rows are
        right-padded to S, and each row's state, conv tail and logits are
        taken at its last valid position.  ``max_seq`` and ``remat`` are
        accepted for the reference's signature: the state has no sequence
        capacity, and inference keeps no activations.

        The keywords run one rank's part of a sharded prefill
        (``parallel.serve_step``): ``tp["mamba"]`` the rank's
        :class:`MambaShard`; ``layer_use`` makes a layer's blocks whole for
        use; ``cache`` the cache blocks to fill; ``cache_write(dst, t,
        name)`` writes a layer's final state or conv tail ``t`` (the
        rank's heads or columns) into ``dst``, its block of leaf ``name``.
        """
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        x = cm.embed_tokens(params["embed"], tokens, self.compute_dtype)
        lens = None if prompt_lens is None else \
            torch.as_tensor(prompt_lens, device=self.device).to(torch.int32)
        if cache is None:
            cache = {k: torch.empty(s.shape, dtype=s.dtype,
                                    device=self.device)
                     for k, s in self._cache_struct(tokens.shape[0]).items()}
        write = cache_write or _write_leading
        use = layer_use or _same
        shard = (tp or {}).get("mamba")
        layers = unstack_layers(params["layers"], cfg.n_layers)
        for layer, lp in enumerate(layers):
            lp = use(lp)
            h = cm.apply_norm(lp["norm"], x, cfg.norm)
            out, (hf, tail) = mamba_block(lp["mamba"], h, cfg,
                                          return_state=True, seq_lens=lens,
                                          tp=shard)
            x = x + out
            write(cache["ssm"][layer], hf, "ssm")
            write(cache["conv"][layer], tail, "conv")
        last = x[:, -1:] if lens is None \
            else cm.gather_last_positions(x, lens)
        return self.logits(params, last)[:, 0], cache

    def cache_slot_axes(self):
        """Batch-axis index per cache leaf (for slot-wise admission)."""
        return {"ssm": 1, "conv": 1}

    def paged_cache_keys(self):
        """Constant-size recurrent state: nothing to page."""
        return []

    def cache_max_seq(self, cache) -> int:
        return 0    # constant-size state; no sequence capacity

    def decode_step(self, params: Params, cache, tokens: torch.Tensor,
                    pos: torch.Tensor, block_tables=None):
        """One decode step; tokens, pos: (B,) int32.  Returns (logits
        (B, Vp), cache) with the cache written in place.  ``pos`` and
        ``block_tables`` are accepted for the engine's uniform call: the
        recurrent state needs neither (a paged engine keeps the block
        tables for its page accounting only)."""
        cfg = self.cfg
        x = cm.embed_tokens(params["embed"], tokens[:, None],
                            self.compute_dtype)
        layers = unstack_layers(params["layers"], cfg.n_layers)
        for layer, lp in enumerate(layers):
            ssm, conv = cache["ssm"][layer], cache["conv"][layer]
            h = cm.apply_norm(lp["norm"], x, cfg.norm)
            out, (ssm_new, conv_new) = mamba_decode_step(lp["mamba"], h,
                                                         (ssm, conv), cfg)
            x = x + out
            ssm.copy_(ssm_new)
            conv.copy_(conv_new)
        return self.logits(params, x)[:, 0], cache
