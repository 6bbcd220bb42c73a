"""Config dataclasses for architectures and input shapes (a copy of the
JAX package's ``configs/base.py``; the port keeps its own).

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
canonical input shapes as :class:`ShapeConfig`.  Configs are plain frozen
dataclasses so they can be hashed, diffed, and serialized into experiment
artifacts.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "encdec", "vlm", "ssm", "hybrid")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config."""

    n_experts: int = 0
    top_k: int = 1
    # capacity factor for sort-based dispatch (tokens beyond capacity drop)
    capacity_factor: float = 1.25
    # llama4-style always-on shared expert (adds one dense MLP per MoE layer)
    shared_expert: bool = False
    # weight of the load-balancing auxiliary loss
    aux_loss_weight: float = 0.01
    router_z_loss_weight: float = 1e-3


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) sub-config."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2          # d_inner = expand * d_model
    n_groups: int = 1        # B/C projection groups
    conv_width: int = 4
    chunk_size: int = 256    # SSD chunk length
    dt_min: float = 1e-3
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    """A complete architecture description.

    The LM-transformer fields follow the assignment table verbatim; family-
    specific structure hangs off the ``moe``/``ssm`` sub-configs and the
    structural flags below.
    """

    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- structural flags -------------------------------------------------
    activation: str = "swiglu"       # swiglu | gelu | relu2
    norm: str = "rms"                # rms | layer
    positional: str = "rope"         # rope | learned | none
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0
    qk_norm: bool = False

    # windowed ("chunked") local attention: 0 = full attention everywhere.
    # When >0, ``global_attn_every`` selects which layers stay global.
    attn_window: int = 0
    global_attn_every: int = 0       # e.g. 4 -> layers 3,7,11,... are global

    # encoder-decoder (family == "encdec")
    n_encoder_layers: int = 0
    encoder_frontend_len: int = 0    # frames fed to the encoder (stubbed)

    # vlm (family == "vlm"): number of stub patch embeddings prefixed
    vision_prefix_len: int = 0

    # hybrid (family == "hybrid"): a shared attention block is applied every
    # ``attn_every`` SSM blocks (zamba2-style weight sharing)
    attn_every: int = 0

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # --- numerics ---------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # max sequence length the arch supports without sub-quadratic attention.
    # long_500k is only runnable when subquadratic is True (SSM/hybrid) or
    # attn_window > 0 (chunked local attention).
    max_train_seq: int = 1 << 20

    # source annotation, e.g. "[arXiv:2402.16819; unverified]"
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={self.n_kv_heads}")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode without O(S^2) prefill/attn?"""
        return self.family in ("ssm", "hybrid") or self.attn_window > 0

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    # Parameter count (total / active) -- used for MODEL_FLOPS = 6*N*D.
    def param_count(self) -> Tuple[int, int]:
        """Returns (total_params, active_params_per_token)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        total = 0
        emb = v * d
        total += emb if self.tie_embeddings else 2 * emb
        if self.positional == "learned":
            total += self.max_train_seq * 0  # counted per-shape, negligible

        def attn_params():
            return d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d

        def mlp_params(dff):
            if self.activation == "swiglu":
                return 3 * d * dff
            return 2 * d * dff

        active = total

        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per = (d * (2 * d_in + 2 * s.n_groups * s.state_dim + nh)  # in_proj
                   + s.conv_width * (d_in + 2 * s.n_groups * s.state_dim)
                   + nh * 2                                            # A_log, D
                   + d_in                                              # gate norm
                   + d_in * d)                                         # out_proj
            total += self.n_layers * (per + d)
            active = total
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per = (d * (2 * d_in + 2 * s.n_groups * s.state_dim + nh)
                   + s.conv_width * (d_in + 2 * s.n_groups * s.state_dim)
                   + nh * 2 + d_in + d_in * d + 2 * d)
            total += self.n_layers * per
            # one shared attention+mlp block (input is concat(h, emb) -> 2d)
            total += 2 * d * (self.n_heads * hd) * 2 + mlp_params(ff) + 4 * d
            active = total
        elif self.is_moe:
            per_dense = attn_params() + 4 * d
            per_expert = mlp_params(ff)
            shared = mlp_params(ff) if self.moe.shared_expert else 0
            total += self.n_layers * (per_dense + self.moe.n_experts * per_expert
                                      + shared + d * self.moe.n_experts)
            active = (total
                      - self.n_layers * (self.moe.n_experts - self.moe.top_k)
                      * per_expert)
        else:
            n_dec = self.n_layers
            per = attn_params() + mlp_params(ff) + 4 * d
            total += n_dec * per
            if self.family == "encdec":
                # encoder layers + decoder cross-attention
                total += self.n_encoder_layers * per
                total += n_dec * (attn_params() + 2 * d)
            active = total
        total += d  # final norm
        if self.family != "ssm":
            active = active if active != 0 else total
        return int(total), int(active)


# ---------------------------------------------------------------------------
# Shape configs
# ---------------------------------------------------------------------------

SHAPE_KINDS = ("train", "prefill", "decode")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    def __post_init__(self):
        if self.kind not in SHAPE_KINDS:
            raise ValueError(f"unknown shape kind {self.kind!r}")

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """A drastically reduced config of the same family, for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=257,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        max_train_seq=4096,
    )
    if cfg.is_moe:
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2))
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm"] = replace(cfg.ssm, state_dim=16, head_dim=16, chunk_size=16)
    if cfg.family == "hybrid":
        kw["n_layers"] = 4
        kw["attn_every"] = 2
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = 2
        kw["encoder_frontend_len"] = 12
    if cfg.family == "vlm":
        kw["vision_prefix_len"] = 8
    if cfg.attn_window:
        kw["attn_window"] = 32
        kw["global_attn_every"] = cfg.global_attn_every and 2
    return replace(cfg, **kw)
