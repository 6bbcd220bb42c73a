"""Architecture registry of the port: ``--arch <id>`` resolution, and the
canonical input shapes (``--shape <name>``).

The registry holds the archs whose model family the port has: llama3.2-1b,
llama3.2-3b, yi-34b and gpt3-xl (dense decoders: RoPE, RMSNorm and SwiGLU
at head_dim 64 and at head_dim 128 with 3 or 7 query heads per KV head;
learned positions, LayerNorm and tanh GELU), internvl2-1b (VLM: the dense
decoder behind a prefix of patch embeddings), granite-moe-1b-a400m (MoE:
32 experts, top-8), seamless-m4t-medium (encoder-decoder: a bidirectional
encoder over stubbed frame embeddings, a decoder with cross-attention to
its output), mamba2-370m (SSM) and zamba2-7b (hybrid: Mamba2 and a shared
attention block); the JAX package's other archs join as their model
families are ported (see ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict

from . import (gpt3_xl, granite_moe_1b_a400m, internvl2_1b, llama3_2_1b,
               llama3_2_3b, llama4_scout_17b_a16e, mamba2_370m,
               nemotron_4_340b, seamless_m4t_medium, yi_34b, zamba2_7b)
from .base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, smoke_config
from .shapes import SHAPES, get_shape, smoke_shape

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (llama3_2_1b, llama3_2_3b, yi_34b, gpt3_xl, nemotron_4_340b,
              internvl2_1b, granite_moe_1b_a400m, llama4_scout_17b_a16e,
              seamless_m4t_medium, mamba2_370m, zamba2_7b)}


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")


def card_smoke_config(cfg: ModelConfig) -> ModelConfig:
    """``smoke_config(cfg)`` at the smallest widths the port's CUDA kernels
    are built for, the reduced config of a smoke run on the card: d_model
    256 (RMSNorm's narrowest row), head_dim 64, d_ff 1024.  The config's
    recipe stays: its norm (RMSNorm, or LayerNorm, which runs no kernel),
    its positions (RoPE, or a learned table of the smoke config's
    ``max_train_seq`` rows) and its activation.  The smoke
    config's heads stay (4 query heads, 2 KV heads: a group of 2), which
    the flash prefill kernel takes at head_dim 64 for any group and the
    paged decode kernel is built for
    (``kernels.flash_attention.paged.KERNEL_CASES``).  The MoE family
    keeps the smoke config's 4 experts and top-2, each expert at d_ff 1024;
    the VLM family its 8 patch rows.  The dense, MoE and VLM families only:
    the SSD scan is built for the served models' state and head widths,
    and the encoder-decoder has no launcher (the reference's serve
    launcher refuses it too)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: no reduced config runs the card's kernels for "
            f"family {cfg.family!r}; run it at full width")
    return replace(smoke_config(cfg), d_model=256, head_dim=64, d_ff=1024)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
           "REGISTRY", "SHAPES", "get_config", "get_shape", "smoke_config",
           "smoke_shape", "card_smoke_config"]
