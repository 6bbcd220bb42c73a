"""Architecture registry of the port: ``--arch <id>`` resolution, and the
canonical input shapes (``--shape <name>``).

The registry holds the archs whose model family the port has: llama3.2-1b
(dense decoder), mamba2-370m (SSM) and zamba2-7b (hybrid: Mamba2 and a
shared attention block); the JAX package's other archs join as their model
families are ported (see ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict

from . import llama3_2_1b, mamba2_370m, zamba2_7b
from .base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, smoke_config
from .shapes import SHAPES, get_shape, smoke_shape

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (llama3_2_1b, mamba2_370m, zamba2_7b)}


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")


def card_smoke_config(cfg: ModelConfig) -> ModelConfig:
    """``smoke_config(cfg)`` at the smallest widths the port's CUDA kernels
    are built for, the reduced config of a smoke run on the card: d_model
    256 (RMSNorm's narrowest row), head_dim 64 (the flash and paged decode
    kernels' width for any group), d_ff 1024.  The dense family only: the
    SSD scan is built for the served models' state and head widths."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: no reduced config runs the card's kernels for "
            f"family {cfg.family!r}; run it at full width")
    return replace(smoke_config(cfg), d_model=256, head_dim=64, d_ff=1024)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
           "REGISTRY", "SHAPES", "get_config", "get_shape", "smoke_config",
           "smoke_shape", "card_smoke_config"]
