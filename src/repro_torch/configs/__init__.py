"""Architecture registry of the port: ``--arch <id>`` resolution.

The registry holds the archs whose model family the port has: llama3.2-1b
(dense decoder), mamba2-370m (SSM) and zamba2-7b (hybrid: Mamba2 and a
shared attention block); the JAX package's other archs join as their model
families are ported (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

from . import llama3_2_1b, mamba2_370m, zamba2_7b
from .base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, smoke_config

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (llama3_2_1b, mamba2_370m, zamba2_7b)}


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
           "REGISTRY", "get_config", "smoke_config"]
