"""Architecture registry of the port: ``--arch <id>`` resolution.

The registry holds the archs whose model family the port has: llama3.2-1b
(dense decoder) and mamba2-370m (SSM); the JAX package's other archs join
as their model families are ported (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

from . import llama3_2_1b, mamba2_370m
from .base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, smoke_config

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (llama3_2_1b, mamba2_370m)}


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
           "REGISTRY", "get_config", "smoke_config"]
