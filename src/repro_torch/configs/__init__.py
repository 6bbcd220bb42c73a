"""Architecture registry of the port: ``--arch <id>`` resolution.

The port serves the dense decoder family first, so the registry holds
llama3.2-1b only; the JAX package's other archs join as their model
families are ported (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

from . import llama3_2_1b
from .base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, smoke_config

REGISTRY: Dict[str, ModelConfig] = {llama3_2_1b.CONFIG.name:
                                    llama3_2_1b.CONFIG}


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
           "REGISTRY", "get_config", "smoke_config"]
