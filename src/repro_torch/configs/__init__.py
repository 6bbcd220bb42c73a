"""Architecture registry of the port: ``--arch <id>`` resolution, and the
canonical input shapes (``--shape <name>``).

The registry holds all eleven of the JAX package's archs: llama3.2-1b,
llama3.2-3b, yi-34b, nemotron-4-340b and gpt3-xl (dense decoders: RoPE,
RMSNorm and SwiGLU at head_dim 64, 128 and 192; learned positions,
LayerNorm and tanh GELU), internvl2-1b (VLM: the dense decoder behind a
prefix of patch embeddings), granite-moe-1b-a400m and
llama4-scout-17b-a16e (MoE; the latter with local/global attention),
seamless-m4t-medium (encoder-decoder: a bidirectional encoder over
stubbed frame embeddings, a decoder with cross-attention to its output),
mamba2-370m (SSM) and zamba2-7b (hybrid: Mamba2 and a shared attention
block).  ``ASSIGNED`` lists the ten assigned archs in the reference's
order (gpt3-xl is the paper's extra case study) and ``ASSIGNED_SHAPES``
the four assigned shapes; :func:`all_cells` walks their 40-cell grid and
:func:`cell_is_runnable` says which cells run and why not.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Tuple

from . import (gpt3_xl, granite_moe_1b_a400m, internvl2_1b, llama3_2_1b,
               llama3_2_3b, llama4_scout_17b_a16e, mamba2_370m,
               nemotron_4_340b, seamless_m4t_medium, yi_34b, zamba2_7b)
from .base import (ModelConfig, MoEConfig, SSMConfig, ShapeConfig,
                   config_summary, smoke_config)
from .shapes import (DECODE_32K, LONG_500K, PAPER_GPT3XL, PREFILL_32K, SHAPES,
                     TRAIN_4K, get_shape, smoke_shape)

# the reference's order
_MODULES = (llama3_2_3b, nemotron_4_340b, llama3_2_1b, yi_34b,
            granite_moe_1b_a400m, llama4_scout_17b_a16e,
            seamless_m4t_medium, internvl2_1b, mamba2_370m, zamba2_7b,
            gpt3_xl)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                    for m in _MODULES}

#: the ten assigned architectures (gpt3-xl is the paper's extra case study)
ASSIGNED: List[str] = [m.CONFIG.name for m in _MODULES
                       if m.CONFIG.name != "gpt3-xl"]

#: the canonical assigned shapes (paper_gpt3xl is extra)
ASSIGNED_SHAPES: List[str] = ["train_4k", "prefill_32k", "decode_32k",
                              "long_500k"]


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")


def cell_is_runnable(cfg: ModelConfig,
                     shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and if not, why.

    ``long_500k`` needs sub-quadratic attention: it runs for the SSM and
    hybrid archs and for chunked-local-attention archs (llama4-scout); it
    is skipped for pure full-attention archs."""
    if shape.name.startswith("long_") and not cfg.subquadratic:
        return False, (f"{cfg.name} is pure full-attention (O(S^2)); "
                       f"{shape.name} requires sub-quadratic attention")
    return True, ""


def all_cells(include_skipped: bool = False):
    """Yield (arch_id, shape_name, runnable, reason) for the 40-cell grid
    of ``ASSIGNED`` x ``ASSIGNED_SHAPES``."""
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for sname in ASSIGNED_SHAPES:
            ok, why = cell_is_runnable(cfg, get_shape(sname))
            if ok or include_skipped:
                yield arch, sname, ok, why


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
           "REGISTRY", "ASSIGNED", "ASSIGNED_SHAPES", "SHAPES", "get_config",
           "get_shape", "smoke_config", "smoke_shape", "card_smoke_config",
           "cell_is_runnable", "all_cells", "config_summary", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K", "PAPER_GPT3XL"]
