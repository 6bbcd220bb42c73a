"""Model registry of the port: config -> model instance (the dense, MoE and
VLM decoders, the encoder-decoder, the SSM family and the hybrid)."""
from __future__ import annotations

from ..configs.base import ModelConfig
from .encdec import EncDecLM
from .hybrid import HybridLM
from .ssm import MambaLM
from .transformer import DecoderLM


def build_model(cfg: ModelConfig, block_k: int = 1024, device="cuda"):
    """Instantiate the model implementation for a config on ``device``
    (``block_k``, the plain attention's key block, is the decoders', the
    encoder's and the hybrid's shared block's: the SSM family has no
    attention)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, block_k=block_k, device=device)
    if cfg.family == "encdec":
        return EncDecLM(cfg, block_k=block_k, device=device)
    if cfg.family == "ssm":
        return MambaLM(cfg, device=device)
    if cfg.family == "hybrid":
        return HybridLM(cfg, block_k=block_k, device=device)
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP.md "
        f"queue 1)")


__all__ = ["build_model", "DecoderLM", "EncDecLM", "HybridLM", "MambaLM"]
