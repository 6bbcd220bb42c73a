"""internvl2-1b — InternViT + Qwen2-0.5B backbone [arXiv:2404.16821; hf].

A copy of the JAX package's ``configs/internvl2_1b.py``.  The ViT frontend
is a stub, as there: a request or a batch carries precomputed patch
embeddings (``patch_embeds``, (B, vision_prefix_len, d_model)), which the
decoder places before the token embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    activation="swiglu",
    norm="rms",
    positional="rope",
    rope_theta=1000000.0,
    tie_embeddings=True,
    vision_prefix_len=256,      # stubbed ViT patch embeddings per image
    source="[arXiv:2404.16821; hf]",
)
