"""yi-34b — llama-arch GQA [arXiv:2403.04652; hf].

A copy of the JAX package's ``configs/yi_34b.py``: 56 query heads over 8
KV heads at head_dim 128 (7 query heads per KV head).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    activation="swiglu",
    norm="rms",
    positional="rope",
    rope_theta=5000000.0,
    source="[arXiv:2403.04652; hf]",
)
