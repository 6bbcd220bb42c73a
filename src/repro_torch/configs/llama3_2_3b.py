"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-3B; unverified].

A copy of the JAX package's ``configs/llama3_2_3b.py`` with its source
named for the 3B model (the reference names the 1B one; the shapes are the
3B's published config).  As in the reference there is no llama3 RoPE
scaling: plain RoPE at theta 500000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    activation="swiglu",
    norm="rms",
    positional="rope",
    rope_theta=500000.0,
    tie_embeddings=True,
    source="[hf:meta-llama/Llama-3.2-3B; unverified]",
)
