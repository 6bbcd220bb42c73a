"""nemotron-4-340b — GQA, squared-ReLU MLP [arXiv:2402.16819; unverified].

A copy of the JAX package's ``configs/nemotron_4_340b.py``: 96 query heads
over 8 KV heads at head_dim 192 (12 query heads per KV head), LayerNorm,
a non-gated squared-ReLU MLP.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    activation="relu2",      # squared ReLU, non-gated MLP (2 matrices)
    norm="layer",            # nemotron uses LayerNorm
    positional="rope",
    rope_theta=10000.0,
    source="[arXiv:2402.16819; unverified]",
)
