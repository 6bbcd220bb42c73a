"""granite-moe-1b-a400m — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

A copy of the JAX package's ``configs/granite_moe_1b_a400m.py``.  As in the
reference, the model has none of Granite's embedding, attention, residual
or logit multipliers: a plain decoder whose MLPs are the MoE layer.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    activation="swiglu",
    norm="rms",
    positional="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, capacity_factor=1.25,
                  shared_expert=False),
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)
