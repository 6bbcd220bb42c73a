"""llama4-scout-17b-a16e — MoE 16e top-1, early fusion, iRoPE chunked
attention [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

A copy of the JAX package's ``configs/llama4_scout_17b_a16e.py``: chunked
local attention (window 8192) on 3 of every 4 layers with a global layer
every 4th (iRoPE); 40 query heads over 8 KV heads at head_dim 128 (5 query
heads per KV head); 16 experts, top-1, with a shared expert.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    activation="swiglu",
    norm="rms",
    positional="rope",
    rope_theta=500000.0,
    attn_window=8192,
    global_attn_every=4,
    moe=MoEConfig(n_experts=16, top_k=1, capacity_factor=1.25,
                  shared_expert=True),
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
