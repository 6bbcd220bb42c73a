"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81 Mamba2 blocks; a single *shared* attention+MLP block (weights reused) is
applied every 6 blocks on concat(hidden, embedding) (zamba2-style).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,             # shared block uses MHA
    d_ff=14336,
    vocab_size=32000,
    head_dim=0,                # shared block works on concat(h, emb): 2*3584
                               # = 7168 -> head_dim 224 (see models/hybrid.py)
    activation="gelu",
    norm="rms",
    positional="rope",
    rope_theta=10000.0,
    attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=2,
                  conv_width=4, chunk_size=256),
    source="[arXiv:2411.15242; unverified]",
)
