"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=0,                    # no MLP: mamba2 blocks only
    vocab_size=50280,
    activation="swiglu",
    norm="rms",
    positional="none",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk_size=256),
    source="[arXiv:2405.21060; unverified]",
)
