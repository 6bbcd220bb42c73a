"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596; hf].

A copy of the JAX package's ``configs/seamless_m4t_medium.py``.  The
speech/text frontend is a stub, as there: a request or a batch carries
precomputed frame embeddings (``frames``, (B, encoder_frontend_len,
d_model)) for the encoder; the transformer backbone (12 encoder and 12
decoder layers) is implemented in full.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,              # MHA
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    activation="gelu",
    norm="layer",
    positional="learned",
    encoder_frontend_len=1024,  # stubbed audio frames per sample
    max_train_seq=40960,        # learned-pos table must cover decode_32k
    source="[arXiv:2308.11596; hf]",
)
