"""gpt3-xl — the paper's case-study model (GPT-3 1.3B) [arXiv:2005.14165].

24 layers, hidden 2048, 16 heads, seq fixed to 1024, default batch 40
(paper §4).  GELU MLP, LayerNorm, learned positions — the GPT-2/3 recipe
llm.c implements.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gpt3-xl",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,             # MHA
    d_ff=8192,                 # 4 * d_model
    vocab_size=50257,
    head_dim=128,
    activation="gelu",
    norm="layer",
    positional="learned",
    max_train_seq=2048,
    source="[arXiv:2005.14165]",
)
