"""The four canonical input shapes assigned to the LM-transformer pool (the
port's copy of the JAX package's ``configs/shapes.py``)."""
from __future__ import annotations

from .base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4096, global_batch=256,
                       kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32768, global_batch=128,
                         kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524288, global_batch=1,
                        kind="decode")

# The paper's own case-study shape (GPT-3-xl, seq 1024, batch 40).
PAPER_GPT3XL = ShapeConfig(name="paper_gpt3xl", seq_len=1024, global_batch=40,
                           kind="train")

SHAPES = {s.name: s for s in
          (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, PAPER_GPT3XL)}


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")


def smoke_shape(shape: ShapeConfig) -> ShapeConfig:
    """Reduced shape for CPU smoke tests."""
    return ShapeConfig(name=shape.name + "-smoke",
                       seq_len=min(shape.seq_len, 64),
                       global_batch=min(shape.global_batch, 2),
                       kind=shape.kind)
