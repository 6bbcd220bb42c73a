"""Gradient utilities: accumulation and bf16 compression.

The port of the JAX package's ``train/grad.py``.  ``compress_grads`` rounds
f32 gradients to bf16 stochastically (unbiased) with error feedback, to
halve the bytes of a data-parallel all-reduce; its random bits come from an
explicit ``torch.Generator``, so a run is reproducible from its seed (they
are not the JAX package's bits: compare distributions, not values).
"""
from __future__ import annotations

import torch

from ..tree import leaves, map_tree, unflatten_like

_LOW16 = (1 << 16) - 1


def _stochastic_round_bf16(x: torch.Tensor,
                           generator: torch.Generator) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding: add 16 random low bits to the
    f32 pattern, then truncate to its upper 16 bits."""
    bits = x.float().contiguous().view(torch.int32)
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                          dtype=torch.int32, device=x.device)
    rounded = (bits + noise) & ~_LOW16
    return rounded.view(torch.float32).to(torch.bfloat16)


def compress_grads(grads, generator: torch.Generator, error_buf=None):
    """Compress f32 grads to bf16 with error feedback.

    Returns (compressed, new_error_buf).  ``error_buf`` carries the residual
    ``g + e - compressed`` into the next step, so that the quantization is
    unbiased over time.
    """
    gl = leaves(grads)
    el = [None] * len(gl) if error_buf is None else leaves(error_buf)
    comp, err = [], []
    for g, e in zip(gl, el):
        corrected = g.float() if e is None else g.float() + e
        c = _stochastic_round_bf16(corrected, generator)
        comp.append(c)
        err.append(corrected - c.float())
    return unflatten_like(grads, comp), unflatten_like(grads, err)


def decompress_grads(grads):
    return map_tree(lambda g: g.float(), grads)


@torch.no_grad()
def accumulate(acc, grads, scale: float = 1.0):
    """acc += grads * scale, in place (f32 accumulator); returns acc."""
    for a, g in zip(leaves(acc), leaves(grads)):
        a.add_(g.float() * scale)
    return acc


def zeros_like_f32(tree):
    return map_tree(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)
