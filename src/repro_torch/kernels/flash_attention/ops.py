"""Differentiable flash attention for training: the counterpart of the JAX
package's ``kernels/flash_attention/ops.py:flash_attention_train`` (a
``custom_vjp``), here a ``torch.autograd.Function``.

The forward is the prefill attention kernel with its log-sum-exp output
(``prefill.flash_prefill(..., return_lse=True)``) and saves (q, k, v, o,
lse); the backward is the flash backward (``backward.flash_attention_bwd``),
which recomputes the tile probabilities from them.  On CPU tensors both
take their plain versions, so the CPU tests run this same ``Function``.
No softcap, as in the reference; GQA reads KV head ``h // G`` in both
directions, with no repeat.  ``prefill.flash_prefill`` comes here for a
call that needs a gradient.
"""
from __future__ import annotations

import torch

from . import prefill
from .backward import flash_attention_bwd


class _FlashAttentionTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, block_k: int):
        o, lse = prefill._forward(q, k, v, None, causal=causal,
                                  window=window, block_k=block_k,
                                  return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, causal: bool = True, window: int = 0,
                          block_k: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  Returns (B, Sq, H, D),
    differentiable in q, k and v; ``block_k`` is the plain version's key
    block.  A call that needs no gradient skips the ``Function`` and its
    log-sum-exp."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionTrain.apply(q, k, v, causal, window, block_k)
    return prefill._forward(q, k, v, None, causal=causal, window=window,
                            block_k=block_k)
