"""Prefill flash attention with per-row valid lengths: the Hopper kernel
``csrc/flash_prefill.cu`` and its plain PyTorch version.

Counterpart of the JAX package's ``kernels/flash_attention/kernel.py``
(``flash_attention_fwd``) extended by what serving prefill computes there
(``models/common.py:chunked_attention`` with ``kv_valid_len``): batch rows
are right-padded to one bucket and row ``b`` masks its keys at positions
``>= kv_valid_len[b]``.  With every row at full length it is the TPU
kernel's function.  Layout is the model's: q ``(B, Sq, H, D)``, k/v
``(B, Sk, KV, D)`` with ``H % KV == 0`` (GQA reads KV head ``h // G``).
With ``return_lse`` it also returns the f32 log-sum-exp ``(B, H, Sq)``
that the TPU kernel writes with ``return_lse=True`` and the training
backward reads (``ops.flash_attention_train``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build

NEG_INF = -1e30
#: (head_dim, query heads per KV head) the kernel is built for: llama3.2-1b's
#: head_dim 64 at any group (its serving and training paths), and
#: zamba2-7b's shared attention block, head_dim 224 with one query head per
#: KV head (group 0: any)
KERNEL_CASES = ((64, 0), (224, 1))


def query_scale(D: int, dtype: torch.dtype) -> float:
    """The factor ``D ** -0.5`` as the reference applies it to q: JAX
    multiplies q by a weak-typed Python float, which it first rounds to q's
    dtype, then rounds the product once.  In bf16 the factor is not exact
    unless D is a power of four (bf16(224 ** -0.5) = 0.06689453 against
    0.06681531); in f32 this is the f32 factor PyTorch would use anyway."""
    return float(torch.tensor(D ** -0.5, dtype=dtype))


def flash_prefill_ref(q, k, v, kv_valid_len: Optional[torch.Tensor] = None,
                      *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_offset: int = 0,
                      block_k: int = 1024, return_lse: bool = False):
    """Plain version: the reference's ``chunked_attention`` step for step
    (online softmax over ``block_k`` key blocks, f32 statistics, softmax
    weights rounded to the activation dtype before PV).  As there, a key
    past a row's valid length gets the score -1e30 while the weights are
    zeroed by the causal/window mask only, so a padded row with no valid
    key averages the values that mask admits."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    # the reference scales q in its own dtype before the f32 products
    qr = (q.reshape(B, Sq, KV, G, D) * query_scale(D, q.dtype)).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)
    vl = None if kv_valid_len is None else kv_valid_len.to(dev)
    bk = min(block_k, Sk)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32, device=dev)
    for start in range(0, Sk, bk):
        kblk = k[:, start:start + bk].float()
        vblk = v[:, start:start + bk].float()
        k_pos = start + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qr, kblk)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        diff = q_pos[:, None] - k_pos[None, :]
        valid = torch.ones_like(diff, dtype=torch.bool)
        if causal:
            valid &= diff >= 0
        if window > 0:
            valid &= diff < window
        if vl is not None:
            in_len = k_pos[None, :] < vl[:, None]                # (B, bk)
            s = torch.where(in_len[:, None, None, None, :], s, NEG_INF)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe, NEG_INF))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype).float(), vblk)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    l = torch.clamp(l, min=1e-20)
    out = (acc / l.permute(0, 3, 1, 2)[..., None]).reshape(B, Sq, H, D) \
        .to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(m <= NEG_INF, 0.0, m) + torch.log(l)
    return out, lse.reshape(B, H, Sq)


def flash_prefill(q, k, v, kv_valid_len: Optional[torch.Tensor] = None, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  q_offset: int = 0, block_k: int = 1024,
                  return_lse: bool = False):
    """Prefill attention, (B, Sq, H, D), and with ``return_lse`` the f32
    log-sum-exp (B, H, Sq) too.  A CPU tensor takes the plain version
    (``block_k`` sets its key block); a CUDA tensor launches the kernel
    (``flash_prefill.launches`` counts them), which reads q/k/v through
    their strides and supports bf16 and ``q_offset == 0`` only, at head_dim
    64 or at head_dim 224 with one query head per KV head
    (``KERNEL_CASES``).  When grad mode is on and an input requires grad,
    the call goes through ``ops.flash_attention_train`` (the forward with
    its log-sum-exp,
    then the flash backward), which covers what the reference's training
    kernels cover: no softcap, no ``q_offset``, no ``kv_valid_len``; any
    other differentiable call raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if softcap or q_offset or kv_valid_len is not None or return_lse:
            raise RuntimeError(
                "flash_prefill is not differentiable with softcap, q_offset, "
                "kv_valid_len or return_lse (the flash backward covers none "
                "of them)")
        from .ops import flash_attention_train      # ops imports this module
        return flash_attention_train(q, k, v, causal, window, block_k)
    return _forward(q, k, v, kv_valid_len, causal=causal, window=window,
                    softcap=softcap, q_offset=q_offset, block_k=block_k,
                    return_lse=return_lse)


def _forward(q, k, v, kv_valid_len, *, causal, window, softcap=0.0,
             q_offset=0, block_k=1024, return_lse=False):
    """The plain version on a CPU tensor, else one launch of the kernel."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, kv_valid_len, causal=causal,
                                 window=window, softcap=softcap,
                                 q_offset=q_offset, block_k=block_k,
                                 return_lse=return_lse)
    if q_offset:
        raise NotImplementedError("flash_prefill kernel: q_offset != 0 is "
                                  "not on the serving path")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or H % KV:
        raise ValueError(f"flash_prefill: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"flash_prefill kernel is built for bf16 q, k, v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not any(D == d and (g == 0 or H == g * KV) for d, g in KERNEL_CASES):
        raise ValueError(f"flash_prefill kernel is built for head_dim 64 "
                         f"and for head_dim 224 with one query head per KV "
                         f"head, got D={D}, H={H}, KV={KV}")
    vec = 16 // q.element_size()
    tensors = []
    for t in (q, k, v):
        if t.stride(3) != 1 or any(t.stride(i) % vec for i in range(3)):
            t = t.contiguous()
        tensors.append(t)
    q, k, v = tensors
    if kv_valid_len is None:
        kv_valid_len = torch.full((B,), Sk, dtype=torch.int32,
                                  device=q.device)
    kv_valid_len = kv_valid_len.to(torch.int32).contiguous()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    _build.require_cuda("flash_prefill", q, k, v, kv_valid_len, out)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _build.library()
    _build.check(lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid_len.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), B, Sq, Sk,
        H, KV, D, *strides, int(causal), int(window), float(softcap),
        _build.dtype_code(q), _build.stream_handle(q)), "flash_prefill")
    flash_prefill.launches += 1
    return (out, lse) if return_lse else out


flash_prefill.launches = 0
