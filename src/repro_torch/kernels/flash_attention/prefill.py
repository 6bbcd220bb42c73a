"""Prefill flash attention with per-row valid lengths: the Hopper kernel
``csrc/flash_prefill.cu`` and its plain PyTorch version.

Counterpart of the JAX package's ``kernels/flash_attention/kernel.py``
(``flash_attention_fwd``) extended by what serving prefill computes there
(``models/common.py:chunked_attention`` with ``kv_valid_len``): batch rows
are right-padded to one bucket and row ``b`` masks its keys at positions
``>= kv_valid_len[b]``.  With every row at full length it is the TPU
kernel's function.  Layout is the model's: q ``(B, Sq, H, D)``, k/v
``(B, Sk, KV, D)`` with ``H % KV == 0`` (GQA reads KV head ``h // G``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build

NEG_INF = -1e30


def flash_prefill_ref(q, k, v, kv_valid_len: Optional[torch.Tensor] = None,
                      *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_offset: int = 0,
                      block_k: int = 1024) -> torch.Tensor:
    """Plain version: online softmax over ``block_k`` key blocks, the f32
    statistics and the activation-dtype softmax weights of the reference's
    ``chunked_attention``.  Keys masked by the causal, window or
    valid-length rule get weight 0."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    # the reference scales q in its own dtype before the f32 products
    qr = (q.reshape(B, Sq, KV, G, D) * (D ** -0.5)).float()
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
        valid = valid[None]                                  # (1, Sq, bk)
        if vl is not None:
            valid = valid & (k_pos[None, :] < vl[:, None])[:, None, :]
        valid = valid[:, None, None]                         # (B|1,1,1,Sq,bk)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
        p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(m <= NEG_INF, 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype).float(), vblk)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    l = torch.clamp(l, min=1e-20).permute(0, 3, 1, 2)[..., None]
    return (acc / l).reshape(B, Sq, H, D).to(q.dtype)


def flash_prefill(q, k, v, kv_valid_len: Optional[torch.Tensor] = None, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  q_offset: int = 0, block_k: int = 1024) -> torch.Tensor:
    """Prefill attention, (B, Sq, H, D).  A CPU tensor takes the plain
    version (``block_k`` sets its key block); a CUDA tensor launches the
    kernel (``flash_prefill.launches`` counts them), which reads q/k/v
    through their strides and supports bf16, head_dim 64 and
    ``q_offset == 0`` only."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, kv_valid_len, causal=causal,
                                 window=window, softcap=softcap,
                                 q_offset=q_offset, block_k=block_k)
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
    if D != 64:
        raise ValueError(f"flash_prefill kernel is built for head_dim 64, "
                         f"got {D}")
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
    _build.require_cuda("flash_prefill", q, k, v, kv_valid_len, out)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _build.library()
    _build.check(lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid_len.data_ptr(),
        out.data_ptr(), B, Sq, Sk, H, KV, D, *strides, int(causal),
        int(window), float(softcap), _build.dtype_code(q),
        _build.stream_handle(q)), "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
