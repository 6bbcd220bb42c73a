"""Flash-attention backward: the Hopper kernels ``csrc/flash_backward.cu``
and their plain PyTorch version.

Counterpart of the JAX package's ``kernels/flash_attention/backward.py``
(``flash_attention_bwd``: the dQ and dK/dV ``pallas_call``s) together with
the GQA sum of ``ops.py:_fa_train_bwd``.  Layout is the model's: q, o, dO
``(B, Sq, H, D)``, k, v ``(B, Sk, KV, D)`` with ``H % KV == 0`` (query head
``h`` reads KV head ``h // G``), lse ``(B, H, Sq)`` f32 from the forward
(``flash_prefill(..., return_lse=True)``).  Returns (dq, dk, dv) in the
dtypes of q, k, v; dK and dV are summed over each KV head's group.
"""
from __future__ import annotations

import torch

from .. import _build


def flash_attention_bwd_ref(q, k, v, o, do, lse, causal: bool = True,
                            window: int = 0):
    """Plain version, the kernels' oracle: the flash recipe in f32.  P is
    recomputed from the saved lse, ``delta = rowsum(dO * O)``,
    ``dS = P * (dP - delta)``; q is scaled in f32, as the TPU backward
    scales it."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qs = q.float().reshape(B, Sq, KV, G, D) * scale
    dof = do.float().reshape(B, Sq, KV, G, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, kf)
    diff = torch.arange(Sq, device=q.device)[:, None] \
        - torch.arange(Sk, device=q.device)[None, :]
    valid = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        valid &= diff >= 0
    if window > 0:
        valid &= diff < window
    p = torch.where(valid, torch.exp(s - lse.reshape(B, KV, G, Sq, 1)), 0.0)
    delta = (dof * o.float().reshape(B, Sq, KV, G, D)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qs)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q, k, v, o, do, lse, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of attention at the saved (o, lse).  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernels (one count in
    ``flash_attention_bwd.launches`` per call: the delta pre-pass, dQ and
    dK/dV), built for bf16 and head_dim 64 only, and launched only for
    what the training path gives it and the card's check covers: causal,
    no window, Sq == Sk."""
    _build.refuse_grad("flash_attention_bwd", q, k, v, o, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal, window)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % KV \
            or o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: bad shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} o "
                         f"{tuple(o.shape)} do {tuple(do.shape)} lse "
                         f"{tuple(lse.shape)}")
    if not q.dtype == k.dtype == v.dtype == o.dtype == do.dtype \
            == torch.bfloat16:
        raise TypeError(f"flash_attention_bwd kernel is built for bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {o.dtype}, "
                        f"{do.dtype}")
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: lse must be float32, got "
                        f"{lse.dtype}")
    if D != 64:
        raise ValueError(f"flash_attention_bwd kernel is built for head_dim "
                         f"64, got {D}")
    if not causal or window or Sq != Sk:
        raise NotImplementedError(
            f"flash_attention_bwd kernel: causal={causal} window={window} "
            f"Sq={Sq} Sk={Sk} is not on the training path (causal, window "
            f"0, Sq == Sk)")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _build.require_cuda("flash_attention_bwd", q, k, v, o, do, lse, delta,
                        dq, dk, dv)
    lib = _build.library()
    _build.check(lib.flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, D, int(causal),
        int(window), _build.dtype_code(q), _build.stream_handle(q)),
        "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
