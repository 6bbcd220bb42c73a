"""Flash-attention backward: the Hopper kernels ``csrc/flash_backward.cu``
and their plain PyTorch version.

Counterpart of the JAX package's ``kernels/flash_attention/backward.py``
(``flash_attention_bwd``: the dQ and dK/dV ``pallas_call``s) together with
the GQA sum of ``ops.py:_fa_train_bwd``.  Layout is the model's: q, o, dO
``(B, Sq, H, D)``, k, v ``(B, Sk, KV, D)`` with ``H % KV == 0`` (query head
``h`` reads KV head ``h // G``), lse ``(B, H, Sq)`` f32 from the forward
(``flash_prefill(..., return_lse=True)``).  Returns (dq, dk, dv) in the
dtypes of q, k, v; dK and dV are summed over each KV head's group.  q is
scaled as the forward scales it (``prefill.query_scale``): in its own
dtype by ``D ** -0.5`` rounded to that dtype.
"""
from __future__ import annotations

import torch

from .. import _build
from .prefill import query_scale

#: (head_dim, query heads per KV head) the backward is built for, the
#: training paths': head_dim 64 at any group (llama3.2-1b, granite-moe,
#: internvl2-1b), 128 with 1, 3, 5 and 7 (gpt3-xl, llama3.2-3b,
#: llama4-scout-17b-a16e, yi-34b) and 224 with 1 (zamba2-7b's shared
#: block).  The forward's ``prefill.KERNEL_CASES`` also holds (192, 12),
#: nemotron-4-340b's, which no path trains at full width.
KERNEL_CASES = ((64, 0), (128, 1), (224, 1), (128, 3), (128, 5), (128, 7))


def flash_attention_bwd_ref(q, k, v, o, do, lse, causal: bool = True,
                            window: int = 0):
    """Plain version, the kernels' oracle: the flash recipe in f32.  P is
    recomputed from the saved lse, ``delta = rowsum(dO * O)``,
    ``dS = P * (dP - delta)``.  q is scaled as the forward scales it, in
    its own dtype by the factor rounded to that dtype (the reference's
    jnp attention, which its training differentiates): that scaled q
    enters the scores and dK, and dQ is scaled by the same factor (exact
    at head_dim 64, where the factor is 2^-3; not at 128 or 224)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = query_scale(D, q.dtype)
    qs = (q * scale).float().reshape(B, Sq, KV, G, D)
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
    ``flash_attention_bwd.launches`` per call: the pre-pass, dQ and
    dK/dV), built for bf16 at head_dim 64 (any group), at head_dim 128
    and 224 with one query head per KV head and at head_dim 128 with 3,
    5 and 7 (``KERNEL_CASES``), and launched only
    for what the training paths give it and the card's check covers:
    causal at Sq == Sk (a decoder's self-attention), with a local window
    or not (llama4-scout-17b-a16e's local layers), or non-causal without
    one at any Sq and Sk (an encoder's self-attention; a decoder's
    cross-attention, Sq text positions over Sk encoder frames).  At
    head_dim 128 and 224 the pre-pass also writes the scaled q to a scratch
    that the wrapper allocates."""
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
    if not any(D == d and (g == 0 or H == g * KV) for d, g in KERNEL_CASES):
        raise ValueError(f"flash_attention_bwd kernel is built for head_dim "
                         f"64 and for head_dim 128 and 224 with one query "
                         f"head per KV head, and head_dim 128 with 3, 5 "
                         f"and 7, got D={D}, H={H}, KV={KV}")
    if (causal and Sq != Sk) or (window and not causal):
        raise NotImplementedError(
            f"flash_attention_bwd kernel: causal={causal} window={window} "
            f"Sq={Sq} Sk={Sk} is not on the training path (causal at "
            f"Sq == Sk, with a window or not; or non-causal, no window)")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # the scaled q, written by the pre-pass where the scale is not exact
    qs = None if D == 64 else torch.empty_like(q)
    _build.require_cuda("flash_attention_bwd", q, k, v, o, do, lse, delta,
                        dq, dk, dv, *([] if qs is None else [qs]))
    lib = _build.library()
    _build.check(lib.flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if qs is None else qs.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, D, int(causal),
        int(window), _build.dtype_code(q), _build.stream_handle(q)),
        "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
