"""Paged single-token decode attention: the Hopper kernel
``csrc/paged_decode.cu`` and its plain PyTorch version.

Counterpart of the JAX package's ``kernels/flash_attention/paged.py``
(``paged_flash_decode``) and of its oracle ``ref.py:paged_attention_ref``.
The KV cache lives in a shared page pool ``(P, page, KV, D)``; slot ``b``'s
row of the block table names the page holding positions
``[j * page, (j + 1) * page)``.  Unallocated entries point at the parking
page 0, whose keys lie past ``pos`` and are masked.  With ``k_scales`` /
``v_scales`` ``(P, KV)`` float32 the pools hold int8 or fp8-e4m3 values,
dequantized by one scale per (page, KV head).
"""
from __future__ import annotations

import torch

from .. import _build

NEG_INF = -1e30
#: keys of one slot that one block of the decode kernel covers (rounded
#: down to whole pages, at least one page); 128 was the fastest of 64, 128
#: and 256 on an H100 (``tools/torch_kernel_ab.py --keys-per-split``)
KEYS_PER_SPLIT = 128
#: what the kernel is built for: head_dim and query heads per KV head of
#: llama3.2-1b (every pool type below) ...
KERNEL_HEAD_DIM, KERNEL_GROUP = 64, 4
#: ... and of zamba2-7b's shared attention block (bf16 and int8 pools)
WIDE_HEAD_DIM, WIDE_GROUP = 224, 1

_POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8,
                torch.float8_e4m3fn)


def gather_pages(pages, block_tables, scales=None) -> torch.Tensor:
    """Each slot's pages as one contiguous float32 ``(B, nb * page, KV, D)``
    copy (the copy the kernel avoids), dequantized by ``scales`` (P, KV)."""
    B, nb = block_tables.shape
    tables = block_tables.long()
    g = pages[tables].float()                         # (B, nb, page, KV, D)
    if scales is not None:
        g = g * scales[tables][:, :, None, :, None]
    return g.reshape((B, nb * pages.shape[1]) + tuple(pages.shape[2:]))


def split_plan(nb: int, page: int, keys_per_split: int = KEYS_PER_SPLIT):
    """(keys per split, number of splits) of the decode kernel's key axis
    over a block table of ``nb`` pages of ``page`` keys.  A split covers a
    whole number of pages; the count depends on the table's width alone,
    never on the positions (they live on the device), so the kernel's grid
    is the same at every decode step.  ``csrc/paged_decode.cu`` computes
    the same count."""
    kps = page * max(1, keys_per_split // page)
    return kps, -(-nb * page // kps)


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype`` and contiguous, with no conversion call when it
    already is (the wrapper runs 16 times an eager decode step, which is
    host-bound)."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t.contiguous()


def paged_attention_ref(q, k_pages, v_pages, block_tables, pos, *,
                        window: int = 0, softcap: float = 0.0,
                        k_scales=None, v_scales=None) -> torch.Tensor:
    """Plain version: gathers each slot's pages, then a float32 softmax.
    Returns (B, 1, H, D)."""
    B, _, H, D = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    G = H // KV
    nb = block_tables.shape[1]
    k = gather_pages(k_pages, block_tables, k_scales)
    v = gather_pages(v_pages, block_tables, v_scales)
    qr = q.reshape(B, KV, G, D).float() * (D ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qr, k)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(nb * page, device=q.device)[None, :]
    valid = k_pos <= pos[:, None]
    if window > 0:
        valid &= k_pos > (pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, 1, H, D).to(q.dtype)


def paged_flash_decode(q, k_pages, v_pages, block_tables, pos, *,
                       window: int = 0, softcap: float = 0.0,
                       k_scales=None, v_scales=None) -> torch.Tensor:
    """q: (B, 1, H, D); pools (P, page, KV, D); block_tables (B, nb) int32
    page ids; pos (B,) int32.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel and its combine pass, counted as one launch
    (``paged_flash_decode.launches``).  Returns (B, 1, H, D) in q's dtype.
    Serving only, not differentiable: an input that requires grad under
    grad mode raises, on either device."""
    _build.refuse_grad("paged_flash_decode", q, k_pages, v_pages, k_scales,
                       v_scales)
    if q.is_cpu:
        return paged_attention_ref(q, k_pages, v_pages, block_tables, pos,
                                   window=window, softcap=softcap,
                                   k_scales=k_scales, v_scales=v_scales)
    return launch_split(q, k_pages, v_pages, block_tables, pos, window,
                        softcap, k_scales, v_scales, KEYS_PER_SPLIT)


def launch_split(q, k_pages, v_pages, block_tables, pos, window, softcap,
                 k_scales, v_scales, keys_per_split) -> torch.Tensor:
    """The kernel and its combine pass with splits of ``keys_per_split``
    keys: ``paged_flash_decode`` passes ``KEYS_PER_SPLIT``, and
    ``tools/torch_kernel_ab.py`` times other sizes through this function.
    Raises on what the kernel is not built for."""
    B, one, H, D = q.shape
    P, page, KV, Dk = k_pages.shape
    nb = block_tables.shape[1]
    if one != 1 or Dk != D or v_pages.shape != k_pages.shape or H % KV \
            or block_tables.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"paged_flash_decode: bad shapes q {tuple(q.shape)}"
                         f" pages {tuple(k_pages.shape)} tables "
                         f"{tuple(block_tables.shape)} pos {tuple(pos.shape)}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged_flash_decode kernel is built for bf16 q, "
                        f"got {q.dtype}")
    if k_pages.dtype not in _POOL_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_flash_decode kernel: pool dtype "
                        f"{k_pages.dtype}/{v_pages.dtype} not supported")
    quantized = k_pages.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized != (k_scales is not None) or \
            (k_scales is None) != (v_scales is None):
        raise ValueError("paged_flash_decode: int8/fp8 pools need k_scales "
                         "and v_scales, other pools take none")
    if (D, H) not in ((KERNEL_HEAD_DIM, KERNEL_GROUP * KV),
                      (WIDE_HEAD_DIM, WIDE_GROUP * KV)):
        raise ValueError(f"paged_flash_decode kernel is built for head_dim "
                         f"{KERNEL_HEAD_DIM} with {KERNEL_GROUP} query heads "
                         f"per KV head and head_dim {WIDE_HEAD_DIM} with "
                         f"{WIDE_GROUP}, got D={D}, H={H}, KV={KV}")
    if D == WIDE_HEAD_DIM and k_pages.dtype not in (torch.bfloat16,
                                                    torch.int8):
        raise TypeError(f"paged_flash_decode kernel at head_dim "
                        f"{WIDE_HEAD_DIM} is built for bf16 and int8 pools, "
                        f"got {k_pages.dtype}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_flash_decode: page pools must be contiguous")
    q = q.contiguous()
    tables = _as(block_tables, torch.int32)
    pos = _as(pos, torch.int32)
    tensors = [q, k_pages, v_pages, tables, pos]
    if quantized:
        k_scales = _as(k_scales, torch.float32)
        v_scales = _as(v_scales, torch.float32)
        if k_scales.shape != (P, KV) or v_scales.shape != (P, KV):
            raise ValueError(f"paged_flash_decode: scales must be {(P, KV)}")
        tensors += [k_scales, v_scales]
    kps, n_split = split_plan(nb, page, keys_per_split)
    out = torch.empty_like(q)
    # per (slot, KV head, split): running max and sum of each query row,
    # then its (rows, D) accumulator, all f32
    work = torch.empty(B * KV * n_split * (H // KV) * (D + 2),
                       dtype=torch.float32, device=q.device)
    _build.require_cuda("paged_flash_decode", out, work, *tensors)
    lib = _build.library()
    _build.check(lib.paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), pos.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None, work.data_ptr(),
        out.data_ptr(), B, H, KV, D, page, nb, kps, int(window),
        float(softcap), _build.dtype_code(q), _build.dtype_code(k_pages),
        _build.stream_handle(q)), "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
