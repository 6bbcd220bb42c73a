"""Fused RMSNorm: the Hopper kernel ``csrc/rmsnorm.cu`` and its plain
PyTorch version.

Counterpart of the JAX package's ``kernels/rmsnorm`` (``kernel.py``
``rmsnorm_rows``, ``ops.py`` ``rmsnorm``, ``ref.py`` ``rmsnorm_ref``): any
leading dims, float32 mean of squares, rsqrt, times a float32 scale, cast
back to the input dtype.  The wrapper is a ``torch.autograd.Function``
whose backward is plain PyTorch in f32, as JAX differentiates the plain
function (the JAX package has no RMSNorm backward kernel).
"""
from __future__ import annotations

import torch

from . import _build

#: row widths the kernel is instantiated for: llama3.2-1b's d_model 2048,
#: mamba2-370m's and granite-moe-1b-a400m's 1024, 256 (the small
#: ``Trainer`` run of chip_smoke.py and the card smoke config),
#: llama3.2-3b's 3072, internvl2-1b's 896, llama4-scout-17b-a16e's 5120,
#: and zamba2-7b's d_model 3584 and 7168 (its d_inner, and the shared
#: block's concat(h, emb); yi-34b's d_model)
KERNEL_WIDTHS = (256, 896, 1024, 2048, 3072, 3584, 5120, 7168)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Plain version: the CPU path and the kernel's oracle."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    d = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rmsnorm kernel is built for bf16, got {x.dtype}")
    if w.dtype != torch.float32 or w.shape != (d,):
        raise ValueError(f"rmsnorm scale must be float32 ({d},), got "
                         f"{w.dtype} {tuple(w.shape)}")
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"rmsnorm kernel is instantiated for d in "
                         f"{KERNEL_WIDTHS}, got d={d}")
    x = x.contiguous()
    w = w.contiguous()
    _build.require_cuda("rmsnorm", x, w)
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        lib = _build.library()
        _build.check(lib.rmsnorm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, float(eps),
            _build.dtype_code(x), _build.stream_handle(x)), "rmsnorm")
        rmsnorm.launches += 1
    return out


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.is_cpu:
        return rmsnorm_ref(x, w, eps)
    return _launch(x, w, eps)


class _RMSNorm(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU).  Backward: plain
    PyTorch in f32 from the incoming dy, dx in x's dtype and dw in f32,
    what JAX's autodiff of ``apply_norm`` computes.  The JAX package has no
    RMSNorm backward kernel, so this is no stand-in for one."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        x32 = x.float()
        r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = x32 * r
        dy32 = dy.float()
        dw = (dy32 * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
        g = dy32 * w.float()
        dx = r * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
        return dx.to(x.dtype), dw.to(w.dtype), None


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); w: (d,) float32.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (``rmsnorm.launches`` counts them).
    Differentiable in x and w on both devices; a call that needs no
    gradient skips the autograd ``Function`` (eager serving is
    host-bound)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _forward(x, w, eps)


rmsnorm.launches = 0
