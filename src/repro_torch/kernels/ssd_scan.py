"""Mamba2 SSD chunked scan: the Hopper kernel ``csrc/ssd_scan.cu`` and its
plain PyTorch version.

Counterpart of the JAX package's ``kernels/ssd_scan`` (``kernel.py``
``ssd_scan``, ``ops.py`` ``ssd``) and of the function the reference model
runs, ``models/ssm.py:ssd_chunked``: within a chunk of Q positions the dual
form ``(C Bᵀ ∘ L) x`` with ``L[q, k] = exp(a_cs[q] - a_cs[k])`` for
``q >= k``, plus the contribution of the (N, P) state carried in from the
previous chunks, which is then advanced to the chunk's end.  Head ``h``
reads B/C group ``h // (H / G)``.  Differentiable: the reference has no SSD
backward kernel (``jax.grad`` differentiates the jnp ``ssd_chunked``), so
the autograd ``Function`` here runs the kernel forward and recomputes the
plain f32 chunked form in its backward, as ``rmsnorm.py`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

#: the instantiations of the kernel, bf16 x/B/C and f32 a: states N
#: (mamba2-370m's 128, zamba2-7b's 64) at head P 64
KERNEL_N, KERNEL_P = (64, 128), 64
#: the longest chunk the kernel's cumulative-sum buffer holds
MAX_CHUNK = 256


def ssd_ref(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, chunk: int,
            h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the chunked dual form of ``ssd_chunked`` in float32.

    x: (B, S, H, P) dt-scaled inputs; a: (B, S, H) log decay (<= 0);
    Bm, Cm: (B, S, G, N); h0: optional (B, H, N, P) initial state.  S is
    padded to a multiple of ``Q = min(chunk, S)`` with zeros, which leave
    the state unchanged.  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) float32).
    """
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // Q
    xg = x.reshape(B, nc, Q, G, hpg, P).float()
    ag = a.reshape(B, nc, Q, G, hpg).float()
    Bg = Bm.reshape(B, nc, Q, G, N).float()
    Cg = Cm.reshape(B, nc, Q, G, N).float()

    a_cs = torch.cumsum(ag, dim=2)                     # inclusive cumsum
    a_tot = a_cs[:, :, -1]                             # (B, nc, G, hpg)

    # intra-chunk dual form; exp only where q >= k (elsewhere it may be inf)
    CB = torch.einsum("bnqgi,bnkgi->bngqk", Cg, Bg)    # (B, nc, G, Q, Q)
    seg = a_cs[:, :, :, None] - a_cs[:, :, None, :]    # (B, nc, Q, Q, G, hpg)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(causal[:, :, None, None], seg, 0.0)) \
        * causal[:, :, None, None]
    y_intra = torch.einsum("bngqk,bnqkgh,bnkghp->bnqghp", CB, L, xg)

    # each chunk's own state contribution, then the inter-chunk recurrence
    decay_out = torch.exp(a_tot[:, :, None] - a_cs)    # (B, nc, Q, G, hpg)
    S_c = torch.einsum("bnkgi,bnkgh,bnkghp->bnghip", Bg, decay_out, xg)
    h = torch.zeros(B, G, hpg, N, P, dtype=torch.float32, device=x.device) \
        if h0 is None else h0.reshape(B, G, hpg, N, P).float()
    h_prev = []
    for c in range(nc):                                # state entering chunk c
        h_prev.append(h)
        h = torch.exp(a_tot[:, c])[..., None, None] * h + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                # (B, nc, G, hpg, N, P)
    y_off = torch.einsum("bnqgi,bnqgh,bnghip->bnqghp", Cg, torch.exp(a_cs),
                         h_prev)
    y = (y_intra + y_off).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h.reshape(B, H, N, P)


def _launch(x, a, Bm, Cm, Q: int, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if x.dtype != torch.bfloat16 or Bm.dtype != torch.bfloat16 \
            or Cm.dtype != torch.bfloat16 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel is built for bf16 x/B/C and f32 a, "
                        f"got {x.dtype}/{Bm.dtype}/{Cm.dtype} and {a.dtype}")
    if N not in KERNEL_N or P != KERNEL_P:
        raise ValueError(f"ssd_scan kernel is built for state in {KERNEL_N} "
                         f"and head_dim {KERNEL_P}, got N={N} P={P}")
    if Q > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes chunks of at most "
                         f"{MAX_CHUNK}, got {Q}")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (B, H, N, P)):
        raise ValueError(f"ssd_scan: h0 must be float32 {(B, H, N, P)}, got "
                         f"{h0.dtype} {tuple(h0.shape)}")
    x, a, Bm, Cm = (t.contiguous() for t in (x, a, Bm, Cm))
    if h0 is not None:
        h0 = h0.contiguous()
    y = torch.empty_like(x)
    h_final = torch.empty(B, H, N, P, dtype=torch.float32, device=x.device)
    workspace = torch.empty(workspace_floats(B, S, H, N, P, Q),
                            dtype=torch.float32, device=x.device)
    _build.require_cuda("ssd_scan", x, a, Bm, Cm, y, h_final, workspace,
                        *([] if h0 is None else [h0]))
    if B and H:
        lib = _build.library()
        _build.check(lib.ssd_scan_launch(
            x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if h0 is None else h0.data_ptr(), workspace.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), B, S, H, G, N, P, Q,
            _build.stream_handle(x)), "ssd_scan")
        # one call, whatever the number of passes it launches
        ssd_scan.launches += 1
    return y, h_final


def workspace_floats(B: int, S: int, H: int, N: int, P: int, Q: int) -> int:
    """f32 elements of the kernel's workspace, from the shapes alone: each
    chunk's (N, P) state per head in f32, the state entering each chunk in
    bf16, and the cumulative sums of the log decay, padded to whole chunks
    (``csrc/ssd_scan.cu:ssd_scan_launch``)."""
    nc = -(-S // Q)
    return B * nc * H * N * P * 3 // 2 + B * H * nc * Q


def _forward(x, a, Bm, Cm, chunk: int, h0):
    """The plain version on a CPU tensor, else one launch of the kernel."""
    if x.device.type == "cpu":
        return ssd_ref(x, a, Bm, Cm, chunk, h0)
    return _launch(x, a, Bm, Cm, max(1, min(chunk, x.shape[1])), h0)


class _SsdScanTrain(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU).  Backward: the
    plain chunked form recomputed in f32 from the saved inputs and
    differentiated by autograd, each gradient returned in its input's
    dtype: what ``jax.grad`` of the reference's ``ssd_chunked`` computes.
    The JAX package has no SSD backward kernel, so this is no stand-in for
    one.  ``ssd_ref`` masks the segment sums before ``exp``, so the
    gradient stays finite where exp would overflow above the diagonal."""

    @staticmethod
    def forward(ctx, x, a, Bm, Cm, h0, chunk):
        ctx.save_for_backward(x, a, Bm, Cm, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _forward(x, a, Bm, Cm, chunk, h0)

    @staticmethod
    def backward(ctx, dy, dh):
        inputs = [t for t in ctx.saved_tensors if t is not None]
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in inputs]
            y, h = ssd_ref(*leaves[:4], ctx.chunk, *leaves[4:])
            outs, douts = zip(*[(o, g.float()) for o, g in
                                ((y, dy), (h, dh)) if g is not None])
            # C does not reach the final state: with y unused it gets none
            grads = torch.autograd.grad(outs, leaves, douts,
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g.to(t.dtype)
                 for g, t in zip(grads, inputs)]
        return (*grads[:4], grads[4] if len(grads) > 4 else None, None)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); a: (B, S, H); Bm, Cm: (B, S, G, N) with H % G == 0;
    h0: optional (B, H, N, P).  Chunks of ``min(chunk, S)`` positions.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``ssd_scan.launches`` counts them), which masks a ragged last chunk
    itself.  Returns (y in x's dtype, final state float32).  When grad mode
    is on and an input requires grad, the call goes through the autograd
    ``Function`` (the same forward, a plain f32 backward); otherwise it is
    the serving call, with no graph."""
    B, S, H, P = x.shape
    if a.shape != (B, S, H) or Bm.shape != Cm.shape or Bm.shape[:2] != (B, S) \
            or H % Bm.shape[2]:
        raise ValueError(f"ssd_scan: bad shapes x {tuple(x.shape)} a "
                         f"{tuple(a.shape)} B {tuple(Bm.shape)} C "
                         f"{tuple(Cm.shape)}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, a, Bm, Cm, h0)):
        return _SsdScanTrain.apply(x, a, Bm, Cm, h0, chunk)
    return _forward(x, a, Bm, Cm, chunk, h0)


ssd_scan.launches = 0
