"""The tensor-core attention kernels' rounding recipe against the JAX
package, on the CPU.

``csrc/flash_prefill.cu`` and ``csrc/flash_backward.cu`` run their products
on the tensor cores in bf16 with f32 accumulation, so beside the bf16
inputs they round three intermediates to bf16 before a product: q * scale
(before QK^T), the softmax weights P (before PV and P^T dO) and dS (before
dS K and dS^T q).  ``recipe_forward`` and ``recipe_backward`` below are a
plain PyTorch model of exactly that recipe (64-key tiles of online softmax
in the forward, as the kernel walks them); they live here only, not in the
port.  They are held against the JAX package's ``flash_attention_train``
(its Pallas kernels in interpret mode): the output and log-sum-exp through
``flash_attention_fwd(..., return_lse=True)``, the gradients through
``jax.grad``, at ``chip_smoke.py``'s tolerances, on seeded numpy inputs
rounded to bf16 (the kernels' input type).
"""
import ast
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ops import \
    flash_attention_train as jax_flash_train
from test_torch_train_kernels import _CASES
from torch_parity import np32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 64   # keys per tile of the forward kernel's online softmax


def _smoke_tolerances():
    """ATTN_TOL, LSE_TOL and BWD_TOL as ``chip_smoke.py`` states them (read
    from its source, which imports torch with CUDA in mind)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    found = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name)
             and t.id in ("ATTN_TOL", "LSE_TOL", "BWD_TOL")}
    return found["ATTN_TOL"], found["LSE_TOL"], found["BWD_TOL"]


ATTN_TOL, LSE_TOL, BWD_TOL = _smoke_tolerances()

# the reference's backward cases plus one causal GQA case at the kernels'
# head_dim 64, three 64-row tiles long
CASES = _CASES + [(2, 192, 192, 4, 2, 64, True, 0)]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 and back, as a register pack before an mma."""
    return x.to(torch.bfloat16).float()


def _mask(Sq, Sk, causal, window):
    diff = torch.arange(Sq)[:, None] - torch.arange(Sk)[None, :]
    valid = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        valid &= diff >= 0
    if window > 0:
        valid &= diff < window
    return valid


def _heads(q, k, v):
    """(B, S, H, D) and (B, S, KV, D) as (B, H, S, D); KV head h // G."""
    G = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2),
            k.repeat_interleave(G, dim=2).transpose(1, 2),
            v.repeat_interleave(G, dim=2).transpose(1, 2))


def recipe_forward(q, k, v, causal, window):
    """The forward kernel's arithmetic: bf16(q * scale) . k in f32, online
    softmax over 64-key tiles in f32, bf16(P) . v in f32, the output
    rounded to bf16; returns (o (B, Sq, H, D), lse (B, H, Sq))."""
    D = q.shape[-1]
    qh, kh, vh = _heads(q, k, v)
    qs = _bf16(qh * (1.0 / math.sqrt(D)))
    Sq, Sk = qh.shape[2], kh.shape[2]
    valid = _mask(Sq, Sk, causal, window)
    m = torch.full(qh.shape[:3], -1e30)
    l = torch.zeros(qh.shape[:3])
    acc = torch.zeros(qh.shape)
    for k0 in range(0, Sk, TILE):
        s = qs @ kh[:, :, k0:k0 + TILE].transpose(-1, -2)
        s = torch.where(valid[:, k0:k0 + TILE], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= -1e30, 0.0, m_new)
        corr = torch.where(m <= -1e30, 0.0, torch.exp(m - m_safe))
        p = torch.where(valid[:, k0:k0 + TILE],
                        torch.exp(s - m_safe[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _bf16(p) @ vh[:, :, k0:k0 + TILE]
        m = m_new
    l = l.clamp_min(1e-20)
    o = _bf16(acc / l[..., None]).transpose(1, 2)
    return o, torch.where(m <= -1e30, 0.0, m) + torch.log(l)


def recipe_backward(q, k, v, o, do, lse, causal, window):
    """The backward kernels' arithmetic: delta = rowsum(dO * O) in f32,
    P = exp(bf16(q * scale) . k - lse) and dS = P * (dP - delta) in f32,
    then bf16(P)^T dO, bf16(dS)^T bf16(q * scale) and scale * bf16(dS) k
    accumulated in f32, each gradient rounded to bf16; dK, dV summed over
    each KV head's group."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qh, kh, vh = _heads(q, k, v)
    doh, oh = do.transpose(1, 2), o.transpose(1, 2)
    qs = _bf16(qh * scale)
    valid = _mask(Sq, kh.shape[2], causal, window)
    delta = (doh * oh).sum(-1)
    p = torch.where(valid, torch.exp(qs @ kh.transpose(-1, -2)
                                     - lse[..., None]), 0.0)
    ds = p * (doh @ vh.transpose(-1, -2) - delta[..., None])
    dq = scale * (_bf16(ds) @ kh)
    dk = _bf16(ds).transpose(-1, -2) @ qs
    dv = _bf16(p).transpose(-1, -2) @ doh

    def group_sum(x):   # (B, H, Sk, D) -> (B, Sk, KV, D)
        return x.reshape(B, KV, G, *x.shape[2:]).sum(2).transpose(1, 2)
    return (_bf16(dq.transpose(1, 2)), _bf16(group_sum(dk)),
            _bf16(group_sum(dv)))


def _operands(B, Sq, Sk, H, KV, D, seed):
    """q, k, v, dO from seeded numpy, rounded to bf16 (the kernels' input
    type) and handed to both packages as the same f32 values."""
    rng = np.random.default_rng(seed)
    return [np32(torch.tensor(rng.normal(size=s).astype(np.float32))
                 .to(torch.bfloat16))
            for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D),
                      (B, Sq, H, D))]


def _block(*sizes):
    """The largest block in (64, 16, 8) that divides every size, so the
    Pallas forward runs unpadded."""
    return next(b for b in (64, 16, 8) if all(s % b == 0 for s in sizes))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", CASES)
def test_recipe_forward_matches_reference(B, Sq, Sk, H, KV, D, causal,
                                          window):
    """Output within ATTN_TOL (absolute plus relative, as on the card) and
    the log-sum-exp within LSE_TOL of the Pallas forward's."""
    q, k, v, _ = _operands(B, Sq, Sk, H, KV, D, seed=Sq + 7 * D)
    bq, bk = _block(Sq), _block(Sk)
    to_bh = lambda a, S: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(  # noqa
        -1, S, D)
    o_ref, lse_ref = flash_attention_fwd(
        to_bh(q, Sq), to_bh(k, Sk), to_bh(v, Sk), causal=causal,
        window=window, block_q=bq, block_k=bk, group=H // KV,
        return_lse=True, interpret=True)
    o_ref = np32(o_ref).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)
    o, lse = recipe_forward(*(torch.tensor(a) for a in (q, k, v)), causal,
                            window)
    assert o.shape == (B, Sq, H, D) and lse.shape == (B, H, Sq)
    err = np.abs(np32(o) - o_ref)
    assert (err <= ATTN_TOL + ATTN_TOL * np.abs(o_ref)).all(), err.max()
    np.testing.assert_allclose(np32(lse), np32(lse_ref).reshape(B, H, Sq),
                               rtol=0, atol=LSE_TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", CASES)
def test_recipe_gradients_match_reference(B, Sq, Sk, H, KV, D, causal,
                                          window):
    """dq, dk, dv of the recipe, run on its own forward's (o, lse), within
    BWD_TOL of each gradient's largest |value| from ``jax.grad`` of the
    Pallas ``flash_attention_train``."""
    q, k, v, do = _operands(B, Sq, Sk, H, KV, D, seed=Sq + 7 * D + 1)
    blk = _block(Sq, Sk)

    def loss_ref(q, k, v):
        o = jax_flash_train(q, k, v, causal, window, blk, blk, True)
        return jnp.sum(o * do)

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    o, lse = recipe_forward(tq, tk, tv, causal, window)
    got = recipe_backward(tq, tk, tv, o, tdo, lse, causal, window)
    for name, g, r in zip(("dq", "dk", "dv"), got, g_ref):
        r = np32(r)
        assert g.shape == r.shape, name
        err = float(np.abs(np32(g) - r).max())
        assert err <= BWD_TOL * float(np.abs(r).max()), (name, err)
