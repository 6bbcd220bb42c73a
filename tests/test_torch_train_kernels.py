"""The training path's kernels against the JAX package's, on the CPU.

The differentiable flash attention (forward with log-sum-exp, flash
backward) against the JAX package's Pallas ``flash_attention_train`` and
``flash_attention_fwd(return_lse=True)`` in interpret mode, on the cases of
``tests/test_flash_backward.py``; RMSNorm's gradients against ``jax.grad``
of ``apply_norm``; and the serving-only wrappers refusing gradients.  The
CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ops import \
    flash_attention_train as jax_flash_train
from repro.models import common as jcm
from repro_torch import kernels
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_train,
                                                 flash_prefill,
                                                 paged_flash_decode)
from repro_torch.kernels.rmsnorm import rmsnorm
from torch_parity import BF16_TOL, F32_TOL, np32

FLASH_BWD_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_flash_backward.py

# (B, Sq, Sk, H, KV, D, causal, window): the reference's backward cases
_CASES = [(1, 32, 32, 2, 2, 16, True, 0),
          (2, 48, 48, 4, 2, 16, True, 0),     # GQA: dk/dv summed over groups
          (1, 40, 56, 2, 1, 16, False, 0),    # padding both sides
          (1, 64, 64, 2, 2, 16, True, 24)]    # local window


def _operands(B, Sq, Sk, H, KV, D, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D))]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", _CASES)
def test_flash_attention_train_matches_reference(B, Sq, Sk, H, KV, D, causal,
                                                 window):
    q, k, v, w = _operands(B, Sq, Sk, H, KV, D)

    def loss_ref(q, k, v):
        o = jax_flash_train(q, k, v, causal, window, 16, 16, True)
        return jnp.sum(o * w), o

    (_, o_ref), g_ref = jax.value_and_grad(loss_ref, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash_attention_train(tq, tk, tv, causal, window)
    (o * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(np32(o), np32(o_ref), **F32_TOL)
    for name, got, ref in zip(("dq", "dk", "dv"), (tq, tk, tv), g_ref):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(np32(got.grad), np32(ref),
                                   **FLASH_BWD_TOL, err_msg=name)


@pytest.mark.parametrize("G,causal,window", [(1, True, 0), (2, True, 0),
                                             (2, False, 0), (1, True, 12)])
def test_forward_lse_matches_reference(G, causal, window):
    """The forward's log-sum-exp against the TPU kernel's
    ``return_lse=True`` output, in its (B * H, Sq, 1) layout."""
    B, S, KV, D = 2, 32, 2, 16
    H = KV * G
    q, k, v, _ = _operands(B, S, S, H, KV, D, seed=G + 10 * window)
    to_bh = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(  # noqa
        -1, S, D)
    o_ref, lse_ref = flash_attention_fwd(
        to_bh(q), to_bh(k), to_bh(v), causal=causal, window=window,
        block_q=16, block_k=16, group=G, return_lse=True, interpret=True)
    o, lse = flash_prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           causal=causal, window=window, block_k=16,
                           return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(np32(lse), np32(lse_ref).reshape(B, H, S),
                               **F32_TOL)
    np.testing.assert_allclose(
        np32(o), np32(o_ref).reshape(B, H, S, D).transpose(0, 2, 1, 3),
        **F32_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_grads_match_reference(dtype):
    """dx in x's dtype and dw in f32, as ``jax.grad`` of ``apply_norm``."""
    jd, td, tol = {"f32": (jnp.float32, torch.float32, F32_TOL),
                   "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 64)) * 2.0).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32)
    c = rng.normal(size=(3, 5, 64)).astype(np.float32)

    def loss_ref(x, w):
        y = jcm.apply_norm({"scale": w}, x, "rms")
        return jnp.sum(y.astype(jnp.float32) * c)

    gx_ref, gw_ref = jax.grad(loss_ref, argnums=(0, 1))(
        jnp.asarray(x, jd), jnp.asarray(w))
    tx = torch.tensor(x).to(td).requires_grad_()
    tw = torch.tensor(w, requires_grad=True)
    (rmsnorm(tx, tw).float() * torch.tensor(c)).sum().backward()
    assert tx.grad.dtype == td and tw.grad.dtype == torch.float32
    np.testing.assert_allclose(np32(tx.grad), np32(gx_ref), **tol)
    np.testing.assert_allclose(np32(tw.grad), np32(gw_ref), **tol)


@pytest.mark.parametrize("wrapper", ["paged_decode", "flash_prefill"])
def test_serving_wrappers_refuse_gradients(wrapper):
    """A wrapper whose kernel writes through raw pointers would hand back a
    result without a gradient on the card: it raises on an input that
    requires grad, on the CPU too, and runs under ``torch.no_grad``.  The
    prefill attention differentiates only what the flash backward covers,
    so a call with valid lengths raises."""
    q = torch.randn(2, 1, 4, 16, requires_grad=True)
    pages = torch.randn(5, 4, 2, 16)
    if wrapper == "paged_decode":
        args = (q, pages, pages, torch.tensor([[1, 2], [3, 4]]),
                torch.tensor([3, 5]))
        fn = paged_flash_decode
    else:
        args = (torch.randn(1, 8, 4, 16, requires_grad=True),
                torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16),
                torch.tensor([5]))
        fn = flash_prefill
    with pytest.raises(RuntimeError, match="not differentiable"):
        fn(*args)
    with torch.no_grad():
        fn(*args)


def test_flash_prefill_differentiates_through_the_flash_backward():
    """With grad on and an input that requires it, the prefill attention is
    ``flash_attention_train`` (the same output and gradients); without,
    it returns a plain tensor and writes no log-sum-exp."""
    q, k, v, w = (torch.tensor(a) for a in _operands(2, 24, 24, 4, 2, 16))
    grads = []
    for fn in (flash_prefill, flash_attention_train):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        assert type(o.grad_fn).__name__ == "_FlashAttentionTrainBackward"
        (o * w).sum().backward()
        grads.append([o.detach()] + [t.grad for t in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    for fn in (flash_prefill, flash_attention_train):
        with torch.no_grad():
            o = fn(q.requires_grad_(), k, v)
        assert o.grad_fn is None
        torch.testing.assert_close(o, grads[0][0], rtol=0, atol=0)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,error,match", [
    ("bf16_d64", ValueError, "CUDA device"), ("f32", TypeError, "bf16"),
    ("d16", ValueError, "head_dim 64"), ("lse_bf16", TypeError, "float32"),
    ("d224_g2", ValueError, "head_dim 224 with one query head"),
    ("bf16_d224", ValueError, "CUDA device"),
    ("window", NotImplementedError, "training path"),
    ("non_causal", NotImplementedError, "training path"),
    ("sq_ne_sk", NotImplementedError, "training path")])
def test_flash_bwd_refuses_what_it_is_not_built_for(case, error, match):
    """Off the CPU the backward launches its kernel or raises before any
    launch; with no card here every case raises.  Beside dtype and
    head_dim (64 at any group, 224 with one query head per KV head) it
    refuses what the training path does not give it: a window, no causal
    mask, Sq != Sk."""
    kernels.reset_launch_counts()
    D = {"d16": 16, "d224_g2": 224, "bf16_d224": 224}.get(case, 64)
    dt = torch.float32 if case == "f32" else torch.bfloat16
    Sk = 16 if case == "sq_ne_sk" else 8
    KV = 4 if case == "bf16_d224" else 2
    q, kv = _meta(1, 8, 4, D, dtype=dt), _meta(1, Sk, KV, D, dtype=dt)
    lse = _meta(1, 4, 8, dtype=torch.bfloat16 if case == "lse_bf16"
                else torch.float32)
    with pytest.raises(error, match=match):
        flash_attention_bwd(q, kv, kv, q, q, lse, causal=case != "non_causal",
                            window=8 if case == "window" else 0)
    assert kernels.launch_counts()["flash_bwd"] == 0
