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

from repro.kernels.flash_attention.backward import \
    flash_attention_bwd as flash_attention_bwd_pallas
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
          (1, 64, 64, 2, 2, 16, True, 24),    # local window
          # llama4-scout's card smoke config trains its local layers at
          # head_dim 64, 4 query heads over 2, window 32: a partial last
          # 64-row tile (S 72), and a window of 40 that begins mid-tile
          # (multiples of 8, so test_torch_flash_tc.py's Pallas forward
          # runs them unpadded too)
          (2, 72, 72, 4, 2, 64, True, 32),
          (1, 104, 104, 4, 2, 64, True, 40)]
# cases of the wide kernels, whose q scale is not exact in bf16 (the
# rounding recipe of test_torch_flash_tc.py models the head_dim-64 kernels
# on _CASES): llama4-scout trained at full width, head_dim 128 with 5 query
# heads per KV head, its local layers' window biting (40 over S 72, a
# partial last tile)
_WIDE_CASES = [(1, 72, 72, 5, 1, 128, True, 40)]


def _operands(B, Sq, Sk, H, KV, D, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D))]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window",
                         _CASES + _WIDE_CASES)
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


def _to_bh(a, S, D):
    """(B, S, H, D) as the TPU kernels' (B * H, S, D)."""
    return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(-1, S, D)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [48, 64])
def test_forward_lse_matches_reference_at_head_dim_128(S, dtype):
    """gpt3-xl's training forward, head_dim 128 with one query head per KV
    head: the plain version's output and log-sum-exp against the TPU
    kernel's ``return_lse=True`` in interpret mode, called on whole blocks
    of 16 as its ops wrapper calls it.  In bf16 the plain version rounds q * scale and P
    as the reference's jnp attention does, the TPU kernel neither, so bf16
    is held at ``BF16_TOL``."""
    B, H, D = 2, 2, 128
    q, k, v, _ = _operands(B, S, S, H, H, D, seed=S)
    jd, td, tol = {"f32": (jnp.float32, torch.float32, F32_TOL),
                   "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
    o_ref, lse_ref = flash_attention_fwd(
        *(_to_bh(a, S, D).astype(jd) for a in (q, k, v)), causal=True,
        block_q=16, block_k=16, return_lse=True, interpret=True)
    o, lse = flash_prefill(*(torch.tensor(a).to(td) for a in (q, k, v)),
                           block_k=16, return_lse=True)
    assert o.dtype == td and lse.shape == (B, H, S)
    np.testing.assert_allclose(np32(lse), np32(lse_ref).reshape(B, H, S),
                               **tol)
    np.testing.assert_allclose(
        np32(o), np32(o_ref).reshape(B, H, S, D).transpose(0, 2, 1, 3), **tol)


@pytest.mark.parametrize("S", [48, 64])
def test_flash_bwd_plain_version_matches_reference_at_head_dim_128(S):
    """The flash backward's plain version (the kernels' oracle) at head_dim
    128 against the TPU kernels' ``flash_attention_bwd`` in interpret mode,
    on the same saved output and log-sum-exp (whole blocks of 16), in
    f32."""
    B, H, D = 2, 2, 128
    q, k, v, do = _operands(B, S, S, H, H, D, seed=S + 1)
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    o, lse = flash_prefill(tq, tk, tv, block_k=16, return_lse=True)
    got = flash_attention_bwd(tq, tk, tv, o, tdo, lse)
    ref = flash_attention_bwd_pallas(
        *(_to_bh(a, S, D) for a in (q, k, v, np32(o), do)),
        jnp.asarray(np32(lse)).reshape(B * H, S, 1), causal=True,
        block_q=16, block_k=16, interpret=True)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(
            np32(g), np32(r).reshape(B, H, S, D).transpose(0, 2, 1, 3),
            **FLASH_BWD_TOL, err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_lse_matches_reference_at_head_dim_128_group_3(dtype):
    """llama3.2-3b's training forward, head_dim 128 with 3 query heads per
    KV head (6 over 2 here): output and log-sum-exp against the TPU
    kernel's ``return_lse=True`` with ``group=3`` in interpret mode."""
    B, S, H, KV, D = 2, 48, 6, 2, 128
    q, k, v, _ = _operands(B, S, S, H, KV, D, seed=3)
    jd, td, tol = {"f32": (jnp.float32, torch.float32, F32_TOL),
                   "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
    o_ref, lse_ref = flash_attention_fwd(
        *(_to_bh(a, S, D).astype(jd) for a in (q, k, v)), causal=True,
        block_q=16, block_k=16, group=H // KV, return_lse=True,
        interpret=True)
    o, lse = flash_prefill(*(torch.tensor(a).to(td) for a in (q, k, v)),
                           block_k=16, return_lse=True)
    assert o.dtype == td and lse.shape == (B, H, S)
    np.testing.assert_allclose(np32(lse), np32(lse_ref).reshape(B, H, S),
                               **tol)
    np.testing.assert_allclose(
        np32(o), np32(o_ref).reshape(B, H, S, D).transpose(0, 2, 1, 3), **tol)


def test_flash_attention_train_matches_reference_at_head_dim_128_group_3():
    """llama3.2-3b's differentiable attention, head_dim 128 with 3 query
    heads per KV head (6 over 2 here): the output and dq, dk, dv (dk and dv
    summed over each KV head's 3 query heads) against the JAX package's
    ``flash_attention_train`` in interpret mode, in f32."""
    B, S, H, KV, D = 1, 48, 6, 2, 128
    q, k, v, w = _operands(B, S, S, H, KV, D, seed=33)

    def loss_ref(q, k, v):
        o = jax_flash_train(q, k, v, True, 0, 16, 16, True)
        return jnp.sum(o * w), o

    (_, o_ref), g_ref = jax.value_and_grad(loss_ref, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash_attention_train(tq, tk, tv, True, 0)
    (o * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(np32(o), np32(o_ref), **F32_TOL)
    for name, got, ref in zip(("dq", "dk", "dv"), (tq, tk, tv), g_ref):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(np32(got.grad), np32(ref),
                                   **FLASH_BWD_TOL, err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_lse_matches_reference_at_group_7(dtype):
    """internvl2-1b's training forward, head_dim 64 with 7 query heads per
    KV head (14 over 2): output and log-sum-exp against the TPU kernel's
    ``return_lse=True`` with ``group=7`` in interpret mode."""
    B, S, H, KV, D = 1, 48, 14, 2, 64
    q, k, v, _ = _operands(B, S, S, H, KV, D, seed=7)
    jd, td, tol = {"f32": (jnp.float32, torch.float32, F32_TOL),
                   "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
    o_ref, lse_ref = flash_attention_fwd(
        *(_to_bh(a, S, D).astype(jd) for a in (q, k, v)), causal=True,
        block_q=16, block_k=16, group=H // KV, return_lse=True,
        interpret=True)
    o, lse = flash_prefill(*(torch.tensor(a).to(td) for a in (q, k, v)),
                           block_k=16, return_lse=True)
    assert o.dtype == td and lse.shape == (B, H, S)
    np.testing.assert_allclose(np32(lse), np32(lse_ref).reshape(B, H, S),
                               **tol)
    np.testing.assert_allclose(
        np32(o), np32(o_ref).reshape(B, H, S, D).transpose(0, 2, 1, 3), **tol)


def test_flash_attention_train_matches_reference_at_group_7():
    """internvl2-1b's differentiable attention, head_dim 64 with 7 query
    heads per KV head (14 over 2): the output and dq, dk, dv (dk and dv
    summed over each KV head's 7 query heads) against the JAX package's
    ``flash_attention_train`` in interpret mode, in f32."""
    B, S, H, KV, D = 1, 32, 14, 2, 64
    q, k, v, w = _operands(B, S, S, H, KV, D, seed=77)

    def loss_ref(q, k, v):
        o = jax_flash_train(q, k, v, True, 0, 16, 16, True)
        return jnp.sum(o * w), o

    (_, o_ref), g_ref = jax.value_and_grad(loss_ref, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash_attention_train(tq, tk, tv, True, 0)
    (o * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(np32(o), np32(o_ref), **F32_TOL)
    for name, got, ref in zip(("dq", "dk", "dv"), (tq, tk, tv), g_ref):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(np32(got.grad), np32(ref),
                                   **FLASH_BWD_TOL, err_msg=name)


def test_flash_attention_train_matches_reference_at_head_dim_128_group_7():
    """yi-34b's differentiable attention, head_dim 128 with 7 query heads
    per KV head (14 over 2 here): the output and dq, dk, dv (dk and dv
    summed over each KV head's 7 query heads by the flash backward's plain
    version, which the kernel is held to on the card) against the JAX
    package's ``flash_attention_train`` in interpret mode, in f32."""
    B, S, H, KV, D = 1, 48, 14, 2, 128
    q, k, v, w = _operands(B, S, S, H, KV, D, seed=135)

    def loss_ref(q, k, v):
        o = jax_flash_train(q, k, v, True, 0, 16, 16, True)
        return jnp.sum(o * w), o

    (_, o_ref), g_ref = jax.value_and_grad(loss_ref, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash_attention_train(tq, tk, tv, True, 0)
    (o * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(np32(o), np32(o_ref), **F32_TOL)
    for name, got, ref in zip(("dq", "dk", "dv"), (tq, tk, tv), g_ref):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(np32(got.grad), np32(ref),
                                   **FLASH_BWD_TOL, err_msg=name)


@pytest.mark.parametrize("D,G,fwd,bwd", [
    (64, 7, "CUDA device", "CUDA device"),
    (128, 7, "CUDA device", "CUDA device"),
    (128, 5, "CUDA device", "CUDA device"),
    (192, 12, "CUDA device", "got D=192, H=24, KV=2")])
def test_group_5_and_7_instantiations_forward_and_backward(D, G, fwd, bwd):
    """At 7 query heads per KV head the forward and the backward are built
    at head_dim 64 (internvl2-1b) and 128 (yi-34b, trained at full width
    and 3 layers), and at 5 at head_dim 128 (llama4-scout-17b-a16e,
    trained at full width and 4 layers on four cards).  The forward is
    also built at (192, 12) (nemotron-4-340b's serving), the backward not:
    no path trains it at full width, so it keeps refusing it.  Off the
    CPU each call launches its kernel or raises before any launch; with no
    card here every case raises."""
    kernels.reset_launch_counts()
    q, kv = _meta(1, 8, 2 * G, D), _meta(1, 8, 2, D)
    with pytest.raises(ValueError, match=fwd):
        flash_prefill(q, kv, kv, return_lse=True)
    with pytest.raises(ValueError, match=bwd):
        flash_attention_bwd(q, kv, kv, q, q,
                            _meta(1, 2 * G, 8, dtype=torch.float32))
    assert kernels.launch_counts()["flash_prefill"] == 0
    assert kernels.launch_counts()["flash_bwd"] == 0


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


@pytest.mark.parametrize("Sq,Sk", [(48, 80), (80, 32), (64, 64)])
def test_flash_bwd_plain_version_matches_reference_non_causal(Sq, Sk):
    """seamless-m4t-medium's training attention at head_dim 64, one query
    head per KV head, without the causal mask: the encoder's
    self-attention (Sq == Sk) and the decoder's cross-attention (Sq text
    positions over Sk frames, either longer).  The flash backward's plain
    version (the kernels' oracle) against the TPU kernels'
    ``flash_attention_bwd(causal=False)`` in interpret mode, on the same
    saved output and log-sum-exp (whole blocks of 16), in f32."""
    B, H, D = 2, 2, 64
    q, k, v, do = _operands(B, Sq, Sk, H, H, D, seed=Sq + Sk)
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    o, lse = flash_prefill(tq, tk, tv, causal=False, block_k=16,
                           return_lse=True)
    got = flash_attention_bwd(tq, tk, tv, o, tdo, lse, causal=False)
    ref = flash_attention_bwd_pallas(
        _to_bh(q, Sq, D), _to_bh(k, Sk, D), _to_bh(v, Sk, D),
        _to_bh(np32(o), Sq, D), _to_bh(do, Sq, D),
        jnp.asarray(np32(lse)).reshape(B * H, Sq, 1), causal=False,
        block_q=16, block_k=16, interpret=True)
    for name, g, r, S in zip(("dq", "dk", "dv"), got, ref, (Sq, Sk, Sk)):
        np.testing.assert_allclose(
            np32(g), np32(r).reshape(B, H, S, D).transpose(0, 2, 1, 3),
            **FLASH_BWD_TOL, err_msg=name)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,error,match", [
    ("bf16_d64", ValueError, "CUDA device"), ("f32", TypeError, "bf16"),
    ("d16", ValueError, "head_dim 64"), ("lse_bf16", TypeError, "float32"),
    ("d224_g2", ValueError, "128 and 224 with one query head"),
    ("bf16_d224", ValueError, "CUDA device"),
    ("d128_g2", ValueError, "128 and 224 with one query head"),
    ("bf16_d128", ValueError, "CUDA device"),
    ("bf16_d128_g3", ValueError, "CUDA device"),
    ("bf16_d128_g7", ValueError, "CUDA device"),
    ("bf16_d128_g5", ValueError, "CUDA device"),
    ("window", ValueError, "CUDA device"),
    ("window_non_causal", NotImplementedError, "training path"),
    ("non_causal", ValueError, "CUDA device"),
    ("non_causal_sq_ne_sk", ValueError, "CUDA device"),
    ("sq_ne_sk", NotImplementedError, "training path")])
def test_flash_bwd_refuses_what_it_is_not_built_for(case, error, match):
    """Off the CPU the backward launches its kernel or raises before any
    launch; with no card here every case raises.  Beside dtype and
    head_dim (64 at any group, 128 and 224 with one query head per KV
    head, 128 with 3, 5 and 7) it refuses what the training paths do not give it:
    a causal mask at Sq != Sk, and a window without the causal mask.
    Causal attention with a window (llama4-scout's local layers) and
    non-causal attention, at Sq == Sk (an encoder) or not
    (cross-attention), pass those gates and are refused only for want of
    a card."""
    kernels.reset_launch_counts()
    D = {"d16": 16, "d224_g2": 224, "bf16_d224": 224, "d128_g2": 128,
         "bf16_d128": 128, "bf16_d128_g3": 128,
         "bf16_d128_g7": 128, "bf16_d128_g5": 128}.get(case, 64)
    dt = torch.float32 if case == "f32" else torch.bfloat16
    Sk = 16 if case.endswith("sq_ne_sk") else 8
    KV = 4 if case in ("bf16_d224", "bf16_d128") else 2
    H = {"bf16_d128_g3": 6, "bf16_d128_g7": 14,
         "bf16_d128_g5": 10}.get(case, 4)
    q, kv = _meta(1, 8, H, D, dtype=dt), _meta(1, Sk, KV, D, dtype=dt)
    lse = _meta(1, H, 8, dtype=torch.bfloat16 if case == "lse_bf16"
                else torch.float32)
    with pytest.raises(error, match=match):
        flash_attention_bwd(q, kv, kv, q, q, lse,
                            causal="non_causal" not in case,
                            window=8 if case.startswith("window") else 0)
    assert kernels.launch_counts()["flash_bwd"] == 0
