"""granite-moe-1b-a400m's decode against a longer prefill, in both packages,
on the CPU: what ``chip_smoke.py``'s consistency gate for an MoE model
rests on.

granite's routing (32 experts drawn at E^-0.5, top-8) at its full depth of
24 layers, narrowed to d_model 256 (d_ff 128, 4 query heads over 2 at
head_dim 64), with the gate's prompts (lengths 100 and 37 from seed 5) and
4 greedy decode steps over a dense cache, each against the last-position
logits of one prefill of the prompt and the tokens so far:

- in bfloat16 the reference's own decode parts from its longer prefill by
  more than the gate's 5% of the largest |logit|, and the port's by as
  much: a near-tie in the routing flips under either package's rounding,
  and one flip moves a token's output by several percent of the residual;
- in float32 the reference's decode matches its longer prefill, and the
  port's does with the longer prefill held to the experts the decode path
  chose (``chip_smoke.HeldPath``), the end-to-end check the card runs at
  full width; the same harness on bf16 pages holds each layer's output
  within the gate (``HeldPath`` with its residual held too).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

ARCH = "granite-moe-1b-a400m"
NARROW = dict(d_model=256, d_ff=128, n_heads=4, n_kv_heads=2, head_dim=64)
STEPS, MAX_SEQ = 4, 160
F32_GAP = 1e-4       # whole-model logits in f32 (torch_parity.LOGITS_TOL)
_MODELS = {}


def _models(dtype: str):
    """(jax model, jax params, port model, port params) in ``dtype``, both
    on the port's leaves (bf16 matrices, an f32 router) of one reference
    init."""
    if dtype not in _MODELS:
        jcfg = dataclasses.replace(jax_get_config(ARCH), **NARROW,
                                   compute_dtype=dtype)
        tcfg = dataclasses.replace(get_config(ARCH), **NARROW,
                                   compute_dtype=dtype)
        assert tcfg.n_layers == 24 and tcfg.moe.n_experts == 32
        jinit = jax_build_model(dataclasses.replace(
            jcfg, compute_dtype="float32")).init(jax.random.PRNGKey(0))
        tmodel = build_model(tcfg, block_k=16, device="cpu")
        tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, jinit))

        def to_jax(tree):
            return {k: to_jax(v) if isinstance(v, dict) else
                    jnp.asarray(v.float().numpy()).astype(
                        jnp.bfloat16 if v.dtype == torch.bfloat16
                        else jnp.float32)
                    for k, v in tree.items()}
        _MODELS[dtype] = (jax_build_model(jcfg, block_k=16),
                          to_jax(tparams), tmodel, tparams)
    return _MODELS[dtype]


def _prompts(vocab):
    """``chip_smoke.phase_consistency``'s prompts, padded to the bucket."""
    rng = np.random.default_rng(5)
    plens = np.array([100, 37], np.int32)
    prompts = np.zeros((len(plens), 128 + STEPS), np.int32)
    for b, n in enumerate(plens):
        prompts[b, :n] = rng.integers(0, vocab, n)
    return prompts, plens


def _decode_gaps(package: str, dtype: str):
    """Each step's max |decode - longer prefill| over the longer prefill's
    max |logit|, with each package's own routing."""
    jmodel, jparams, tmodel, tparams = _models(dtype)
    prompts, plens = _prompts(tmodel.cfg.vocab_size)
    if package == "jax":
        def prefill(toks, lens):
            return jmodel.prefill(jparams, jnp.asarray(toks), max_seq=MAX_SEQ,
                                  remat=False, prompt_lens=jnp.asarray(lens))

        def decode(cache, tok, pos):
            return jmodel.decode_step(jparams, cache, jnp.asarray(tok),
                                      jnp.asarray(pos))
    else:
        def prefill(toks, lens):
            return tmodel.prefill(tparams, torch.tensor(toks),
                                  max_seq=MAX_SEQ,
                                  prompt_lens=torch.tensor(lens))

        def decode(cache, tok, pos):
            return tmodel.decode_step(tparams, cache, torch.tensor(tok),
                                      torch.tensor(pos))

    def f32(x):
        """The vocabulary's columns, not the head's padding, in f32."""
        x = x.float().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, np.float32)
        return x[:, :tmodel.cfg.vocab_size]
    logits, cache = prefill(prompts[:, :128], plens)
    tok, pos, gaps = np.argmax(f32(logits), -1).astype(np.int32), plens, []
    for i in range(STEPS):
        prompts[np.arange(len(plens)), plens + i] = tok
        logits, cache = decode(cache, tok, pos)
        ref = f32(prefill(prompts, plens + i + 1)[0])
        got = f32(logits)
        gaps.append(float(np.abs(got - ref).max() / np.abs(ref).max()))
        tok, pos = np.argmax(got, -1).astype(np.int32), pos + 1
    return gaps


def test_bf16_decode_parts_from_longer_prefill_in_both_packages():
    """The reference's own bf16 decode fails the 5% gate at full depth; the
    port's parts by as much (within a factor of 4 of the reference's)."""
    ref = max(_decode_gaps("jax", "bfloat16"))
    port = max(_decode_gaps("port", "bfloat16"))
    print(f"bf16 worst relative gap: reference {ref:.4g}, port {port:.4g}")
    assert ref > chip_smoke.CONSISTENCY_TOL, ref
    assert ref / 4 <= port <= 4 * ref, (port, ref)


def test_f32_reference_decode_matches_longer_prefill():
    """The reference's f32 decode matches its longer prefill with its own
    routing.  The port's own-routing gaps are printed beside, not gated: a
    near-tie can still flip under f32 rounding, which the card's f32 check
    rules out by holding the experts."""
    ref = _decode_gaps("jax", "float32")
    print(f"f32 relative gaps: reference {ref}, port with its own routing "
          f"{_decode_gaps('port', 'float32')}")
    assert max(ref) <= F32_GAP


@pytest.mark.parametrize("hold,dtype,tol", [
    ("experts", "float32", F32_GAP),
    ("hold", "bfloat16", chip_smoke.CONSISTENCY_TOL)])
def test_port_decode_matches_held_longer_prefill(hold, dtype, tol):
    """``chip_smoke.phase_consistency`` on pages of the compute dtype: in
    f32 the longer prefill held to the decode path's experts matches the
    decode within f32 rounding; in bf16, held to its experts and residual,
    each layer's output and the logits within the gate, every flip of its
    own routing a near-tie."""
    _, _, tmodel, tparams = _models(dtype)
    assert chip_smoke.phase_consistency(tmodel, tparams, steps=STEPS,
                                        hold=hold, tag=hold) <= tol
