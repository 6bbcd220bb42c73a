"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

Every parity test gives the JAX package and the port the same weights and
the same inputs: the reference is ``conftest.smoke_model`` (float32,
``PRNGKey(0)``, ``block_k=16``), its parameters cross over through
``repro_torch.models.convert.params_from_jax``, and inputs come from seeded
numpy.  Both run on the CPU; the port's kernels take their plain versions.
"""
import numpy as np
import torch

import jax
from conftest import smoke_model
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

# tolerances (the reference's own tests use the same):
F32_TOL = dict(rtol=2e-5, atol=2e-5)    # kernel-level functions in f32
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # tests/test_kernels.py bf16
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model logits in f32
QUANT_TOL = 5e-2                        # int8 / fp8 pages (test_quantized_kv)
SSD_TOL = dict(rtol=3e-4, atol=3e-4)    # SSD scan (tests/test_kernels.py)

_TWINS = {}


def twin(arch: str = "llama3.2-1b"):
    """(jax model, jax params, cfg, port model, port params), memoized."""
    if arch not in _TWINS:
        model, params, cfg = smoke_model(arch)
        tmodel = build_model(cfg, block_k=16, device="cpu")
        tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params))
        _TWINS[arch] = (model, params, cfg, tmodel, tparams)
    return _TWINS[arch]


def np32(x) -> np.ndarray:
    """A JAX array or a torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


class RecordingExecutor:
    """The engine's five-method executor hook, recording every call."""

    def __init__(self):
        self.calls = []

    def on_prefill(self):
        self.calls.append(("on_prefill",))

    def on_decode(self, n_active):
        self.calls.append(("on_decode", int(n_active)))

    def finish(self):
        self.calls.append(("finish",))

    def reset(self):
        self.calls.append(("reset",))

    def summary(self):
        return {"n_calls": len(self.calls)}
