"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

Every parity test gives the JAX package and the port the same weights and
the same inputs: the reference is ``conftest.smoke_model`` (float32,
``PRNGKey(0)``, ``block_k=16``), its parameters cross over through
``repro_torch.models.convert.params_from_jax``, and inputs come from seeded
numpy.  Both run on the CPU; the port's kernels take their plain versions.

Importing this module caps PyTorch's intra-op threads at one for the
process (every port test file imports it, so under pytest-xdist each
worker is capped when it collects): the tests' tensors are small, and
with one OpenMP pool of ``os.cpu_count()`` threads a worker, the workers'
pools and XLA's contend for the cores (a granite decode test of
``test_torch_moe_consistency.py`` took 245.6 s in four workers against
~31 s alone).
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

torch.set_num_threads(1)

_TWINS = {}
_JITTED = {}


class _Jitted:
    """A reference model's entry points under ``jax.jit``: ``prefill``
    (``max_seq`` and ``remat`` static), ``decode_step``, ``encode``
    (``remat`` static) where the model has one, and ``loss_grad``,
    ``jax.value_and_grad(model.loss, has_aux=True)`` (``remat`` static).
    Called eagerly, each of them traces and compiles its ``lax.scan`` at
    every call (a hybrid smoke prefill 17.7 s eager against 2.6 s for the
    first jitted call and 0.01 s for the next); jitted, once per shape.
    The values part from the eager calls' by XLA's fusion only (~1e-7 in
    f32 on the CPU)."""

    def __init__(self, model):
        self.model = model                # keeps the key's object alive
        self.prefill = jax.jit(model.prefill,
                               static_argnames=("max_seq", "remat"))
        self.decode_step = jax.jit(model.decode_step)
        if hasattr(model, "encode"):
            self.encode = jax.jit(model.encode, static_argnames=("remat",))
        self.loss_grad = jax.jit(
            jax.value_and_grad(model.loss, has_aux=True),
            static_argnames=("remat",))


def jref(model) -> _Jitted:
    """The reference ``model``'s jitted entry points (``_Jitted``),
    memoized per model object: every test of a worker that calls the
    same twin at the same shapes shares one compile."""
    if id(model) not in _JITTED:
        _JITTED[id(model)] = _Jitted(model)
    return _JITTED[id(model)]


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
