"""Training the SSM and hybrid families: the port against the JAX package on
the CPU.

The SSD scan's autograd ``Function`` (kernel forward, plain f32 backward)
against ``jax.grad`` of the reference's ``ssd_chunked``; ``MambaLM.loss``
and ``HybridLM.loss`` (the smoke twins, and the hybrid's 5-layer variant
with a tail) against ``jax.value_and_grad`` on every parameter leaf, with
remat on and off; the port's ``Trainer`` on mamba against the JAX
``Trainer`` through an injected failure; and the flash backward's plain
version at head_dim 224 against ``jax.grad`` of the reference's jnp
attention in bf16, the attention the JAX hybrid trains through.  The
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpoints
from repro.data import DataPipeline as JaxPipeline
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.runtime import FailureInjector as JaxInjector
from repro.train import OptimizerConfig as JaxOptConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainerConfig as JaxTrainerConfig
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.kernels.flash_attention import flash_attention_train
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import FailureInjector
from repro_torch.train import OptimizerConfig, loss_and_grads, make_train_step
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.tree import flatten
from torch_parity import np32, twin

GRAD_RTOL = 1e-4     # of each leaf's largest |value| (test_torch_train.py)
CURVE_TOL = 1e-4     # Trainer losses, absolute (test_torch_train.py)
# bf16 attention gradients, of each one's largest |value|: both sides round
# q * scale, P, dS and the outputs to bf16 at their own places (2^-8 is one
# bf16 step at the largest value)
BF16_GRAD_RTOL = 1e-2
OPT = dict(lr=1e-2, warmup_steps=2, decay_steps=100)


def _rel_err(got, ref) -> float:
    ref = np32(ref)
    return float(np.abs(np32(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# the SSD scan's autograd Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk,G,h0", [
    (32, 16, 1, False),     # two whole chunks of 16
    (40, 16, 2, True),      # a ragged last chunk, 2 groups, an initial state
    (24, 8, 1, True),       # three chunks, an initial state
    (16, 32, 2, False)])    # one chunk shorter than the chunk size
def test_ssd_function_grads_match_reference(S, chunk, G, h0):
    """The gradients of x, a, B, C and h0 through y and the final state
    against ``jax.grad`` of ``ssd_chunked``, in f32.  The log decays keep
    the reference's ``exp`` before its causal ``where`` finite (its
    gradient is NaN where exp overflows above the diagonal; ROADMAP queue
    3); the port masks before ``exp``."""
    B, H, P, N = 2, 4, 16, 8
    rng = np.random.default_rng(S + chunk + G)
    ops = [rng.normal(size=(B, S, H, P)),
           -np.abs(rng.normal(size=(B, S, H))) * 0.1,
           rng.normal(size=(B, S, G, N)), rng.normal(size=(B, S, G, N)),
           rng.normal(size=(B, H, N, P))]
    wy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    wh = rng.normal(size=(B, H, N, P)).astype(np.float32)
    ops = [o.astype(np.float32) for o in ops]
    n_in = 5 if h0 else 4

    def loss_ref(*args):
        y, hf = jax_ssd_chunked(*args[:4], chunk,
                                h0=args[4] if h0 else None)
        return jnp.sum(y * wy) + jnp.sum(hf * wh)

    ref = jax.grad(loss_ref, argnums=tuple(range(n_in)))(
        *(jnp.asarray(o) for o in ops[:n_in]))
    leaves = [torch.tensor(o, requires_grad=True) for o in ops[:n_in]]
    y, hf = ssd_scan(*leaves[:4], chunk, h0=leaves[4] if h0 else None)
    assert type(y.grad_fn).__name__ == "_SsdScanTrainBackward"
    ((y * torch.tensor(wy)).sum() + (hf * torch.tensor(wh)).sum()).backward()
    for name, t, r in zip(("x", "a", "B", "C", "h0"), leaves, ref):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape, name
        assert _rel_err(t.grad, r) <= GRAD_RTOL, (name, _rel_err(t.grad, r))


def test_ssd_function_returns_grads_in_input_dtypes():
    """bf16 x, B and C take bf16 gradients and f32 a and h0 f32 ones, as
    ``jax.grad`` returns them; only the final state's gradient flows when
    y is unused."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(1, 20, 2, 16)), dtype=torch.bfloat16,
                     requires_grad=True)
    a = torch.tensor(-0.1 * rng.random((1, 20, 2)), dtype=torch.float32,
                     requires_grad=True)
    bc = torch.tensor(rng.normal(size=(1, 20, 1, 8)), dtype=torch.bfloat16,
                      requires_grad=True)
    h0 = torch.zeros(1, 2, 8, 16, requires_grad=True)
    _, hf = ssd_scan(x, a, bc, bc, 8, h0=h0)
    hf.sum().backward()
    assert (x.grad.dtype, a.grad.dtype, bc.grad.dtype, h0.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16, torch.float32)
    assert all(bool(torch.isfinite(t.grad.float()).all())
               for t in (x, a, bc, h0))


# ---------------------------------------------------------------------------
# the models' loss and every gradient
# ---------------------------------------------------------------------------

_TAILED = {}


def _models(name: str):
    """The smoke twins, and the hybrid at 5 layers (two groups of 2 and a
    one-block tail after one more application of the shared block)."""
    if name != "hybrid_tail":
        return twin({"ssm": "mamba2-370m", "hybrid": "zamba2-7b"}[name])
    if not _TAILED:
        _, _, cfg, _, _ = twin("zamba2-7b")
        cfg = dataclasses.replace(cfg, n_layers=5)
        model = jax_build_model(cfg, block_k=16)
        params = model.init(jax.random.PRNGKey(0))
        tmodel = build_model(cfg, block_k=16, device="cpu")
        tparams = params_from_jax(tmodel, jax.tree.map(np.asarray, params))
        _TAILED.update(m=(model, params, cfg, tmodel, tparams))
    return _TAILED["m"]


def _batch(cfg, B=2, S=24, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", ["ssm", "hybrid", "hybrid_tail"])
def test_model_loss_and_grads_match_reference(name, remat):
    """Loss, metrics and every leaf's gradient against
    ``jax.value_and_grad(model.loss)``; S 24 runs the SSD scan over a
    ragged second chunk of the smoke config's 16."""
    model, params, cfg, tmodel, tparams = _models(name)
    batch = _batch(cfg)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: model.loss(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, remat=remat),
        has_aux=True)(params)
    tloss, tmetrics, tgrads = loss_and_grads(
        tmodel, tparams, {k: torch.tensor(v) for k, v in batch.items()},
        remat=remat)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(tmetrics["ce_loss"]),
                               float(metrics["ce_loss"]), rtol=1e-6)
    ref = dict(flatten(jax.tree.map(np.asarray, grads)))
    got = flatten(tgrads)
    assert sorted(p for p, _ in got) == sorted(ref)
    for path, g in got:
        assert g.shape == ref[path].shape, path
        assert _rel_err(g, ref[path]) <= GRAD_RTOL, (path,
                                                     _rel_err(g, ref[path]))


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_training_masters_are_f32_and_serving_keeps_the_compute_dtype(name):
    """``init(dtype=param_dtype)`` gives f32 masters for every leaf (what
    ``init_train_state`` asks for); serving keeps bf16 matrices beside the
    f32 norm scales, ``dt_bias``, ``A_log`` and ``D``, from the same
    draws."""
    cfg = get_config({"ssm": "mamba2-370m", "hybrid": "zamba2-7b"}[name])
    cfg = dataclasses.replace(cfg, n_layers=2 if name == "ssm" else 3,
                              d_model=64, vocab_size=257, d_ff=128,
                              n_heads=4 if name == "hybrid" else 0,
                              n_kv_heads=4 if name == "hybrid" else 0)
    model = build_model(cfg, device="cpu")
    serve = dict(flatten(model.init()))
    train = dict(flatten(model.init(dtype=model.param_dtype)))
    assert model.param_dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in train.values())
    assert serve["layers/mamba/w_x"].dtype == torch.bfloat16
    for leaf in ("A_log", "dt_bias", "D"):
        assert serve[f"layers/mamba/{leaf}"].dtype == torch.float32
    assert torch.equal(train["embed/wte"].bfloat16(), serve["embed/wte"])


# ---------------------------------------------------------------------------
# the Trainer on mamba, JAX package and port on the same weights and stream
# ---------------------------------------------------------------------------

STEPS, SEED = 6, 0
TRAINER_CFG = dict(total_steps=STEPS, ckpt_every=2, max_restarts=2)


@pytest.fixture(scope="module")
def mamba_runs():
    """Both trainers on mamba with one injected failure (step 3, restart
    from the step-2 checkpoint), and the port's uninterrupted run."""
    model, _, cfg, tmodel, _ = twin("mamba2-370m")
    jax_params = model.init(jax.random.split(jax.random.PRNGKey(SEED))[0])
    tree = jax.tree.map(np.asarray, jax_params)
    with tempfile.TemporaryDirectory() as d:
        trainer = JaxTrainer(
            model, jax_make_train_step(model, JaxOptConfig(**OPT),
                                       accum_steps=2, remat=True),
            JaxPipeline(cfg.vocab_size, 4, 16), JaxCheckpoints(d, keep=2),
            JaxTrainerConfig(**TRAINER_CFG), failure_injector=JaxInjector((3,)), seed=SEED)
        ref = (trainer.run(), trainer.history)

    class Carried(type(tmodel)):
        """The port's MambaLM whose ``init`` returns the JAX trainer's
        initial parameters (fresh copies: the port updates in place)."""

        def init(self, generator=None, dtype=None):
            return params_from_jax(self, tree, dtype)

    carried = Carried(cfg, device="cpu")

    def port_run(fail_at=()):
        with tempfile.TemporaryDirectory() as d:
            trainer = Trainer(
                carried, make_train_step(carried, OptimizerConfig(**OPT),
                                         accum_steps=2, remat=True),
                DataPipeline(cfg.vocab_size, 4, 16),
                CheckpointManager(d, keep=2), TrainerConfig(**TRAINER_CFG),
                failure_injector=FailureInjector(fail_at), seed=SEED)
            return trainer.run(), trainer.history
    return {"jax": ref, "port": port_run((3,)), "port_clean": port_run()}


def test_mamba_trainer_loss_curve_matches_reference(mamba_runs):
    (jout, jhist), (tout, thist) = mamba_runs["jax"], mamba_runs["port"]
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] \
        == [0, 1, 2, 2, 3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=0,
                               atol=CURVE_TOL)
    assert tout["restarts"] == jout["restarts"] == 1
    assert tout["final_step"] == jout["final_step"] == STEPS


def test_mamba_trainer_restart_drill_equals_uninterrupted_run(mamba_runs):
    """The run with a failure at step 3 restarts from the step-2
    checkpoint of the mamba tree and ends with the losses of the run
    without one, bit for bit."""
    _, hist = mamba_runs["port"]
    out, clean = mamba_runs["port_clean"]
    last = {h["step"]: h["loss"] for h in hist}
    assert out["restarts"] == 0
    assert [last[s] for s in range(STEPS)] == [h["loss"] for h in clean]


# ---------------------------------------------------------------------------
# the hybrid's attention gradient at head_dim 224
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [48, 40])
def test_head_dim_224_backward_matches_reference_attention_in_bf16(S):
    """zamba2-7b's shared attention (head_dim 224, one query head per KV
    head) in bf16: the port's differentiable attention (the plain forward
    with its log-sum-exp, then ``flash_attention_bwd_ref``, the kernels'
    oracle, with q scaled in bf16 by the bf16-rounded factor) against
    ``jax.grad`` of the reference's ``chunked_attention`` in bf16, the
    function the JAX hybrid trains through."""
    B, H, D = 2, 2, 224
    rng = np.random.default_rng(S)
    q, k, v, w = (rng.normal(size=(B, S, H, D)).astype(np.float32)
                  for _ in range(4))

    def loss_ref(q, k, v):
        o = jcm.chunked_attention(q, k, v, causal=True, block_k=16)
        return jnp.sum(o.astype(jnp.float32) * w)

    ref = jax.grad(loss_ref, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    leaves = [torch.tensor(a).bfloat16().requires_grad_() for a in (q, k, v)]
    o = flash_attention_train(*leaves, True, 0, 16)
    (o.float() * torch.tensor(w)).sum().backward()
    for name, t, r in zip(("dq", "dk", "dv"), leaves, ref):
        assert t.grad.dtype == torch.bfloat16, name
        assert _rel_err(t.grad, r) <= BF16_GRAD_RTOL, (name,
                                                      _rel_err(t.grad, r))
