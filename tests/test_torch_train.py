"""The port's training path against the JAX package's, on the CPU: the
model's loss and every parameter's gradient with remat, the optimizer
updates, gradient compression, checkpoints, and whole ``Trainer`` runs
(loss curve, restart drill, executor hook calls) on the llama3.2-1b smoke
config with the same weights and the same data stream."""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpoints
from repro.data import DataPipeline as JaxPipeline
from repro.runtime import FailureInjector as JaxInjector
from repro.train import OptimizerConfig as JaxOptConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train import optimizer as jax_opt
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainerConfig as JaxTrainerConfig
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataPipeline
from repro_torch.models import DecoderLM
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import FailureInjector
from repro_torch.train import (OptimizerConfig, TrainState, UPDATES,
                               compress_grads, init_opt_state,
                               loss_and_grads, make_eval_step,
                               make_train_step)
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.tree import flatten, map_tree
from torch_parity import np32, twin

GRAD_RTOL = 1e-4     # of each leaf's largest |value|
CURVE_TOL = 1e-4
OPT = dict(lr=1e-2, warmup_steps=2, decay_steps=100)


def _batch(cfg, B=2, S=24, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _close_per_leaf(got, ref, rtol):
    ref = dict(flatten(ref))
    for path, g in flatten(got):
        r = np32(ref[path])
        assert g.shape == r.shape, path
        err = np.abs(np32(g) - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= rtol, f"{path}: {err:.3e} > {rtol}"


def test_model_loss_and_grads_match_reference():
    """Loss, metrics and every leaf's gradient against
    ``jax.value_and_grad(model.loss)`` with remat on, f32 masters."""
    model, params, cfg, tmodel, tparams = twin()
    batch = _batch(cfg)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: model.loss(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, remat=True),
        has_aux=True)(params)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    tloss, tmetrics, tgrads = loss_and_grads(tmodel, tparams, tbatch,
                                             remat=True)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(tmetrics["ce_loss"]),
                               float(metrics["ce_loss"]), rtol=1e-6)
    assert all(g.dtype == torch.float32 for g in map(lambda x: x[1],
                                                     flatten(tgrads)))
    _close_per_leaf(tgrads, jax.tree.map(np.asarray, grads), GRAD_RTOL)
    # the eval step (no remat, no graph) gives the same loss
    got = make_eval_step(tmodel)(tparams, batch)["loss"]
    np.testing.assert_allclose(float(got), float(tloss), rtol=1e-6)


def test_training_params_are_f32_masters_and_serving_keeps_bf16():
    cfg = smoke_config(get_config("llama3.2-1b"))
    model = DecoderLM(cfg, device="cpu")
    serve = dict(flatten(model.init()))
    train = dict(flatten(model.init(dtype=model.param_dtype)))
    assert serve["layers/attn/wq"].dtype == torch.bfloat16
    assert serve["layers/norm_attn/scale"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in train.values())
    # the same draws, cast once for serving
    assert torch.equal(train["embed/wte"].bfloat16(), serve["embed/wte"])


def _random_tree(rng, shapes, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_optimizer_update_matches_reference(name):
    """Two updates (the second clips) against the reference's."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 8), "b": (16,), "c": (2, 3, 5)}
    params = {"w": _random_tree(rng, shapes), "s": {"x": np.ones(7, np.float32)}}
    grads = [{"w": _random_tree(rng, shapes, 0.1 * i),
              "s": {"x": rng.normal(size=7).astype(np.float32)}}
             for i in (1, 30)]
    jcfg = JaxOptConfig(**OPT)
    tcfg = OptimizerConfig(**OPT)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_opt.init_opt_state(jp)
    tp = map_tree(torch.tensor, params)
    ts = init_opt_state(tp)
    for g in grads:
        jp, js, jm = jax_opt.UPDATES[name](jp, jax.tree.map(jnp.asarray, g),
                                           js, jcfg)
        tp, ts, tm = UPDATES[name](tp, map_tree(torch.tensor, g), ts, tcfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    _close_per_leaf(tp, jax.tree.map(np.asarray, jp), 1e-6)
    _close_per_leaf(ts["m"], jax.tree.map(np.asarray, js["m"]), 1e-6)
    if name == "adamw":
        _close_per_leaf(ts["v"], jax.tree.map(np.asarray, js["v"]), 1e-6)


def test_compress_grads_error_feedback_is_exact():
    """c + e == g + e_in bit for bit, and c lies within one bf16 step of
    g + e_in."""
    gen = torch.Generator().manual_seed(0)
    g = {"a": torch.randn(64, 33) * 1e-3, "b": torch.randn(7) * 50}
    comp, err = compress_grads(g, gen)
    comp2, err2 = compress_grads(g, gen, err)
    for (path, x), (_, c), (_, e), (_, c2), (_, e2) in zip(
            flatten(g), flatten(comp), flatten(err), flatten(comp2),
            flatten(err2)):
        assert c.dtype == torch.bfloat16 and e.dtype == torch.float32
        assert torch.equal(c.float() + e, x), path
        assert torch.equal(c2.float() + e2, x + e), path
        assert bool(((c.float() - x).abs() <= x.abs() * 2.0 ** -7).all()), \
            path


def test_compress_grads_rounding_is_unbiased():
    """Over many seeds the mean of the rounded values converges on g: the
    bias is far below one bf16 step (2^-8 relative)."""
    x = {"a": torch.linspace(-3.0, 3.0, 257) + 1e-3}
    runs = torch.stack([compress_grads(x, torch.Generator().manual_seed(s))
                        [0]["a"].float() for s in range(400)])
    ulp = x["a"].abs() * 2.0 ** -8
    bias = (runs.mean(0) - x["a"]).abs()
    assert bool((bias <= 0.15 * ulp + 1e-12).all()), float((bias / ulp).max())
    assert float(runs.std(0).max()) > 0          # the rounding is random


def test_train_step_accumulation_matches_one_batch():
    """Two micro-batches of 2 rows take the same step as one of 4."""
    _, _, cfg, tmodel, tparams = twin()
    batch = _batch(cfg, B=4, S=16, seed=4)
    out = []
    for accum in (1, 2):
        params = map_tree(torch.clone, tparams)
        state = TrainState(params, init_opt_state(params),
                           torch.Generator().manual_seed(0))
        step = make_train_step(tmodel, OptimizerConfig(**OPT),
                               accum_steps=accum, remat=True)
        state, metrics = step(state, batch)
        out.append((state.params, float(metrics["loss"]),
                    float(metrics["grad_norm"])))
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=1e-5)
    _close_per_leaf(out[1][0], map_tree(np32, out[0][0]), GRAD_RTOL)


def test_checkpoint_roundtrip_restores_onto_the_template():
    params = {"w": torch.randn(3, 4), "h": {"b": torch.randn(5).bfloat16()}}
    gen = torch.Generator().manual_seed(5)
    state = TrainState(params, init_opt_state(params), gen)
    state.opt["step"] += 7
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for step in (1, 2, 3):
            mgr.save(step, state, extra={"pipeline": {"step": step}})
        assert mgr.all_steps() == [2, 3]
        template = TrainState(map_tree(torch.zeros_like, params),
                              init_opt_state(params),
                              torch.Generator().manual_seed(9))
        got, index = mgr.restore(template)
        assert index["step"] == 3 and mgr.restore_extra(2) == {
            "pipeline": {"step": 2}}
    for (path, a), (_, b) in zip(flatten(params), flatten(got.params)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert int(got.opt["step"]) == 7
    assert torch.equal(torch.rand(4, generator=got.rng),
                       torch.rand(4, generator=gen))


# ---------------------------------------------------------------------------
# whole Trainer runs, JAX package and port on the same weights and stream
# ---------------------------------------------------------------------------

class RecordingExecutor:
    """An executor that books nothing and records every hook call."""

    def __init__(self):
        self.calls, self.n = [], 0

    def on_step(self, step):
        self.calls.append(("on_step", step))
        self.n += 1
        return type("StepEnergy", (), {"time_s": 1.0 * step,
                                       "energy_j": 2.0 * step})

    def finish(self):
        self.calls.append(("finish",))

    def summary(self):
        self.calls.append(("summary",))
        return {"steps": self.n}

    def reset(self):
        self.calls.append(("reset",))
        self.n = 0

    def state_dict(self):
        self.calls.append(("state_dict",))
        return {"steps": self.n}

    def load_state_dict(self, d):
        self.calls.append(("load_state_dict", d))
        self.n = d["steps"]


STEPS, SEED = 6, 0
TRAINER_CFG = dict(total_steps=STEPS, ckpt_every=2, max_restarts=2)


def _carried_model(cfg, jax_params):
    """The port's model whose ``init`` returns the JAX trainer's initial
    parameters (fresh copies: the port updates them in place)."""
    tree = jax.tree.map(np.asarray, jax_params)

    class Carried(DecoderLM):
        def init(self, generator=None, dtype=None):
            return params_from_jax(self, tree, dtype)
    return Carried(cfg, block_k=16, device="cpu")


def _port_run(model, fail_at=()):
    with tempfile.TemporaryDirectory() as d:
        ex = RecordingExecutor()
        trainer = Trainer(
            model, make_train_step(model, OptimizerConfig(**OPT),
                                   accum_steps=2, remat=True),
            DataPipeline(model.cfg.vocab_size, 4, 16),
            CheckpointManager(d, keep=2), TrainerConfig(**TRAINER_CFG),
            executor=ex, failure_injector=FailureInjector(fail_at),
            seed=SEED)
        return trainer.run(), trainer.history, ex.calls


@pytest.fixture(scope="module")
def runs():
    """Both trainers with one injected failure (step 3, restart from the
    step-2 checkpoint), and the port's uninterrupted run."""
    model, _, cfg, _, _ = twin()
    jax_params = model.init(jax.random.split(jax.random.PRNGKey(SEED))[0])
    with tempfile.TemporaryDirectory() as d:
        ex = RecordingExecutor()
        trainer = JaxTrainer(
            model, jax_make_train_step(model, JaxOptConfig(**OPT),
                                       accum_steps=2, remat=True),
            JaxPipeline(cfg.vocab_size, 4, 16),
            JaxCheckpoints(d, keep=2), JaxTrainerConfig(**TRAINER_CFG),
            executor=ex, failure_injector=JaxInjector((3,)), seed=SEED)
        ref = (trainer.run(), trainer.history, ex.calls)
    tmodel = _carried_model(cfg, jax_params)
    return {"jax": ref, "port": _port_run(tmodel, fail_at=(3,)),
            "port_clean": _port_run(tmodel)}


def test_trainer_loss_curve_matches_reference(runs):
    (jout, jhist, _), (tout, thist, _) = runs["jax"], runs["port"]
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] \
        == [0, 1, 2, 2, 3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=0,
                               atol=CURVE_TOL)
    assert tout["restarts"] == jout["restarts"] == 1
    assert tout["final_step"] == jout["final_step"] == STEPS


def test_trainer_executor_hooks_match_reference(runs):
    (jout, jhist, jcalls), (tout, thist, tcalls) = runs["jax"], runs["port"]
    assert tcalls == jcalls
    assert tout["dvfs"] == jout["dvfs"] == {"steps": STEPS}
    for key in ("dvfs_time_s", "dvfs_energy_j"):
        assert [h[key] for h in thist] == [h[key] for h in jhist]


def test_trainer_restart_drill_equals_uninterrupted_run(runs):
    """The run with a failure at step 3 restarts from the step-2
    checkpoint (params, optimizer, generator, data cursor) and ends with
    the losses of the run without one, bit for bit."""
    _, hist, _ = runs["port"]
    out, clean, _ = runs["port_clean"]
    last = {h["step"]: h["loss"] for h in hist}
    assert out["restarts"] == 0
    assert [last[s] for s in range(STEPS)] == [h["loss"] for h in clean]
