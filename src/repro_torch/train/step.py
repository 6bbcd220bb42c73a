"""The train step: micro-batched gradient accumulation, remat, AdamW.

The port of the JAX package's ``train/step.py``.  ``train_step(state,
batch)`` splits a global batch of leading dim ``B`` into ``accum_steps``
micro-batches of ``B // accum_steps`` rows, takes the loss and gradients
of each (the layers under ``torch.utils.checkpoint`` when ``remat``),
accumulates them in f32 scaled by ``1 / accum_steps``, optionally passes
them through bf16 compression, and applies AdamW.  Where the reference
scans the micro-batches, the port loops over them; it updates the
parameters and optimizer state in place and returns the state with the
step's metrics, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..tree import flatten, unflatten_like
from .grad import accumulate, compress_grads, decompress_grads, \
    zeros_like_f32
from .optimizer import OptimizerConfig, adamw_update, init_opt_state


@dataclass
class TrainState:
    params: Any
    opt: Dict
    rng: torch.Generator


def init_train_state(model, seed: int = 0) -> TrainState:
    """Parameters in ``model.param_dtype`` drawn from a generator seeded
    with ``seed`` on the model's device; the same generator then feeds the
    step's random draws (gradient compression)."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    params = model.init(gen, dtype=model.param_dtype)
    return TrainState(params=params, opt=init_opt_state(params), rng=gen)


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(model, params, batch, remat: bool = True):
    """(loss, metrics, grads) of ``model.loss`` at ``params``.  The grads
    tree matches ``params``; a leaf that no gradient reaches raises, so a
    path that drops gradients cannot pass unseen."""
    named = flatten(params)
    req = [t.detach().requires_grad_() for _, t in named]
    loss, metrics = model.loss(unflatten_like(params, req), batch,
                               remat=remat)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    missing = [path for (path, _), g in zip(named, grads) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reached {missing}")
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten_like(params, list(grads))


def make_train_step(model, opt_cfg: OptimizerConfig, accum_steps: int = 1,
                    remat: bool = True, compress: bool = False,
                    mesh=None) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``; ``batch``
    leaves have leading dim ``global_batch`` (numpy or torch).  With a
    ``DeviceMesh`` ``mesh`` the step is one rank's of the data- and
    tensor-parallel step (``parallel.train_step.ShardedStep``, built here,
    so every rank calls this together): ``state`` holds the rank's blocks
    (``parallel.train_step.init_sharded_state`` or
    ``parallel.sharding.shard_state``), every rank is given the same global
    batch and takes its rows, and the clip reads the norm over the whole
    mesh."""
    if mesh is None:
        local = lambda b: _on_device(b, model.device)  # noqa: E731
        grads_of = lambda p, b: loss_and_grads(model, p, b,  # noqa: E731
                                               remat)
        norm_of = None
    else:
        from ..parallel.train_step import ShardedStep
        plan = ShardedStep(model, mesh)
        local, norm_of = plan.local_batch, plan.global_norm
        grads_of = lambda p, b: plan.loss_and_grads(p, b,  # noqa: E731
                                                    remat)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = local(batch)
        if accum_steps == 1:
            loss, metrics, grads = grads_of(state.params, batch)
            grads = decompress_grads(grads)
        else:
            micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = zeros_like_f32(state.params)
            losses, metricses = [], []
            for i in range(accum_steps):
                loss, met, g = grads_of(state.params,
                                        {k: v[i] for k, v in micro.items()})
                accumulate(grads, g, 1.0 / accum_steps)
                del g
                losses.append(loss)
                metricses.append(met)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        if compress:
            grads, _ = compress_grads(grads, state.rng)
            grads = decompress_grads(grads)
        params, opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, opt_cfg,
            norm=None if norm_of is None else norm_of(grads))
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params=params, opt=opt, rng=state.rng), metrics

    return train_step


def make_eval_step(model, remat: bool = False) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = model.loss(params, _on_device(batch, model.device),
                                remat=remat)
        return metrics
    return eval_step
