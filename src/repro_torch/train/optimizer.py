"""Optimizers over nested-dict parameter trees: AdamW and SGD-momentum.

The port of the JAX package's ``train/optimizer.py``: the same schedule,
clipping and update rules, all state in float32 whatever the parameter
dtype.  Where the reference returns new trees, the updates here write the
parameters and the state in place (under ``torch.no_grad``) and return
them, so a full-width step holds one copy of each; the step counter and
the learning rate stay on the device, so an update never waits for it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from ..tree import leaves, map_tree


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay schedule (f32, on ``step``'s device)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm`` in f32, the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return map_tree(lambda g: g.float() * scale, grads), norm


def init_opt_state(params) -> Dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    device = leaves(params)[0].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptimizerConfig, norm=None):
    """One AdamW step, in place.  ``norm`` is the gradients' global norm
    for the clip, by default :func:`global_norm` of ``grads`` (a sharded
    step passes the norm over the whole mesh, since its ``grads`` are one
    rank's blocks).  Returns (params, state, metrics)."""
    norm = global_norm(grads) if norm is None else norm
    scale = _clip_scale(norm, cfg.grad_clip_norm)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g32 = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32.square())
        p32 = p.float()
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * upd)
    state["step"] = step
    return params, state, {"grad_norm": norm, "lr": lr}


@torch.no_grad()
def sgdm_update(params, grads, state, cfg: OptimizerConfig,
                momentum: float = 0.9):
    """One SGD-momentum step, in place.  Returns (params, state, metrics)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.grad_clip_norm)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    for p, g, m in zip(leaves(params), leaves(grads), leaves(state["m"])):
        m.mul_(momentum).add_(g.float() * scale)
        p.copy_(p.float() - lr * m)
    state["step"] = step
    return params, state, {"grad_norm": norm, "lr": lr}


UPDATES = {"adamw": adamw_update, "sgdm": sgdm_update}
