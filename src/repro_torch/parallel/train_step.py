"""The data- and tensor-parallel train step of the dense decoder family.

What the reference gets from GSPMD on a (data, model) mesh under its
sharding rules, written out over ``torch.distributed``: every rank holds
its blocks of the parameters and AdamW moments by ``param_specs``
(:func:`~repro_torch.parallel.sharding.shard_state`), takes its rows of
the global batch by ``batch_specs``, and runs the layer stack with each
layer's weights made whole on use:

* **Tensor parallelism (Megatron).**  A dim named ``heads``, ``kv`` or
  ``mlp`` that the rules put on ``model`` is computed locally: q, k and v
  projected with the rank's heads and the attention kernels run on them,
  the MLP on the rank's columns of ``d_ff``; ``wo`` and ``w_down`` are row
  parallel, their partial sums added by ``g``
  (:func:`~repro_torch.parallel.collectives.reduce_from_parallel`) and the
  block's input entering through ``f`` (``copy_to_parallel``).  Where the
  query heads split over ``model`` but the KV heads do not, each rank
  projects the KV heads its query heads read (through ``f``, since every
  rank's part of their gradient must be summed).  Any other dim on
  ``model`` (``vocab`` where it divides) is gathered on use, its gradient
  the local block.  Where the heads or ``d_ff`` do not divide the model
  axis the rules leave them replicated and every rank computes them whole
  (the reference then adds a sequence-sharding hint, which changes where
  work runs, not the result).
* **FSDP (ZeRO-3) over the data axes.**  Every ``embed`` dim is
  all-gathered on use, layer by layer inside the layer's checkpoint (so
  remat gathers again in the backward, as the reference's scan body
  does), in the compute dtype (the cast of the float32 master, as the
  reference's ``cast_sharded`` moves bf16); its gradient comes back
  reduce-scattered.  A leaf replicated over a data axis has its gradient
  summed over it.

The layer and the loss are the model's own: ``DecoderLM._layer_fwd`` on
the weights made whole, with f and g as its tensor-parallel hooks, and
``cm.lm_loss`` (the mean over the target tokens with z-loss 1e-4) scaled
by the rank's token count over the global batch's, so that the gradients
summed over the data axes are the global mean's (not a mean of the ranks'
means).  The global-norm clip sums the ranks' squared norms
over the whole mesh, a leaf replicated over an axis counted once, and
AdamW runs on the local blocks.  The MoE, SSM, hybrid, encoder-decoder
and VLM families are refused (ROADMAP item 11's next slice).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..models import common as cm
from ..tree import flatten, leaves, unflatten_like
from ..train.optimizer import init_opt_state
from ..train.step import TrainState
from . import collectives as coll
from .sharding import (batch_specs, data_axes, entry_names, mesh_axes,
                       mesh_coords, param_specs, shard_state)

#: logical axes whose ``model`` split is computed locally (Megatron)
TP_AXES = ("heads", "kv", "mlp")
#: leaves read in float32 by their users (never cast)
_F32_LEAVES = ("scale", "bias")


@dataclass(frozen=True)
class LeafUse:
    """How one leaf (one layer's block, for a stacked leaf) is made whole
    for use: gathered along ``data_dim`` over the data axes
    ``data_names``, its gradient summed over the data axes ``data_rest``
    it is replicated over; ``model_dim`` split over ``model``, computed
    locally when ``model_local`` else gathered."""
    data_dim: Optional[int]
    data_names: Tuple[str, ...]
    data_rest: Tuple[str, ...]
    model_dim: Optional[int]
    model_local: bool


def _refuse(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the sharded train step runs the dense decoder "
            f"family; sharded training of the {cfg.family} family is "
            f"ROADMAP item 11's next slice")


class ShardedStep:
    """One rank's sharded loss, gradients and clip norm for a dense
    ``DecoderLM`` on a (data, model) ``DeviceMesh`` (``"pod"`` may lead).
    Every rank of the mesh builds it, in the same order (it makes the
    process groups it needs)."""

    def __init__(self, model, mesh):
        _refuse(model.cfg)
        self.model, self.mesh = model, mesh
        self.sizes = mesh_axes(mesh)
        if "model" not in self.sizes:
            raise ValueError(f"the mesh has no 'model' axis: {self.sizes}")
        self.data = data_axes(mesh)
        self.dp = math.prod(self.sizes[a] for a in self.data)
        coords = mesh_coords(mesh)
        self.data_index = 0
        for a in self.data:
            self.data_index = self.data_index * self.sizes[a] + coords[a]
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.model_group = self._group(("model",))
        self.data_group = self._group(self.data)
        self.world = self._group(tuple(self.sizes))
        self.specs = param_specs(model, mesh)
        axes = model.param_axes()
        self.uses = self._map(self._use_of, self.specs, axes)
        # each leaf's copies over the mesh (axes it is not split over)
        self.copies = [math.prod(self.sizes[a] for a in self.sizes
                                 if a not in {n for e in spec
                                              for n in entry_names(e)})
                       for _, spec in flatten(self.specs)]
        layer = self.uses["layers"]
        self.attn_tp = layer["attn"]["wq"].model_local
        self.kv_tp = layer["attn"]["wk"].model_local
        self.mlp_tp = next(iter(layer["mlp"].values())).model_local
        self.kv_heads = self._kv_heads() if self.attn_tp and not self.kv_tp \
            else None
        fg = (lambda t: coll.copy_to_parallel(t, self.model_group),
              lambda t: coll.reduce_from_parallel(t, self.model_group))
        self.hooks = {block: fg for block, on in (("attn", self.attn_tp),
                                                  ("mlp", self.mlp_tp)) if on}
        # what ``cm.lm_loss`` reads of a model
        self.cfg, self.device = model.cfg, model.device
        self.compute_dtype = model.compute_dtype

    # -- plan ------------------------------------------------------------
    def _group(self, names: Tuple[str, ...]):
        names = tuple(a for a in self.sizes if a in names)
        if names not in self._groups:
            self._groups[names] = coll.mesh_group(self.mesh, names)
        return self._groups[names]

    def _map(self, fn, specs, axes, stacked: bool = False):
        if isinstance(specs, dict):
            return {k: self._map(fn, specs[k], axes[k],
                                 stacked or k == "layers") for k in specs}
        if stacked:        # one layer's block: the layer dim is dropped
            specs, axes = specs[1:], axes[1:]
        return fn(specs, axes)

    def _use_of(self, spec, axes) -> LeafUse:
        data_dim, data_names, model_dim, local = None, (), None, False
        for dim, entry in enumerate(spec):
            names = entry_names(entry)
            if "model" in names:
                model_dim, local = dim, axes[dim] in TP_AXES
            elif names:
                data_dim, data_names = dim, names
        rest = tuple(a for a in self.data if a not in data_names)
        use = LeafUse(data_dim, data_names, rest, model_dim, local)
        for names in (use.data_names, use.data_rest):
            self._group(names)          # made now, in the same order
        return use

    def _kv_heads(self) -> Tuple[int, int]:
        """(first, count) of the KV heads this rank's query heads read,
        when the query heads split over ``model`` and the KV heads do not."""
        cfg = self.model.cfg
        H, KV = cfg.n_heads, cfg.n_kv_heads
        G, hl = H // KV, H // self.sizes["model"]
        h0 = coll.group_rank(self.model_group) * hl
        if hl % G and G % hl:
            raise NotImplementedError(
                f"{cfg.name}: {hl} query heads a rank over KV groups of {G}")
        return h0 // G, max(hl // G, 1)

    # -- use -------------------------------------------------------------
    def use(self, w: torch.Tensor, u: LeafUse, name: str,
            in_tp: bool = False) -> torch.Tensor:
        """Leaf block ``w`` made whole for use (see :class:`LeafUse`), a
        matrix in the compute dtype; ``in_tp`` marks a leaf replicated over
        ``model`` that feeds rank-local (tensor-parallel) compute."""
        if name not in _F32_LEAVES:
            w = cm.cast(w, self.model.compute_dtype)
        if u.data_names:
            w = coll.gather_data(w, self._group(u.data_names), u.data_dim)
        if u.data_rest:
            w = coll.copy_to_parallel(w, self._group(u.data_rest))
        if u.model_dim is not None and not u.model_local:
            w = coll.gather_replicated(w, self.model_group, u.model_dim)
        elif u.model_dim is None and in_tp:
            w = coll.copy_to_parallel(w, self.model_group)
        return w

    def _use_tree(self, tree, uses, in_tp=()):
        return {k: self._use_tree(v, uses[k], in_tp) if isinstance(v, dict)
                else self.use(v, uses[k], k, k in in_tp)
                for k, v in tree.items()}

    # -- forward: the model's own layer and loss ---------------------------
    def _layer(self, lp, x: torch.Tensor, q_offset: int, window: int):
        """``DecoderLM._layer_fwd`` on the rank's blocks ``lp``, made whole
        for use here (inside the layer's checkpoint, so remat gathers
        again), with f and g around the blocks computed locally."""
        w = self._use_tree(lp, self.uses["layers"],
                           in_tp=("wk", "wv") if self.attn_tp else ())
        if self.kv_heads is not None:
            k0, n = self.kv_heads
            w["attn"] = dict(w["attn"], wk=w["attn"]["wk"][:, k0:k0 + n],
                             wv=w["attn"]["wv"][:, k0:k0 + n])
        return self.model._layer_fwd(w, x, q_offset, window, tp=self.hooks)

    def forward_hidden(self, params, x: torch.Tensor, remat: bool = True):
        """The model's layer stack over :meth:`_layer` (what
        ``cm.lm_loss`` calls)."""
        return self.model.forward_hidden(params, x, remat=remat,
                                         layer_fwd=self._layer)

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return self.model.logits(params, x)

    def loss(self, params, batch: Dict[str, torch.Tensor],
             remat: bool = True) -> torch.Tensor:
        """This rank's part of the global mean loss on its blocks
        ``params`` and rows ``batch`` (:meth:`local_batch`): the model's
        own loss (``cm.lm_loss``, run on this step as on the model, the
        embedding and final norm made whole once) times the rank's
        target-token count over the global batch's (over ``batch["mask"]``
        when given), so that the data ranks' parts add up to the global
        mean, not to a mean of their means."""
        whole = {k: self._use_tree(params[k], self.uses[k])
                 for k in ("embed", "final_norm")}
        loss, _ = cm.lm_loss(self, dict(whole, layers=params["layers"]),
                             batch, remat)
        mask = batch.get("mask")
        if mask is None:
            return loss / self.dp
        local = mask.float().sum()
        count = coll.all_reduce(local, self.data_group)
        return loss * (torch.clamp(local, min=1.0)
                       / torch.clamp(count, min=1.0))

    def loss_and_grads(self, params, batch, remat: bool = True):
        """(the global loss, metrics, this rank's gradient blocks), as
        ``train.step.loss_and_grads`` returns them unsharded; a leaf that
        no gradient reaches raises."""
        named = flatten(params)
        req = [t.detach().requires_grad_() for _, t in named]
        loss = self.loss(unflatten_like(params, req), batch, remat)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        missing = [path for (path, _), g in zip(named, grads) if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        total = coll.all_reduce(loss.detach(), self.data_group)
        return total, {"ce_loss": total, "loss": total}, \
            unflatten_like(params, list(grads))

    def global_norm(self, grads) -> torch.Tensor:
        """The gradients' global norm over the whole mesh: each rank's
        squared block norms, a leaf's divided by its copies, summed over
        every rank."""
        sq = sum(g.float().square().sum() / n
                 for g, n in zip(leaves(grads), self.copies))
        return torch.sqrt(coll.all_reduce(sq.reshape(1), self.world)[0])

    def local_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (numpy or torch) on the
        model's device, by ``batch_specs``."""
        specs = batch_specs(batch, self.sizes)
        out = {}
        for k, v in batch.items():
            if specs[k]:
                n = v.shape[0] // self.dp
                v = v[self.data_index * n:(self.data_index + 1) * n]
            elif self.dp > 1 and k in ("tokens", "targets", "mask"):
                raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows does "
                                 f"not split over {self.dp} data ranks")
            out[k] = torch.as_tensor(v, device=self.model.device)
        return out


def init_sharded_state(model, mesh, seed: int = 0) -> TrainState:
    """This rank's blocks of ``init_train_state(model, seed)``: the global
    parameters drawn as that draws them (on the model's device), cut by
    the specs and freed, the AdamW moments made at the blocks' shapes."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    params = model.init(gen, dtype=model.param_dtype)
    local = shard_state(params, mesh, param_specs(model, mesh))
    del params
    return TrainState(params=local, opt=init_opt_state(local), rng=gen)


__all__ = ["ShardedStep", "LeafUse", "TP_AXES", "init_sharded_state"]
