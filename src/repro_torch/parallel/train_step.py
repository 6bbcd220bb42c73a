"""The data-, tensor- and expert-parallel train step of every family:
dense, VLM, MoE, SSM, hybrid and encoder-decoder.

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
* **Expert parallelism (MoE).**  The experts go over ``model`` as the
  rules say (``experts``; where E does not divide the axis, their
  ``d_ff`` columns).  Each rank routes its data rows with the replicated
  router (gathered on use), runs its experts on the pairs routed to them
  (its slice of ``torch._grouped_mm``: the rank's experts' pairs sorted
  first, the other rows masked) and sums its float32 partial combine
  with the other ranks' by ``g``; the routing weights and the experts'
  input enter through ``f``.  The shared expert is a Megatron MLP.  The
  capacity ``C = max(int(cf * T * K / E), 1)`` and a pair's rank within
  its expert run over the global batch's token-major order, as the
  unsharded layer's: a data rank offsets its ranks by the per-expert
  counts of the data ranks before it (an exclusive prefix over an
  all-gather of the (E,) counts over the data axes), so it drops exactly
  the pairs the unsharded layer drops.  The load balance, the router
  z-loss and the dropped fraction are global means: each sum is
  all-reduced over the data axes before the product, the sums that carry
  a gradient by :func:`~repro_torch.parallel.collectives.all_reduce_grad`.
  With micro-batches (``accum_steps``) a data rank's micro-batch is its
  block of the global batch cut in ``accum_steps``, so the capacity's
  token groups are not the unsharded step's micro-batches.
* **VLM.**  ``patch_embeds`` takes the batch's data split, and the model's
  ``_embed_input`` places the rank's patch rows before its tokens.
* **Mamba2 blocks (SSM, hybrid).**  ``inner`` goes over ``model`` in whole
  heads (:meth:`ShardedStep.mamba_shard`): z, x and their conv are
  computed locally, ``out_proj`` is row parallel behind g, and the
  per-head leaves the rules replicate (``w_dt``, ``dt_bias``, ``A_log``,
  ``D``) enter through f and are sliced to the rank's heads.  ``w_bc``'s
  columns split over ``model`` too: each rank convolves its columns and
  the conv's output is gathered over ``model`` (its gradient
  reduce-scattered back), so every rank reads the B/C groups its heads
  read, which the SSD scan then takes as its groups (a split that
  straddles a group is refused).  The gate norm's RMS runs over the whole
  ``d_inner``: the rank's sum of squares summed over ``model`` (its
  gradient summed too), in plain f32 by the ``rmsnorm`` kernel's recipe.
* **Hybrid.**  The shared block is a Megatron block on concat(h, emb),
  made whole on use at each application inside the group's checkpoint;
  its gradient adds up over the applications.
* **Encoder-decoder.**  Each encoder and decoder layer is made whole on
  use inside its checkpoint; the cross-attention's memory enters its K/V
  projections through f; ``frames`` takes the batch's data split, and
  ``enc_pos`` is gathered over the data axes like any ``embed`` dim.

The layer and the loss are the model's own: ``DecoderLM._layer_fwd`` on
the weights made whole, with f and g as its tensor-parallel hooks (and
``common.apply_moe`` given the rank's part, :meth:`ShardedStep.moe_shard`), and
``cm.lm_loss`` (the mean over the target tokens with z-loss 1e-4) scaled
by the rank's token count over the global batch's, so that the gradients
summed over the data axes are the global mean's (not a mean of the ranks'
means).  The global-norm clip sums the ranks' squared norms
over the whole mesh, a leaf replicated over an axis counted once, and
AdamW runs on the local blocks.  Every family runs the model's own layer
code (``_layer_fwd``, ``mamba_layer``, ``HybridLM._group_fwd``,
``EncDecLM._enc_body`` / ``_dec_body``) through its ``layer_fwd`` hooks;
llama4-scout's local layers take their window in the flash forward and
backward.

The same plan runs one rank's sharded prefill and decode
(:mod:`repro_torch.parallel.serve_step`), with no autograd.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..models import common as cm
from ..models.ssm import MambaShard, mamba_layer
from ..models.transformer import _same
from ..tree import flatten, leaves, unflatten_like
from ..train.optimizer import init_opt_state
from ..train.step import TrainState
from . import collectives as coll
from .sharding import (batch_specs, cut_block, data_axes, entry_names,
                       mesh_axes, mesh_coords, param_specs)

#: logical axes whose ``model`` split is computed locally (Megatron; the
#: experts too, but for the router's, which routes replicated)
TP_AXES = ("heads", "kv", "mlp", "experts", "inner")
#: leaves read in float32 by their users (never cast): the norms' scales
#: and biases, the MoE router (the model keeps it float32 and routes in
#: float32), a Mamba2 block's ``dt_bias``, ``A_log`` and ``D``
_F32_LEAVES = ("scale", "bias", "router", "dt_bias", "A_log", "D")
#: a Mamba2 block's leaves that feed its rank-local heads when the rules
#: leave them replicated over ``model``: they enter through f
_MAMBA_IN_TP = ("w_dt", "dt_bias", "A_log", "D", "w_bc", "conv_bc_w",
                "conv_bc_b")
#: the stacked layer trees of the families
_STACKS = ("layers", "enc_layers", "dec_layers")


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


class ShardedStep:
    """One rank's sharded loss, gradients and clip norm for a model of any
    family (``DecoderLM``, ``MambaLM``, ``HybridLM``, ``EncDecLM``) on a
    (data, model) ``DeviceMesh`` (``"pod"`` may lead).
    Every rank of the mesh builds it, in the same order (it makes the
    process groups it needs)."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh
        self.sizes = mesh_axes(mesh)
        if "model" not in self.sizes:
            raise ValueError(f"the mesh has no 'model' axis: {self.sizes}")
        self.data = data_axes(mesh)
        self.dp = math.prod(self.sizes[a] for a in self.data)
        coords = mesh_coords(mesh)
        self.data_index = 0
        self.rows_split = True          # set by local_batch
        for a in self.data:
            self.data_index = self.data_index * self.sizes[a] + coords[a]
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.model_group = self.group(("model",))
        self.data_group = self.group(self.data)
        self.world = self.group(tuple(self.sizes))
        self.specs = param_specs(model, mesh)
        axes = model.param_axes()
        self.uses = self._map(self._use_of, self.specs, axes)
        self.model_rank = coll.group_rank(self.model_group)
        # each leaf's copies over the mesh (axes it is not split over)
        self.copies = [math.prod(self.sizes[a] for a in self.sizes
                                 if a not in {n for e in spec
                                              for n in entry_names(e)})
                       for _, spec in flatten(self.specs)]
        family = model.cfg.family
        # the tree holding the attention and MLP blocks, if any
        layer = self.uses["shared" if family == "hybrid" else
                          "dec_layers" if family == "encdec" else "layers"]
        self.attn_tp = "attn" in layer and layer["attn"]["wq"].model_local
        self.kv_tp = "attn" in layer and layer["attn"]["wk"].model_local
        self.mlp_tp = "mlp" in layer and \
            next(iter(layer["mlp"].values())).model_local
        if "moe" in layer:
            self.expert_tp = layer["moe"]["w_up"].model_local
            self.expert_split = layer["moe"]["w_up"].model_dim == 0
        self.kv_heads = self._kv_heads() if self.attn_tp and not self.kv_tp \
            else None
        self.hooks = {block: (self.f, self.g) for block, on in
                      (("attn", self.attn_tp), ("mlp", self.mlp_tp)) if on}
        if "moe" in layer:
            self.hooks["moe"] = self.moe_shard()
        if "mamba" in self.uses.get("layers", {}):
            shard = self.mamba_shard()
            if shard is not None:
                self.hooks["mamba"] = shard
        self._layer_fwd = {"ssm": self._mamba_layer,
                           "hybrid": self._group}.get(family, self._layer)
        # what ``cm.lm_loss`` reads of a model
        self.cfg, self.device = model.cfg, model.device
        self.compute_dtype = model.compute_dtype

    # -- plan ------------------------------------------------------------
    def group(self, names: Tuple[str, ...]):
        names = tuple(a for a in self.sizes if a in names)
        if names not in self._groups:
            self._groups[names] = coll.mesh_group(self.mesh, names)
        return self._groups[names]

    def _map(self, fn, specs, axes, stacked: bool = False, name: str = ""):
        if isinstance(specs, dict):
            return {k: self._map(fn, specs[k], axes[k],
                                 stacked or k in _STACKS, k) for k in specs}
        if stacked:        # one layer's block: the layer dim is dropped
            specs, axes = specs[1:], axes[1:]
        return fn(specs, axes, name)

    def _use_of(self, spec, axes, name: str) -> LeafUse:
        data_dim, data_names, model_dim, local = None, (), None, False
        for dim, entry in enumerate(spec):
            names = entry_names(entry)
            if "model" in names:
                model_dim = dim
                local = axes[dim] in TP_AXES and name != "router"
            elif names:
                data_dim, data_names = dim, names
        rest = tuple(a for a in self.data if a not in data_names)
        use = LeafUse(data_dim, data_names, rest, model_dim, local)
        for names in (use.data_names, use.data_rest):
            self.group(names)          # made now, in the same order
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

    def mamba_shard(self) -> Optional[MambaShard]:
        """This rank's part of each Mamba2 block where ``inner`` splits
        over ``model`` (None where the rules leave it whole and every rank
        computes the whole block): its heads, the B/C groups they read,
        f and g, the gather of the conv'ed B/C columns and the gate norm's
        sum over ``model``."""
        use = self.uses["layers"]["mamba"]
        if not use["w_x"].model_local:
            return None
        cfg, tp = self.model.cfg, self.sizes["model"]
        s = cfg.ssm
        nh = s.expand * cfg.d_model // s.head_dim
        hpg = nh // s.n_groups
        hl = nh // tp
        h0 = self.model_rank * hl
        if nh % tp or (hl % hpg and hpg % hl):
            raise NotImplementedError(
                f"{cfg.name}: {nh} Mamba2 heads over {tp} model ranks in "
                f"groups of {hpg}: a rank's heads must be whole and not "
                f"straddle a B/C group")
        gather = _same
        if use["w_bc"].model_local:
            def gather(t):
                return coll.gather_data(t, self.model_group, t.dim() - 1)
        return MambaShard(
            h0=h0, nh=hl, g0=h0 // hpg, ng=max(hl // hpg, 1),
            width=nh * s.head_dim, f=self.f, g=self.g, gather=gather,
            norm_sum=lambda t: coll.all_reduce_grad(t, self.model_group))

    def f(self, t: torch.Tensor) -> torch.Tensor:
        """Megatron's f over ``model``."""
        return coll.copy_to_parallel(t, self.model_group)

    def g(self, t: torch.Tensor) -> torch.Tensor:
        """Megatron's g over ``model``."""
        return coll.reduce_from_parallel(t, self.model_group)

    # -- use -------------------------------------------------------------
    def use(self, w: torch.Tensor, u: LeafUse, name: str,
            in_tp: bool = False) -> torch.Tensor:
        """Leaf block ``w`` made whole for use (see :class:`LeafUse`), a
        matrix in the compute dtype; ``in_tp`` marks a leaf replicated over
        ``model`` that feeds rank-local (tensor-parallel) compute."""
        if name not in _F32_LEAVES:
            w = cm.cast(w, self.model.compute_dtype)
        if u.data_names:
            w = coll.gather_data(w, self.group(u.data_names), u.data_dim)
        if u.data_rest:
            w = coll.copy_to_parallel(w, self.group(u.data_rest))
        if u.model_dim is not None and not u.model_local:
            w = coll.gather_replicated(w, self.model_group, u.model_dim)
        elif u.model_dim is None and in_tp:
            w = coll.copy_to_parallel(w, self.model_group)
        return w

    def _use_tree(self, tree, uses, in_tp=()):
        return {k: self._use_tree(v, uses[k], in_tp) if isinstance(v, dict)
                else self.use(v, uses[k], k, k in in_tp)
                for k, v in tree.items()}

    def layer_weights(self, lp, in_tp=(), key: str = "layers"):
        """One layer's blocks ``lp`` of the stacked tree ``key`` made whole
        for use (:meth:`use`)."""
        return self._use_tree(lp, self.uses[key], in_tp)

    def whole(self, params, shared: bool = False):
        """``params`` with every unstacked leaf made whole for use (once a
        step: the embedding, the norms, ``enc_pos``), the stacked layers
        still the rank's blocks; a hybrid's shared block too with
        ``shared`` (serving: once a call), else left for each application
        to make whole (:meth:`_group`)."""
        keep = _STACKS if shared else _STACKS + ("shared",)
        return self._use_tree({k: v for k, v in params.items()
                               if k not in keep}, self.uses) \
            | {k: params[k] for k in keep if k in params}

    def _attn_in_tp(self):
        return ("wk", "wv") if self.attn_tp else ()

    def _own_kv(self, w):
        """Attention blocks of ``w`` with ``wk`` / ``wv`` cut to the KV
        heads the rank's query heads read, where the KV heads are not
        split over ``model``."""
        if self.kv_heads is None:
            return w
        k0, n = self.kv_heads
        return {name: dict(b, wk=b["wk"][:, k0:k0 + n],
                           wv=b["wv"][:, k0:k0 + n])
                if name in ("attn", "cross") else b
                for name, b in w.items()}

    # -- forward: the model's own layer and loss ---------------------------
    def _layer(self, lp, x: torch.Tensor, q_offset: int, window: int):
        """``DecoderLM._layer_fwd`` on the rank's blocks ``lp``, made whole
        for use here (inside the layer's checkpoint, so remat gathers
        again), with f and g around the blocks computed locally."""
        w = self._own_kv(self.layer_weights(lp, self._attn_in_tp()))
        return self.model._layer_fwd(w, x, q_offset, window, tp=self.hooks)

    def _mamba_layer(self, lp, x: torch.Tensor) -> torch.Tensor:
        """``ssm.mamba_layer`` on the rank's blocks ``lp``, made whole for
        use inside the layer's checkpoint, with the rank's
        ``MambaShard``."""
        return mamba_layer(self.layer_weights(lp, _MAMBA_IN_TP), x,
                           self.model.cfg, tp=self.hooks.get("mamba"))

    def _group(self, shared, lps, x: torch.Tensor,
               emb: torch.Tensor) -> torch.Tensor:
        """``HybridLM._group_fwd`` with the shared block and the group's
        layers made whole for use inside the group's checkpoint (so remat
        gathers the shared block again at each application, as the
        reference's scan body does)."""
        sp = self._own_kv(self._use_tree(shared, self.uses["shared"],
                                         self._attn_in_tp()))
        lws = [self.layer_weights(lp, _MAMBA_IN_TP) for lp in lps]
        return self.model._group_fwd(sp, lws, x, emb, tp=self.hooks)

    def enc_layer(self, lp, x: torch.Tensor) -> torch.Tensor:
        """``EncDecLM._enc_body`` on the rank's encoder blocks ``lp``, made
        whole for use (the sharded step's and prefill's encoder layer)."""
        w = self._own_kv(self.layer_weights(lp, self._attn_in_tp(),
                                            "enc_layers"))
        return self.model._enc_body(w, x, tp=self.hooks)

    def _dec_layer(self, lp, x: torch.Tensor,
                   memory: torch.Tensor) -> torch.Tensor:
        w = self._own_kv(self.layer_weights(lp, self._attn_in_tp(),
                                            "dec_layers"))
        return self.model._dec_body(w, x, memory, tp=self.hooks)

    def moe_shard(self, over_data: bool = True) -> cm.MoeShard:
        """This rank's part of ``common.apply_moe`` (see the module
        docstring): its first expert, f and g around the experts and the
        shared expert where they are computed locally over ``model``, and,
        with ``over_data`` and the batch's rows split (training), the
        capacity, the pairs' ranks and the aux means over the data ranks.
        Serving keeps every pair and reads no aux term, so it takes
        ``over_data=False``: no collective over the data axes."""
        moe = self.uses["layers"]["moe"]
        El = self.model.cfg.moe.n_experts // (
            self.sizes["model"] if self.expert_split else 1)
        shard = cm.MoeShard(e0=self.model_rank * El if self.expert_split
                            else 0)
        if self.expert_tp:
            shard = shard._replace(f=self.f, g=self.g)
        if "shared" in moe and moe["shared"]["w_up"].model_local:
            shard = shard._replace(shared=(self.f, self.g))
        if not (over_data and self.rows_split):
            return shard
        return shard._replace(
            data_ranks=self.dp,
            data_sum=lambda t: coll.all_reduce_grad(t, self.data_group),
            before=self._counts_before)

    def _counts_before(self, counts: torch.Tensor) -> torch.Tensor:
        """The (E,) pair counts of the data ranks before this one: an
        exclusive prefix over the data ranks' counts, all-gathered."""
        ranks = torch.arange(self.dp, device=counts.device)[:, None]
        got = coll.all_gather(counts[None], self.data_group)
        return torch.where(ranks < self.data_index, got, 0).sum(0)

    def _embed_input(self, params, tokens, patch_embeds=None):
        """The model's input embedding on the whole embedding (what
        ``cm.lm_loss`` calls for a VLM)."""
        return self.model._embed_input(params, tokens, patch_embeds)

    def forward_hidden(self, params, x: torch.Tensor, remat: bool = True):
        """The model's layer stack over the family's sharded layer
        (:meth:`_layer`, :meth:`_mamba_layer`, :meth:`_group`; what
        ``cm.lm_loss`` calls)."""
        return self.model.forward_hidden(params, x, remat=remat,
                                         layer_fwd=self._layer_fwd)

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return self.model.logits(params, x)

    def loss(self, params, batch: Dict[str, torch.Tensor],
             remat: bool = True):
        """This rank's part of the global mean loss on its blocks
        ``params`` and rows ``batch`` (:meth:`local_batch`), and its
        metrics: the model's own loss (``cm.lm_loss``, run on this step as
        on the model, the embedding and final norm made whole once) times
        the rank's target-token count over the global batch's (over
        ``batch["mask"]`` when given), so that the data ranks' parts add
        up to the global mean, not to a mean of their means.  The metrics'
        ``ce_loss`` is this rank's part too; an MoE model's aux terms are
        global means already.  An encoder-decoder runs its own loss
        (``EncDecLM.loss``) over the sharded layers."""
        if self.model.cfg.family == "encdec":
            loss, metrics = self.model.loss(
                self.whole(params), batch, remat=remat,
                enc_fwd=self.enc_layer, dec_fwd=self._dec_layer)
        else:
            loss, metrics = cm.lm_loss(self, self.whole(params), batch,
                                       remat)
        mask = batch.get("mask")
        if mask is None:
            share = 1.0 / self.dp
        else:
            local = mask.float().sum()
            count = coll.all_reduce(local, self.data_group)
            share = torch.clamp(local, min=1.0) / torch.clamp(count, min=1.0)
        return loss * share, dict(metrics, ce_loss=metrics["ce_loss"] * share)

    def loss_and_grads(self, params, batch, remat: bool = True):
        """(the global loss, metrics, this rank's gradient blocks), as
        ``train.step.loss_and_grads`` returns them unsharded (an MoE
        model's aux terms among the metrics); a leaf that no gradient
        reaches raises."""
        named = flatten(params)
        req = [t.detach().requires_grad_() for _, t in named]
        loss, metrics = self.loss(unflatten_like(params, req), batch, remat)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        missing = [path for (path, _), g in zip(named, grads) if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        metrics = {k: v.detach() for k, v in metrics.items()}
        total = coll.all_reduce(loss.detach(), self.data_group)
        metrics.update(ce_loss=coll.all_reduce(metrics["ce_loss"],
                                               self.data_group), loss=total)
        return total, metrics, unflatten_like(params, list(grads))

    def global_norm(self, grads) -> torch.Tensor:
        """The gradients' global norm over the whole mesh: each rank's
        squared block norms, a leaf's divided by its copies, summed over
        every rank."""
        sq = sum(g.float().square().sum() / n
                 for g, n in zip(leaves(grads), self.copies))
        return torch.sqrt(coll.all_reduce(sq.reshape(1), self.world)[0])

    def local_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (numpy or torch) on the
        model's device, by ``batch_specs``.  Rows that do not split over
        the data axes stay whole on every data rank, as the rules leave
        them replicated (gpt3-xl's 40 rows over 16 data ranks): each data
        rank then computes the whole batch and its loss takes 1/dp of it
        (:meth:`loss`), so the gradients summed over the data axes are
        still the global mean's, and the MoE layer takes its token
        statistics over the rank's (the whole) batch."""
        specs = batch_specs(batch, self.sizes)
        self.rows_split = bool(specs["tokens"])
        if "moe" in self.hooks:
            self.hooks["moe"] = self.moe_shard()
        out = {}
        for k, v in batch.items():
            if specs[k]:
                n = v.shape[0] // self.dp
                v = v[self.data_index * n:(self.data_index + 1) * n]
            out[k] = torch.as_tensor(v, device=self.model.device)
        return out


def init_sharded_state(model, mesh, seed: int = 0,
                       coords: Optional[Dict[str, int]] = None) -> TrainState:
    """This rank's blocks of ``init_train_state(model, seed)``: the global
    parameters drawn as that draws them (on the model's device), each leaf
    cut by the specs as soon as it is drawn and freed, so that one whole
    leaf at most is on the device beside the rank's blocks (llama4-scout's
    f32 tree at 4 layers is 43.5 GB; its largest leaf 10.7 GB); the AdamW
    moments made at the blocks' shapes.  ``coords`` default to this rank's
    on the ``DeviceMesh``; giving them (``mesh`` then a ``MeshSpec`` or an
    axis mapping will do) draws any rank's blocks with no process group."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    sizes = mesh_axes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    specs = dict(flatten(param_specs(model, sizes)))
    local = model.init(gen, dtype=model.param_dtype,
                       put=lambda path, leaf: cut_block(
                           leaf, specs[path], sizes, coords))
    return TrainState(params=local, opt=init_opt_state(local), rng=gen)


__all__ = ["ShardedStep", "LeafUse", "TP_AXES", "init_sharded_state"]
