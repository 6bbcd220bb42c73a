"""Collectives of the port: the differentiable exchanges of a data- and
tensor-parallel step, and the MoE token exchange as a true all-to-all.

The port of the JAX package's ``parallel/collectives.py`` over
``torch.distributed``, plus what the reference leaves to GSPMD.

* **Primitives** (:func:`all_gather`, :func:`reduce_scatter`,
  :func:`all_reduce`, :func:`all_to_all`) on a process group.  The
  transport is set by the group's backend, never by catching a failure:
  under ``nccl`` a collective runs on the device tensors; under ``gloo`` on
  explicit host copies (``.cpu()`` before, ``.to(device)`` after; data
  moved as bytes), since gloo's CUDA support is itself host staging and
  differs by version; under ``fake`` (counting on fake tensors) on the
  tensors as given.  Both real backends sum in the tensor's own dtype
  (bf16 partial sums and gradients add in bf16 on either), so they differ
  in transport and in the order of the additions only.  A group of one
  rank runs nothing.  Every call's wire bytes are counted by kind in one place,
  :data:`COUNTER`, with ``analyze_hlo``'s multipliers: an all-gather its
  result's bytes, a reduce-scatter its operand's, an all-reduce twice its
  buffer's, an all-to-all its buffer's (per device, in the tensor's own
  dtype), with the host seconds each kind took (the whole call under
  gloo, copies and wait included; under nccl only the enqueue).
* **Autograd functions.**  Megatron's pair :func:`copy_to_parallel`
  (``f``: identity forward, all-reduce backward) and
  :func:`reduce_from_parallel` (``g``: all-reduce forward, identity
  backward), and both in one, :func:`all_reduce_grad`; :func:`gather_data` (FSDP's gather-on-use over the data
  axes: all-gather forward, reduce-scatter backward);
  :func:`gather_replicated` (a gather-on-use over the model axis where the
  compute that follows is replicated: all-gather forward, the local slice
  backward, since every rank already holds the same full gradient).
  ``torch.distributed.nn.functional`` is not used: its all-reduce
  backward sums again, which is wrong where the loss is computed
  redundantly on every tensor-parallel rank.
* **The MoE exchange** (:func:`moe_all_to_all`,
  :func:`moe_all_to_all_sharded`): each expert-parallel rank buckets its
  tokens by destination rank into fixed-capacity send buffers, one
  all-to-all moves them, the experts run on what arrived, the reverse
  all-to-all returns the results, and a local combine in float32 restores
  token order.  Static shapes need a per-(src, dst) capacity
  ``max(int(cf * T_l * K / ep), 1)``; overflow assignments drop.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
#: wire bytes a call moves, per its buffer's bytes (``analyze_hlo``'s)
_MULT = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 2.0,
         "all-to-all": 1.0}


class CollectiveCounter:
    """Wire bytes, calls and host seconds of the collectives since the
    last reset, by kind."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes: Dict[str, float] = {k: 0.0 for k in KINDS}
        self.calls: Dict[str, int] = {k: 0 for k in KINDS}
        self.seconds: Dict[str, float] = {k: 0.0 for k in KINDS}

    @contextlib.contextmanager
    def count(self, kind: str, nbytes: int):
        """Count one call of ``kind`` moving ``nbytes`` of buffer around
        the block that runs it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[kind] += time.perf_counter() - t0
            self.bytes[kind] += _MULT[kind] * nbytes
            self.calls[kind] += 1


#: every collective of this module counts here
COUNTER = CollectiveCounter()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _on_host(group) -> bool:
    """Whether the group's collectives run on host copies (gloo)."""
    return dist.get_backend(group) == "gloo"


def _bytes_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor."""
    return t.reshape(-1).view(torch.uint8)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in group
    rank order."""
    n = group_size(group)
    if n == 1:
        return x
    x0 = x.movedim(dim, 0).contiguous()
    shape = (n * x0.shape[0],) + tuple(x0.shape[1:])
    with COUNTER.count("all-gather", n * _nbytes(x0)):
        if _on_host(group):
            src = x0.detach().cpu()
            out = torch.empty(shape, dtype=x.dtype)
            dist.all_gather_into_tensor(_bytes_view(out), _bytes_view(src),
                                        group=group)
            out = out.to(x.device)
        else:
            out = x0.new_empty(shape)
            dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of the group's ``x``, this rank's block along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    x0 = x.movedim(dim, 0).contiguous()
    if x0.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split into {n}")
    shape = (x0.shape[0] // n,) + tuple(x0.shape[1:])
    with COUNTER.count("reduce-scatter", _nbytes(x0)):
        if _on_host(group):
            out = torch.empty(shape, dtype=x.dtype)
            dist.reduce_scatter_tensor(out, x0.detach().cpu(), group=group)
            out = out.to(x.device)
        else:
            out = x0.new_empty(shape)
            dist.reduce_scatter_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ``x`` (a new tensor)."""
    if group_size(group) == 1:
        return x
    with COUNTER.count("all-reduce", _nbytes(x)):
        if _on_host(group):
            out = x.detach().to("cpu", copy=True)
            dist.all_reduce(out, group=group)
            return out.to(x.device)
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s dim 0 cut into the group's size of equal blocks, block j
    sent to rank j; the blocks received, concatenated in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split into {n}")
    x = x.contiguous()
    with COUNTER.count("all-to-all", _nbytes(x)):
        if _on_host(group):
            src = x.detach().cpu()
            out = torch.empty_like(src)
            dist.all_to_all_single(_bytes_view(out).view(n, -1),
                                   _bytes_view(src).view(n, -1),
                                   group=group)
            return out.to(x.device)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
    return out


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

class _CopyToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.chunk = dim, x.shape[dim]
        ctx.rank = group_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.chunk, ctx.chunk), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def copy_to_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is; its gradient summed over the
    group (where replicated ``x`` enters rank-local computation)."""
    return x if group_size(group) == 1 else _CopyToParallel.apply(x, group)


def reduce_from_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: the sum of the group's partial ``x``; the
    gradient passes unchanged."""
    return x if group_size(group) == 1 \
        else _ReduceFromParallel.apply(x, group)


def all_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ``x``, its gradient summed over the group
    too (``g`` after ``f``): for a global quantity (an MoE layer's load
    balance over the data ranks' rows) that every rank's part of the loss
    takes a share of."""
    return reduce_from_parallel(copy_to_parallel(x, group), group)


def gather_data(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """FSDP's gather-on-use: the blocks along ``dim`` all-gathered; the
    gradient reduce-scattered back (each rank computed a part of it)."""
    return x if group_size(group) == 1 else _GatherData.apply(x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A gather-on-use feeding replicated compute: the blocks along
    ``dim`` all-gathered; the gradient's local block taken back."""
    return x if group_size(group) == 1 \
        else _GatherReplicated.apply(x, group, dim)


def all_to_all_grad(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all`, differentiable (its gradient the reverse
    exchange)."""
    return x if group_size(group) == 1 else _AllToAll.apply(x, group)


# ---------------------------------------------------------------------------
# Groups of a DeviceMesh
# ---------------------------------------------------------------------------

def mesh_group(mesh, names: Sequence[str]):
    """The process group of this rank's ranks along mesh axes ``names``
    (the others fixed), or None for one rank.  One axis is the mesh's own
    group; every axis of a mesh over the whole world is the world; any
    other set is made with ``dist.new_group`` for each of the mesh's
    partitions, so every rank must call it for the same ``names`` in the
    same order."""
    names = tuple(names)
    dims = mesh.mesh_dim_names
    if not names or all(mesh.mesh.shape[dims.index(n)] == 1 for n in names):
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    if set(names) == set(dims) and mesh.mesh.numel() == dist.get_world_size():
        return dist.group.WORLD
    keep = [dims.index(n) for n in names]
    rest = [i for i in range(len(dims)) if i not in keep]
    width = 1
    for i in keep:
        width *= mesh.mesh.shape[i]
    layout = mesh.mesh.permute(rest + keep).reshape(-1, width)
    mine = None
    for ranks in layout.tolist():
        group = dist.new_group(sorted(ranks))
        if dist.get_rank() in ranks:
            mine = group
    return mine


# ---------------------------------------------------------------------------
# MoE all-to-all
# ---------------------------------------------------------------------------

def _dest_positions(flat_e: torch.Tensor, ep: int, experts_per_shard: int):
    """(destination rank of each assignment, its rank within that
    destination's bucket, in assignment order)."""
    dest = torch.div(flat_e, experts_per_shard, rounding_mode="floor")
    oh = F.one_hot(dest.long(), ep)
    pos_all = oh.cumsum(0) - oh
    return dest.long(), pos_all.gather(1, dest.long()[:, None])[:, 0]


def _bucket_by_dest(x_rep, flat_e, ep: int, experts_per_shard: int,
                    capacity: int):
    """Rank-local: route the (T_l*K) assignments into (ep, C) slots.

    Returns send buffers x_send (ep, C, d) and meta (ep, C, 2) holding
    (local assignment index + 1, the expert's index on its rank); an
    assignment past its bucket's capacity drops (written to a discarded
    slot C, as the reference's ``mode="drop"``)."""
    TK, d = x_rep.shape
    dest, pos = _dest_positions(flat_e, ep, experts_per_shard)
    slot = torch.where(pos < capacity, pos, capacity)
    x_send = x_rep.new_zeros((ep, capacity + 1, d))
    x_send = x_send.index_put((dest, slot), x_rep)
    meta = torch.zeros((ep, capacity + 1, 2), dtype=torch.int32,
                       device=x_rep.device)
    src = torch.arange(1, TK + 1, dtype=torch.int32, device=x_rep.device)
    meta[dest, slot, 0] = src
    meta[dest, slot, 1] = (flat_e % experts_per_shard).to(torch.int32)
    return x_send[:, :capacity], meta[:, :capacity].contiguous()


def a2a_capacity(n_tokens: int, top_k: int, ep: int,
                 capacity_factor: float) -> int:
    """The per-(src, dst) capacity of :func:`moe_all_to_all`."""
    return max(int(capacity_factor * n_tokens * top_k / ep), 1)


def dropped_assignments(top_e: torch.Tensor, *, n_experts: int, ep: int,
                        capacity_factor: float = 2.0) -> int:
    """How many of a rank's (T_l, K) assignments :func:`moe_all_to_all`
    drops at ``capacity_factor``."""
    T_l, K = top_e.shape
    _, pos = _dest_positions(top_e.reshape(-1), ep, n_experts // ep)
    return int((pos >= a2a_capacity(T_l, K, ep, capacity_factor)).sum())


def moe_all_to_all(xt, top_e, top_w, expert_fn: Callable, *,
                   n_experts: int, group, capacity_factor: float = 2.0):
    """Run ``expert_fn`` over tokens through an explicit all-to-all.

    Called on every rank of ``group`` (the expert-parallel ranks, which own
    the experts rank-major: rank r has experts r*E/ep .. (r+1)*E/ep - 1).
    xt: (T_l, d) this rank's tokens; top_e/top_w: (T_l, K) their routing.
    ``expert_fn(local_expert_idx, x)`` applies the rank's experts
    ((n_recv,) ids + (n_recv, d) -> (n_recv, d)).  Returns (T_l, d)
    combined outputs; differentiable in xt, top_w and what ``expert_fn``
    reads."""
    ep = group_size(group)
    experts_per_shard = n_experts // ep
    T_l, K = top_e.shape
    d = xt.shape[-1]
    TK = T_l * K
    capacity = a2a_capacity(T_l, K, ep, capacity_factor)

    x_rep = xt.repeat_interleave(K, dim=0)               # (TK, d)
    flat_e = top_e.reshape(TK)
    x_send, meta = _bucket_by_dest(x_rep, flat_e, ep, experts_per_shard,
                                   capacity)
    # the exchange: (ep, C, d) -> (ep, C, d) with src/dst transposed
    x_recv = all_to_all_grad(x_send, group)
    meta_recv = all_to_all(meta, group)

    flat_x = x_recv.reshape(ep * capacity, d)
    local_eid = meta_recv[..., 1].reshape(ep * capacity).long()
    valid = meta_recv[..., 0].reshape(ep * capacity) > 0
    y = expert_fn(local_eid, flat_x)
    y = torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype,
                                                   device=y.device))
    y = y.to(xt.dtype)

    # reverse exchange + rank-local combine
    y_back = all_to_all_grad(y.reshape(ep, capacity, d), group)
    src = meta[..., 0].reshape(ep * capacity).long()
    out_assign = torch.zeros((TK + 1, d), dtype=torch.float32,
                             device=xt.device)
    out_assign = out_assign.index_add(
        0, src, y_back.reshape(ep * capacity, d).float())[1:]
    out = (out_assign.reshape(T_l, K, d)
           * top_w[..., None].float()).sum(dim=1)
    return out.to(xt.dtype)


def moe_all_to_all_sharded(mesh, xt, top_e, top_w, expert_weights,
                           activation_fn: Callable, *, n_experts: int,
                           axis_name: str = "model",
                           capacity_factor: float = 2.0):
    """The reference's ``shard_map`` wrapper: xt (T, d), top_e/top_w
    (T, K) and every expert weight (leading dim E) are global, on every
    rank of the mesh's ``axis_name``; this rank takes its block of the
    tokens and of the experts, runs :func:`moe_all_to_all` with
    ``activation_fn(local_eid, x, local_weights)``, and the ranks' (T/ep,
    d) outputs are gathered into the global (T, d) on every rank."""
    group = mesh.get_group(axis_name)
    ep, r = group_size(group), group_rank(group)
    T = xt.shape[0]
    if T % ep or n_experts % ep:
        raise ValueError(f"{T} tokens and {n_experts} experts must split "
                         f"over {ep} ranks")
    tl, el = T // ep, n_experts // ep
    rows = slice(r * tl, (r + 1) * tl)
    weights_l = tuple(w[r * el:(r + 1) * el] for w in expert_weights)
    out = moe_all_to_all(
        xt[rows], top_e[rows], top_w[rows],
        lambda eid, x: activation_fn(eid, x, weights_l),
        n_experts=n_experts, group=group, capacity_factor=capacity_factor)
    return gather_replicated(out, group, 0)


__all__ = ["KINDS", "CollectiveCounter", "COUNTER", "group_size",
           "group_rank", "all_gather", "reduce_scatter", "all_reduce",
           "all_to_all", "copy_to_parallel", "reduce_from_parallel",
           "all_reduce_grad", "gather_data", "gather_replicated",
           "all_to_all_grad",
           "mesh_group", "a2a_capacity", "dropped_assignments",
           "moe_all_to_all", "moe_all_to_all_sharded"]
