"""Sharding rules: logical axes -> mesh specs (FSDP + TP + EP + SP).

The port of the JAX package's ``parallel/sharding.py``.  Every parameter
declares logical axis names (``models.common.Leaf``, read through the
model's ``param_axes()``); this module maps them onto a mesh:

* ``heads``/``kv``/``mlp``/``vocab``/``experts``/``inner`` -> ``model``
  (tensor/expert parallelism),
* ``embed`` -> the data axes (``("pod", "data")``) -- ZeRO-3/FSDP weight
  sharding,
* anything else -> replicated.

A dim is only sharded if its size divides the mesh-axis product; each mesh
axis is used at most once per array.  KV caches get their own rules: batch
-> data axes, and the sequence dim of decode caches over the model (and,
for single-sequence long context, also the data) axes.

A spec is a tuple with one entry a dim -- ``None``, a mesh-axis name, or a
tuple of names (that dim split over all of them, the first major) --
without trailing ``None``s, equal to ``tuple()`` of the reference's
``PartitionSpec``.  The rules read axis names and extents only, so they
run on a :class:`~repro_torch.launch.mesh.MeshSpec`, a mapping of axis
name to extent, or a ``DeviceMesh``, with no process group, as the
reference's run on an ``AbstractMesh``.  :func:`placements` turns a spec
into DTensor placements on a ``DeviceMesh``; :func:`shard_state` cuts a
global state into one rank's local blocks by the specs and
:func:`gather_state` puts the global tensors back together.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..launch.mesh import MeshSpec
from ..train.step import TrainState

Spec = Tuple[Any, ...]

LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "inner": ("model",),
    "embed": ("fsdp",),          # resolved to the data axes below
}


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> extent of ``mesh`` (a ``MeshSpec``, a mapping, or a
    ``DeviceMesh``), in the mesh's order."""
    if isinstance(mesh, MeshSpec):
        return mesh.axes()
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"not a mesh: {mesh!r}")
    return dict(zip(names, (int(s) for s in mesh.mesh.shape)))


def data_axes(mesh) -> Tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def _axis_size(axes: Dict[str, int], names: Sequence[str]) -> int:
    return math.prod(axes[n] for n in names)


def entry_names(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(names: Tuple[str, ...]):
    return names[0] if len(names) == 1 else names


def _strip(entries: list) -> Spec:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_for_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                  mesh) -> Spec:
    """The spec of one array given its logical axes and shape."""
    sizes = mesh_axes(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        assign = None
        if name is not None and name in LOGICAL_RULES:
            cand = LOGICAL_RULES[name]
            if cand == ("fsdp",):
                cand = data_axes(mesh)
            cand = tuple(a for a in cand if a in sizes and a not in used)
            if cand and dim % _axis_size(sizes, cand) == 0:
                assign = _entry(cand)
                used.update(cand)
            elif len(cand) > 1:
                # a suffix (e.g. just "data" when pod doesn't divide)
                for k in range(1, len(cand)):
                    sub = cand[k:]
                    if dim % _axis_size(sizes, sub) == 0:
                        assign = _entry(sub)
                        used.update(sub)
                        break
        entries.append(assign)
    return _strip(entries)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def param_specs(model, mesh):
    """The spec tree of a model's parameters."""
    return _map2(lambda axes, shape: spec_for_axes(axes, shape, mesh),
                 model.param_axes(), model.param_shapes())


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def batch_specs(specs: Dict[str, Any], mesh) -> Dict[str, Spec]:
    """Input-batch specs: the leading (global-batch) dim over the data
    axes, everything else replicated.  ``specs`` maps input names to
    tensors or shapes; a ``"cache"`` entry is skipped."""
    dp = data_axes(mesh)
    dp_size = _axis_size(mesh_axes(mesh), dp)

    def spec(x):
        shape = _shape(x)
        if shape and shape[0] % dp_size == 0 and shape[0] > 1:
            return (_entry(dp),)
        return ()

    return {k: spec(v) for k, v in specs.items() if k != "cache"}


_SEQ_MIN = 1024  # dims >= this in a cache leaf are treated as sequence dims


def cache_specs(cache_tree, mesh):
    """Specs of decode caches (leaves: tensors, shapes or ``LeafSpec``s).

    Layout conventions (all families): leading dim(s) = layer/group stack;
    one batch dim == global_batch (dim 1, or dim 2 for 6-dim local-ring
    caches); optionally a long sequence dim (the largest dim >= 1024 past
    dim 0).  Rules: batch -> data axes when divisible; the sequence dim ->
    model axis (plus the data axes when the batch could not use them:
    context-parallel single-sequence decode); with no sequence dim (an SSM
    state) the last dim past the batch that the model axis divides."""
    sizes = mesh_axes(mesh)
    dp = data_axes(mesh)
    dp_size = _axis_size(sizes, dp)
    model_size = sizes["model"]

    def spec(x):
        shape = list(_shape(x))
        entries: list = [None] * len(shape)
        seq_dim = None
        for i in range(1, len(shape)):
            if shape[i] >= _SEQ_MIN and (seq_dim is None
                                         or shape[i] > shape[seq_dim]):
                seq_dim = i
        batch_dim = 2 if len(shape) == 6 else 1
        batch_ok = shape[batch_dim] % dp_size == 0 and shape[batch_dim] > 1
        if batch_ok:
            entries[batch_dim] = _entry(dp)
        if seq_dim is not None and seq_dim != batch_dim:
            axes = ("model",) if batch_ok else tuple(dp) + ("model",)
            if shape[seq_dim] % _axis_size(sizes, axes) == 0:
                entries[seq_dim] = _entry(axes)
            elif shape[seq_dim] % model_size == 0:
                entries[seq_dim] = "model"
        else:
            for i in range(len(shape) - 1, batch_dim, -1):
                if shape[i] % model_size == 0 and shape[i] >= model_size:
                    entries[i] = "model"
                    break
        return _strip(entries)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return spec(tree)
    return walk(cache_tree)


def input_shardings(model, shape, mesh) -> Dict[str, Any]:
    """The specs of ``model.input_specs(shape)`` on ``mesh``, in its
    order: each input by :func:`batch_specs`, the decode cache's leaves by
    :func:`cache_specs` (the reference's ``input_shardings``, which
    attaches them to ``ShapeDtypeStruct``s for lowering)."""
    specs = model.input_specs(shape)
    batch = batch_specs(specs, mesh)
    return {k: cache_specs(v, mesh) if k == "cache" else batch[k]
            for k, v in specs.items()}


def state_shardings(model, mesh):
    """Specs of a ``TrainState``: params and the AdamW moments by the
    parameter specs, the step and the generator replicated."""
    pspec = param_specs(model, mesh)
    return {"params": pspec, "opt": {"m": pspec, "v": pspec, "step": ()},
            "rng": ()}


def placements(spec: Spec, mesh):
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one
    a mesh dim, ``Shard(d)`` where tensor dim d is split over that mesh
    axis, else ``Replicate()``.  A dim split over several axes shards on
    each of them, the first major, which is DTensor's default order and
    JAX's."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, entry in enumerate(spec):
        for name in entry_names(entry):
            out[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return tuple(out)


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of the ``DeviceMesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def rank_coords(mesh) -> Dict[int, Dict[str, int]]:
    """Every rank's coordinates on the ``DeviceMesh``."""
    names = mesh.mesh_dim_names
    out = {}
    for idx in torch.cartesian_prod(*[torch.arange(s) for s in
                                      mesh.mesh.shape]).reshape(
                                          -1, len(names)).tolist():
        out[int(mesh.mesh[tuple(idx)])] = dict(zip(names, idx))
    return out


def local_slices(shape, spec: Spec, sizes: Dict[str, int],
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The block of a global array of ``shape`` that the rank at
    ``coords`` holds under ``spec``: a dim split over axes (a1, a2, ...)
    is cut into their product of equal parts, and the rank takes the part
    at its coordinates' ravel, the first axis major."""
    out = []
    for dim, size in enumerate(shape):
        names = entry_names(spec[dim]) if dim < len(spec) else ()
        parts, index = 1, 0
        for n in names:
            parts, index = parts * sizes[n], index * sizes[n] + coords[n]
        if size % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {parts} ({spec})")
        chunk = size // parts
        out.append(slice(index * chunk, (index + 1) * chunk))
    return tuple(out)


def local_shape(shape, spec: Spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one rank's block of a global array under ``spec``."""
    zero = {n: 0 for n in sizes}
    return tuple(s.stop - s.start for s in
                 local_slices(shape, spec, sizes, zero))


def _walk_state(fn, state, specs):
    """``fn(leaf, spec)`` over the tensor leaves of a state tree (dicts and
    a ``TrainState``) beside its spec tree; other leaves pass through."""
    if isinstance(state, TrainState):
        return TrainState(params=_walk_state(fn, state.params,
                                             specs["params"]),
                          opt=_walk_state(fn, state.opt, specs["opt"]),
                          rng=state.rng)
    if isinstance(state, dict):
        return {k: _walk_state(fn, v, specs[k]) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return fn(state, specs)
    return state


def cut_block(t: torch.Tensor, spec: Spec, sizes: Dict[str, int],
              coords: Dict[str, int]) -> torch.Tensor:
    """The block of the global tensor ``t`` that the rank at ``coords``
    holds under ``spec`` (:func:`local_slices`), as a contiguous copy."""
    return t[local_slices(t.shape, spec, sizes, coords)].clone(
        memory_format=torch.contiguous_format)


def shard_state(state, mesh, specs, coords: Optional[Dict[str, int]] = None):
    """This rank's local blocks of a global state (a parameter tree, or a
    ``TrainState`` with ``specs`` from :func:`state_shardings`), each a
    contiguous copy.  ``coords`` default to this rank's on the
    ``DeviceMesh``; giving them cuts any rank's blocks with no process
    group."""
    sizes = mesh_axes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    return _walk_state(lambda t, spec: cut_block(t, spec, sizes, coords),
                       state, specs)


def gather_state(state, mesh, specs):
    """The global tensors of a sharded state (the inverse of
    :func:`shard_state`), on every rank: each sharded leaf's blocks are
    all-gathered over the whole mesh and placed by the ranks'
    coordinates; replicated leaves are returned as they are.  Every rank
    of the mesh must call it (a collective), in the same order."""
    from .collectives import all_gather, mesh_group
    sizes = mesh_axes(mesh)
    coords = rank_coords(mesh)
    group = mesh_group(mesh, tuple(sizes))
    ranks = sorted(coords)

    def gather(t, spec):
        if not spec:
            return t
        blocks = all_gather(t.contiguous()[None], group).unbind(0)
        shape = [s * _axis_size(sizes, entry_names(spec[d]))
                 if d < len(spec) else s for d, s in enumerate(t.shape)]
        out = t.new_empty(shape)
        for rank, block in zip(ranks, blocks):
            out[local_slices(shape, spec, sizes, coords[rank])] = block
        return out
    return _walk_state(gather, state, specs)


__all__ = ["LOGICAL_RULES", "mesh_axes", "data_axes", "entry_names",
           "spec_for_axes", "param_specs", "batch_specs", "cache_specs",
           "input_shardings",
           "state_shardings", "placements", "mesh_coords", "rank_coords",
           "local_slices", "local_shape", "cut_block", "shard_state",
           "gather_state"]
