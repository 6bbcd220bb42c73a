"""Elastic resharding: restore a checkpoint onto a different mesh.

The port of the JAX package's ``ckpt/elastic.py``.  A checkpoint stores
logical (global) arrays (``CheckpointManager.save`` of a global state, or
``save_sharded`` of a sharded one); :func:`reshard_restore` places each
leaf's local block by the specs of the *new* mesh -- the core of elastic
scaling (grow or shrink the data axis between jobs, restart on the ranks
that survived).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.sharding import local_slices, mesh_axes, mesh_coords
from .checkpoint import CheckpointManager, _restore_leaf, _unflatten_like


def reshard_restore(manager: CheckpointManager, template, mesh, spec_tree,
                    step: Optional[int] = None, device=None):
    """(this rank's state, index dict) of checkpoint ``step`` (the latest
    when None): ``template`` is a state of the *global* shapes (meta
    tensors will do) whose structure and dtypes the result takes, and each
    tensor leaf becomes this rank's block under its spec in ``spec_tree``
    on the ``DeviceMesh`` ``mesh``, on ``device`` (the template leaf's, or
    the CPU for a meta leaf)."""
    data, index = manager.load(step)
    sizes = mesh_axes(mesh)
    coords = mesh_coords(mesh)
    flat_specs = {}

    def walk(specs, prefix=""):
        if isinstance(specs, dict):
            for k, v in specs.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            flat_specs[prefix] = specs
    walk(spec_tree)

    def spec_of(path):
        while path not in flat_specs:        # a replicated subtree: ()
            if "/" not in path:
                return ()
            path = path.rsplit("/", 1)[0]
        return flat_specs[path]

    def restore_leaf(template_leaf, arr: np.ndarray, path: str):
        if not isinstance(template_leaf, torch.Tensor):
            return _restore_leaf(template_leaf, arr, path)
        if tuple(arr.shape) != tuple(template_leaf.shape):
            raise ValueError(f"checkpoint leaf {path!r}: shape {arr.shape} "
                             f"!= {tuple(template_leaf.shape)}")
        block = np.ascontiguousarray(
            arr[local_slices(arr.shape, spec_of(path), sizes, coords)])
        dev = device or (template_leaf.device
                         if template_leaf.device.type != "meta" else "cpu")
        local = torch.empty(block.shape, dtype=template_leaf.dtype,
                            device=dev)
        return _restore_leaf(local, block, path)

    return _unflatten_like(template, data, restore_leaf=restore_leaf), index


__all__ = ["reshard_restore"]
