"""Load the JAX package's parameters into the port.

:func:`params_from_jax` takes the reference's parameter tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``, done by the
caller, so this module never imports JAX) and returns the port's tree with
the same paths, on the model's device: matrices and embeddings in the
compute dtype (serving) or in a given dtype (``dtype=torch.float32`` for
training masters, so both packages train from the same weights), and the
leaves the model's ``leaf_dtype`` keeps in float32 (norm scales and
biases; for ``MambaLM`` also ``dt_bias``, ``A_log`` and ``D``) in float32.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .common import Params


def params_from_jax(model, tree: Mapping, dtype=None) -> Params:
    """Port ``tree`` (nested dicts of numpy arrays) onto ``model``'s device
    and dtypes (matrices in ``dtype``, see ``model.leaf_dtype``); every
    leaf must have the shape the model declares."""
    shapes = model.param_shapes()

    def convert(node, spec, path):
        if set(node) != set(spec):
            raise ValueError(f"{path or 'params'}: keys {sorted(node)} != "
                             f"expected {sorted(spec)}")
        out = {}
        for name, val in node.items():
            where = f"{path}/{name}"
            if isinstance(spec[name], dict):
                out[name] = convert(val, spec[name], where)
                continue
            arr = np.asarray(val, dtype=np.float32)
            if arr.shape != tuple(spec[name]):
                raise ValueError(f"{where}: shape {arr.shape} != "
                                 f"{tuple(spec[name])}")
            out[name] = torch.tensor(arr, device=model.device).to(
                model.leaf_dtype(name, dtype))
        return out

    return convert(tree, shapes, "")
