"""Atomic checkpointing of torch state (npz payload + JSON index).

The port of the JAX package's ``ckpt/checkpoint.py``, with its layout:
``<dir>/ckpt_<step:08d>/proc_<i>.npz`` holds every leaf under its
"/"-joined path, ``index.json`` the step, the leaves' shapes and dtypes and
the caller's ``extra`` dict.  A save writes a temporary directory and
renames it into place, so a reader sees a whole checkpoint or none; the
oldest checkpoints beyond ``keep`` are removed.

State is a tree of nested dicts and dataclasses (``TrainState``) whose
leaves are tensors, numbers or ``torch.Generator``s (saved as their state
bytes).  ``restore`` fills the structure of a template and puts every
tensor on the template leaf's device with its dtype, so a state restores
onto the model's device.  One process; the multi-device slice brings
resharding (the reference's ``elastic.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flatten(tree[key], f"{prefix}/{key}" if prefix
                                else str(key)))
        return out
    return {prefix: tree}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        leaf = leaf.get_state()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:       # numpy has no bf16: keep bits
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Generator):
        return "generator"
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _restore_leaf(template, arr: np.ndarray, path: str):
    if isinstance(template, torch.Generator):
        gen = torch.Generator(device=template.device)
        gen.set_state(torch.from_numpy(arr))
        return gen
    if isinstance(template, torch.Tensor):
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf {path!r}: shape {arr.shape} "
                             f"!= {tuple(template.shape)}")
        t = torch.from_numpy(arr)
        if template.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device=template.device, dtype=template.dtype)
    return type(template)(arr.item())


def _unflatten_like(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _unflatten_like(getattr(template, f.name), flat,
                                    f"{prefix}/{f.name}" if prefix
                                    else f.name)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {key: _unflatten_like(val, flat, f"{prefix}/{key}" if prefix
                                     else str(key))
                for key, val in template.items()}
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    return _restore_leaf(template, flat[prefix], prefix)


class CheckpointManager:
    """save/restore/latest with atomic rename and retention."""

    def __init__(self, directory: str, keep: int = 3,
                 process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.proc = process_index
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}")

    def save(self, step: int, state, extra: Optional[Dict] = None) -> str:
        """Atomically persist ``state`` at ``step``."""
        final = self._step_dir(step)
        tmp = final + f".tmp.{self.proc}.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        flat = _flatten(state)
        arrays = {k: _to_numpy(v) for k, v in flat.items()}
        np.savez(os.path.join(tmp, f"proc_{self.proc}.npz"), **arrays)
        index = {
            "step": step,
            "time": time.time(),
            "n_processes": 1,
            "leaves": {k: {"shape": list(arrays[k].shape),
                           "dtype": _dtype_name(v)}
                       for k, v in flat.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        """(state in the structure of ``template``, index dict) of
        ``step`` (the latest when None); tensors go to the template leaves'
        devices and dtypes."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        data = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    for k in z.files:
                        data[k] = z[k]
        return _unflatten_like(template, data), index

    def restore_extra(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self._step_dir(step), "index.json")) as f:
            return json.load(f).get("extra", {})
