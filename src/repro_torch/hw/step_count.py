"""FLOPs and HBM bytes of one step of the port, counted as it dispatches.

The counterpart of the JAX package's ``hw/hlo_parse.py``: where the
reference parses the compiled step's optimized HLO, the port runs the
step once, eagerly, under ``torch.utils.flop_counter.FlopCounterMode`` and
a byte-counting ``TorchDispatchMode``, on fake CPU tensors (a
``FakeTensorMode``: shapes and dtypes only, nothing is computed or
allocated, so a full-width step is counted without a card and without its
memory).  The kernel wrappers see CPU tensors and take their plain
versions, so no launch is counted.

* **FLOPs** are the matrix products' only, as ``analyze_hlo`` counts dots
  only: ``FlopCounterMode``'s formulas (``mm``, ``bmm``, ``addmm``, ...)
  plus :func:`grouped_mm_flop` for ``torch._grouped_mm``, which carries
  the MoE experts' products and has no formula there.
* **HBM bytes** are each aten op's operands and results, each tensor once
  an op, over the elements its strides reach (a broadcast dim counts
  once); a view or an aliasing op, and an allocation, move nothing.  In
  eager PyTorch every aten op is a kernel boundary, as a fusion is in the
  reference's HLO, so these are the bytes of the plain eager path (the
  plain attention's score matrices included), not those of the
  hand-written kernels, which keep the scores on chip.
* PyTorch runs every layer and every micro-batch, so each is counted as
  it runs; remat's recompute is counted, as the reference's HLO holds it.
  No trip-count correction is needed.
* **Collective bytes** are the wire bytes of the collectives the step
  called, per device, by kind (``parallel.collectives.COUNTER``, with
  ``analyze_hlo``'s multipliers): ``{}`` on one device.
  ``count_train_step(..., mesh=)`` counts one rank's step of the data- and
  tensor-parallel step (rank 0's, whose blocks are every rank's shapes)
  under the ``fake`` process group, whose collectives move nothing: its
  FLOPs, HBM bytes, collective bytes and its state's bytes are one
  device's.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode

_aten = torch.ops.aten
# ops that allocate or relabel storage without reading or writing it
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view}


@dataclass
class StepCount:
    """What one run of a step dispatched: the fields of the reference's
    ``HloAnalysis`` (matrix-product FLOPs, HBM bytes, collective bytes by
    kind), ``by_op``: aten op name -> ``{"calls", "flops", "hbm_bytes"}``,
    and (from ``count_train_step``) ``state_bytes``, the bytes of the
    device's training state (parameters, AdamW moments, step)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    by_op: Dict[str, Dict[str, float]] = field(default_factory=dict)
    state_bytes: float = 0.0

    def top(self, n: int = 5, key: str = "flops"
            ) -> List[Tuple[str, Dict[str, float]]]:
        """The ``n`` ops with the most ``key``, most first."""
        return sorted(self.by_op.items(), key=lambda kv: -kv[1][key])[:n]


def grouped_mm_flop(a_shape, b_shape, *args, out_shape=None,
                    **kwargs) -> int:
    """FLOPs of ``torch._grouped_mm(a, b, offs)``: 2 · M · K · N over the
    groups together.  Every row (or column) falls in one group, so the
    count needs the shapes only, not the offsets' values, and holds on
    fake tensors.  (M, K) x (G, K, N) groups a's rows (the experts'
    forward and their input gradient); (M, K) x (K, N) -> (G, M, N)
    groups the contraction (their weight gradient); (G, M, K) x (K, N)
    groups b's columns; (G, M, K) x (G, K, N) is a batch of G products."""
    if len(a_shape) == 3 and len(b_shape) == 3:
        return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[2]
    M, K = a_shape[-2:]
    return 2 * M * K * b_shape[-1]


#: ``FlopCounterMode``'s ``custom_mapping``: the formulas it lacks
FLOP_FORMULAS = {_aten._grouped_mm: grouped_mm_flop}


def _spanned_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t``'s strides reach: a broadcast (stride 0)
    dim counts once."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _bytes_once(tree) -> int:
    seen = {id(t): t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}
    return sum(_spanned_bytes(t) for t in seen.values())


class _Traffic(TorchDispatchMode):
    """Counts each aten op's calls and the bytes of its operands (each
    tensor once) plus those of its results (each once)."""

    def __init__(self):
        super().__init__()
        self.calls: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out      # a metadata query (``prim.device`` on a fake)
        name = str(func._overloadpacket)
        self.calls[name] += 1
        if not (func.is_view or func._overloadpacket in _NO_TRAFFIC):
            self.bytes[name] += _bytes_once((args, kwargs)) + _bytes_once(out)
        return out


def count_step(fn: Callable, *args, **kwargs) -> StepCount:
    """Run ``fn(*args, **kwargs)`` once under the counters and return what
    it dispatched.  Give it fake tensors (made inside a ``FakeTensorMode``,
    and call it there) to count a step at any size without running it; on
    real tensors it runs and counts the same."""
    from ..parallel.collectives import COUNTER
    flops = FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS)
    traffic = _Traffic()
    before = dict(COUNTER.bytes)
    with flops, traffic:
        fn(*args, **kwargs)
    wire = {k: v - before[k] for k, v in COUNTER.bytes.items()
            if v != before[k]}
    by_flops = {str(op): n for op, n in
                flops.get_flop_counts().get("Global", {}).items()}
    by_op = {name: {"calls": float(traffic.calls[name]),
                    "flops": float(by_flops.get(name, 0)),
                    "hbm_bytes": float(traffic.bytes.get(name, 0))}
             for name in traffic.calls}
    return StepCount(flops=float(sum(by_flops.values())),
                     hbm_bytes=float(sum(traffic.bytes.values())),
                     collective_bytes=wire, by_op=by_op)


def fake_like(tree):
    """Each tensor of ``tree`` (meta tensors, as ``abstract_params`` gives)
    as a fake CPU tensor of its shape and dtype; call it inside a
    ``FakeTensorMode``."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="cpu"), tree)


@contextlib.contextmanager
def fake_world(mesh):
    """A ``DeviceMesh`` of ``mesh``'s axes over a ``fake`` process group
    of its size, this process rank 0, destroyed on exit: collectives
    complete at once and move nothing (``mesh``: a ``MeshSpec`` or an axis
    name -> extent mapping; no other process group may be initialized)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from ..parallel.sharding import mesh_axes
    axes = mesh_axes(mesh)
    n = 1
    for size in axes.values():
        n *= size
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh("cpu", tuple(axes.values()),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def _state_bytes(state) -> float:
    return float(sum(t.numel() * t.element_size() for t in
                     tree_leaves((state.params, state.opt))
                     if isinstance(t, torch.Tensor)))


def count_train_step(cfg, *, global_batch: int, seq_len: int,
                     accum_steps: int = 1, mesh=None) -> StepCount:
    """One ``make_train_step`` step of ``cfg`` at full size, as the
    ``Trainer`` runs it (AdamW at ``OptimizerConfig()``'s settings, remat),
    on fake CPU tensors: f32 masters (``abstract_params(param_dtype)``),
    AdamW state, a batch of ``global_batch`` rows of ``seq_len`` tokens and
    targets (what ``DataPipeline`` gives; a model whose loss takes more,
    frames or patch rows, is not counted here), ``accum_steps``
    micro-batches.  With ``mesh`` (a ``MeshSpec`` or an axis name ->
    extent mapping) it counts one rank's step of the sharded step on that
    mesh under :func:`fake_world`: the rank's blocks of the state by
    ``param_specs``, its rows of the batch, its collectives' bytes."""
    from ..models import build_model
    from ..train import OptimizerConfig, make_train_step
    from ..train.optimizer import init_opt_state
    from ..train.step import TrainState
    with contextlib.ExitStack() as stack:
        model = build_model(cfg, device="cpu")
        dmesh = None if mesh is None else stack.enter_context(
            fake_world(mesh))
        # the plan reads the mesh's tensors, which must stay real
        step = make_train_step(model, OptimizerConfig(),
                               accum_steps=accum_steps, remat=True,
                               mesh=dmesh)
        if dmesh is not None:
            from ..parallel.sharding import (mesh_axes, mesh_coords,
                                             param_specs, shard_state)
            cut = (mesh_axes(dmesh), param_specs(model, dmesh),
                   mesh_coords(dmesh))
        stack.enter_context(FakeTensorMode())
        params = fake_like(model.abstract_params(model.param_dtype))
        if dmesh is not None:
            params = shard_state(params, cut[0], cut[1], coords=cut[2])
        state = TrainState(params=params, opt=init_opt_state(params),
                           rng=None)
        tokens = torch.zeros((global_batch, seq_len), dtype=torch.int32)
        count = count_step(step, state, {"tokens": tokens,
                                         "targets": tokens})
        count.state_bytes = _state_bytes(state)
        return count


__all__ = ["StepCount", "count_step", "count_train_step", "fake_like",
           "fake_world",
           "grouped_mm_flop", "FLOP_FORMULAS"]
