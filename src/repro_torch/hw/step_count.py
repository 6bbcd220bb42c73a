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
  tensor-parallel step, :func:`count_prefill` and :func:`count_decode`
  one rank's sharded prefill and decode step
  (``parallel.serve_step.ShardedServe``), under the ``fake`` process
  group, whose collectives move nothing: the FLOPs, HBM bytes,
  collective bytes and memory are one device's.  Rank 0 stands for every
  rank: ``spec_for_axes`` splits a dim only where it divides, so every
  rank's blocks have rank 0's shapes.  An MoE layer's expert products
  are counted over all the rank's routed pairs (fake tensors carry no
  routing, so the grouped product's rows are its operand's): the worst
  case, where every pair goes to the rank's own experts.
* **Memory.**  ``resident_bytes`` are what the rank holds across steps,
  exact from the specs: its blocks of the parameters (and AdamW moments
  and step, in training), of the decode cache and of the inputs.
  ``peak_bytes`` is the high-water mark of the bytes of the storages the
  run allocates and holds at once, beyond those it was given, traced on
  the fake tensors as they are made and freed.  It is the plain path's
  (fake tensors take the kernels' plain versions, whose attention score
  blocks the kernels never hold), so it bounds the card's from above
  there.
"""
from __future__ import annotations

import contextlib
import math
import weakref
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
    ``peak_bytes``, the high-water mark of the bytes the run allocated
    and held at once; from ``count_train_step`` ``state_bytes``, the
    bytes of the device's training state (parameters, AdamW moments,
    step), and from the ``count_*`` functions ``resident_bytes``, the
    device's state, cache and input blocks."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    by_op: Dict[str, Dict[str, float]] = field(default_factory=dict)
    state_bytes: float = 0.0
    peak_bytes: float = 0.0
    resident_bytes: float = 0.0

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


class _Live(TorchDispatchMode):
    """The high-water mark of the bytes of the storages that ops allocate
    while the mode is on and that are alive at once.  An op whose schema
    says a result aliases an input (a view, an in-place or ``out=`` op)
    allocates nothing; every other op's results are new storages, each
    counted from the op that made it until it is freed (a weak reference
    to its storage's Python object, which lives as long as the storage,
    drops it from the count)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._known: Dict[int, object] = {}
        self._aliases: Dict[object, bool] = {}

    def _forget(self, key: int, nbytes: int, _ref) -> None:
        self.live -= nbytes
        self._known.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aliases = self._aliases.get(func)
        if aliases is None:
            aliases = self._aliases[func] = any(
                r.alias_info is not None for r in func._schema.returns)
        if aliases:
            return out
        for t in (out,) if isinstance(out, torch.Tensor) else \
                tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self._known[key] = weakref.ref(st, lambda r, k=key, n=n:
                                           self._forget(k, n, r))
            self.live += n
            if self.live > self.peak:
                self.peak = self.live
        return out


def count_step(fn: Callable, *args, **kwargs) -> StepCount:
    """Run ``fn(*args, **kwargs)`` once under the counters and return what
    it dispatched.  Give it fake tensors (made inside a ``FakeTensorMode``,
    and call it there) to count a step at any size without running it; on
    real tensors it runs and counts the same."""
    from ..parallel.collectives import COUNTER
    flops = FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS)
    traffic = _Traffic()
    live = _Live()
    before = dict(COUNTER.bytes)
    with flops, traffic, live:
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
                     collective_bytes=wire, by_op=by_op,
                     peak_bytes=float(live.peak))


def fake_like(tree):
    """Each tensor of ``tree`` (meta tensors, as ``abstract_params`` gives)
    as a fake CPU tensor of its shape and dtype; call it inside a
    ``FakeTensorMode``."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="cpu"), tree)


@contextlib.contextmanager
def fake_world(mesh, make: Callable = None, rank: int = 0):
    """A ``DeviceMesh`` of ``mesh``'s axes over a ``fake`` process group
    of its size, this process rank ``rank`` (0 by default), destroyed on
    exit: collectives complete at once and move nothing (``mesh``: a
    ``MeshSpec`` or an axis name -> extent mapping; no other process group
    may be initialized).
    ``make``, when given, builds the mesh on the fake world (the dry run's
    ``make_production_mesh``)."""
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
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield make() if make is not None else init_device_mesh(
            "cpu", tuple(axes.values()), mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def _world(mesh):
    """``mesh`` itself where it is a ``DeviceMesh`` (a fake world the
    caller holds open), else :func:`fake_world` of its axes."""
    if hasattr(mesh, "mesh_dim_names"):
        return contextlib.nullcontext(mesh)
    return fake_world(mesh)


def _state_bytes(state) -> float:
    return float(sum(t.numel() * t.element_size() for t in
                     tree_leaves((state.params, state.opt))
                     if isinstance(t, torch.Tensor)))


def resident_bytes(model, inputs, mesh=None, train: bool = False) -> float:
    """The bytes one rank holds across steps, from the specs alone: its
    blocks of the parameters in ``param_dtype`` by ``param_specs`` (with
    ``train``, of the float32 AdamW moments too, and the int32 step), and
    of ``inputs`` (a model's ``input_specs``, global shapes): each input
    by ``batch_specs``, a decode cache's leaves by ``cache_specs``.
    ``mesh`` (a ``MeshSpec``, a mapping or a ``DeviceMesh``) None for one
    device."""
    from ..parallel.sharding import (batch_specs, cache_specs, local_shape,
                                     mesh_axes, param_specs)
    from ..tree import flatten
    sizes = {} if mesh is None else mesh_axes(mesh)

    def block(t, spec) -> int:
        return math.prod(local_shape(t.shape, spec, sizes)) \
            * t.element_size()
    pspecs = dict(flatten(param_specs(model, sizes))) if sizes else {}
    total = 0.0
    for path, p in flatten(model.abstract_params(model.param_dtype)):
        n = block(p, pspecs.get(path, ()))
        total += n + (2 * n * 4 // p.element_size() if train else 0)
    if train:
        total += 4
    bspecs = batch_specs(inputs, sizes) if sizes else {}
    cspecs = cache_specs(inputs["cache"], sizes) \
        if sizes and "cache" in inputs else {}
    for k, v in inputs.items():
        if k == "cache":
            total += sum(block(t, cspecs.get(n, ())) for n, t in v.items())
        else:
            total += block(v, bspecs.get(k, ()))
    return float(total)


def count_train_step(cfg, *, global_batch: int = 0, seq_len: int = 0,
                     inputs=None, accum_steps: int = 1,
                     mesh=None) -> StepCount:
    """One ``make_train_step`` step of ``cfg`` at full size, as the
    ``Trainer`` runs it (AdamW at ``OptimizerConfig()``'s settings, remat),
    on fake CPU tensors: f32 masters (``abstract_params(param_dtype)``),
    AdamW state, ``accum_steps`` micro-batches of the batch ``inputs``
    (a model's ``input_specs`` of a train shape: tokens, targets and a
    VLM's patch rows), by default ``global_batch`` rows of ``seq_len``
    tokens and targets (what ``DataPipeline`` gives).  With ``mesh`` (a
    ``MeshSpec`` or an axis name -> extent mapping) it counts one rank's
    step of the sharded step on that mesh under :func:`fake_world` (or on
    a ``DeviceMesh`` of a fake world the caller holds open): the rank's
    blocks of the state by ``param_specs``, its rows of the batch, its
    collectives' bytes."""
    from ..models import build_model
    from ..train import OptimizerConfig, make_train_step
    from ..train.optimizer import init_opt_state
    from ..train.step import TrainState
    with contextlib.ExitStack() as stack:
        model = build_model(cfg, device="cpu")
        if inputs is None:
            tokens = torch.empty((global_batch, seq_len), dtype=torch.int32,
                                 device="meta")
            inputs = {"tokens": tokens, "targets": tokens}
        dmesh = None if mesh is None else stack.enter_context(_world(mesh))
        # the plan reads the mesh's tensors, which must stay real
        step = make_train_step(model, OptimizerConfig(),
                               accum_steps=accum_steps, remat=True,
                               mesh=dmesh)
        sizes = None
        if dmesh is not None:
            from ..parallel.sharding import (mesh_axes, mesh_coords,
                                             param_specs, shard_state)
            sizes = mesh_axes(dmesh)
            cut = (param_specs(model, dmesh), mesh_coords(dmesh))
        stack.enter_context(FakeTensorMode())
        params = fake_like(model.abstract_params(model.param_dtype))
        if dmesh is not None:
            params = shard_state(params, sizes, cut[0], coords=cut[1])
        state = TrainState(params=params, opt=init_opt_state(params),
                           rng=None)
        count = count_step(step, state, fake_like(inputs))
        count.state_bytes = _state_bytes(state)
        count.resident_bytes = resident_bytes(model, inputs, sizes,
                                              train=True)
        return count


def _count_serve(cfg, inputs, mesh, decode: bool) -> StepCount:
    from ..models import build_model
    from ..parallel.serve_step import ShardedServe
    from ..parallel.sharding import (mesh_axes, mesh_coords, param_specs,
                                     shard_state)
    with contextlib.ExitStack() as stack:
        model = build_model(cfg, device="cpu")
        dmesh = stack.enter_context(_world(mesh))
        B = inputs["tokens"].shape[0]
        if decode:
            max_seq = model.cache_max_seq(inputs["cache"])
        else:
            patch = inputs.get("patch_embeds")
            max_seq = inputs["tokens"].shape[1] + (
                0 if patch is None else patch.shape[1])
        serve = ShardedServe(model, dmesh, B, max_seq)
        sizes = mesh_axes(dmesh)
        cut = (param_specs(model, dmesh), mesh_coords(dmesh))
        stack.enter_context(FakeTensorMode())
        params = shard_state(
            fake_like(model.abstract_params(model.param_dtype)), sizes,
            cut[0], coords=cut[1])
        local = {k: serve.local_cache(fake_like(v)) if k == "cache"
                 else serve.local_rows(fake_like(v))
                 for k, v in inputs.items()}
        if decode:
            count = count_step(serve.decode_step, params, local["cache"],
                               local["tokens"], local["pos"])
        else:
            extra = [local[k] for k in getattr(model, "prefill_extras", ())
                     if k in local]
            count = count_step(serve.prefill, params, local["tokens"],
                               *extra)
        count.resident_bytes = resident_bytes(model, inputs, sizes)
        return count


def count_prefill(cfg, inputs, mesh) -> StepCount:
    """One rank's sharded prefill (``ShardedServe.prefill``) of ``cfg`` on
    ``mesh`` (a ``MeshSpec`` or an axis name -> extent mapping) under
    :func:`fake_world`, on fake CPU tensors: the parameters in
    ``param_dtype`` (the reference's dry run lowers its prefill on
    ``abstract_params()``), the rank's rows of ``inputs`` (a model's
    ``input_specs`` of a prefill shape: the tokens and a VLM's patch rows
    or an encoder-decoder's frames), a cache of the prompt's length."""
    return _count_serve(cfg, inputs, mesh, decode=False)


def count_decode(cfg, inputs, mesh) -> StepCount:
    """One rank's sharded decode step (``ShardedServe.decode_step``) of
    ``cfg`` on ``mesh`` under :func:`fake_world`, on fake CPU tensors:
    the parameters in ``param_dtype``, the rank's rows of the tokens and
    positions and its blocks of the cache of ``inputs`` (a model's
    ``input_specs`` of a decode shape), by ``cache_specs``."""
    return _count_serve(cfg, inputs, mesh, decode=True)


__all__ = ["StepCount", "count_step", "count_train_step", "count_prefill",
           "count_decode", "resident_bytes", "fake_like", "fake_world",
           "grouped_mm_flop", "FLOP_FORMULAS"]
