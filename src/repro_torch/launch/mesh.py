"""Meshes of the port: the abstract descriptor plan transfer keys on, the
``torch.distributed`` device meshes, and a launcher for a world of ranks.

The port's copy of the JAX package's ``launch/mesh.py``.  Meshes are made
by functions (never module-level constants), so importing this module
touches no process group.  Single pod: 16x16 = 256 ranks (data, model);
multi-pod: 2x16x16 = 512 ranks with a leading ``pod`` axis that joins the
FSDP/data sharding.  A mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` over the current world, in the reference's axis order (the
first axis major, as ``jax.make_mesh`` lays devices out).

:class:`MeshSpec` is the device-free description of a mesh (DP x TP x pod
extents).  DVFS plan transfer (:mod:`repro_torch.parallel.plan_transfer`)
and the sharding rules (:mod:`repro_torch.parallel.sharding`) only need the
extents, so planning for a 256-chip pod never has to start 256 ranks.

:func:`spawn_ranks` starts a world on one host: one spawned process a rank,
joined through a ``FileStore`` in a temporary directory (no TCP port), each
calling the same function.  Several ranks may share one GPU under
``gloo``; ``nccl`` takes one rank a device.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch


@dataclass(frozen=True)
class MeshSpec:
    """Abstract (device-free) mesh extents: data / model / pod axes."""

    dp: int = 1       # data-parallel extent (the "data" axis)
    tp: int = 1       # tensor/model-parallel extent (the "model" axis)
    pod: int = 1      # pod (DCN) extent; joins the data sharding

    def __post_init__(self):
        if min(self.dp, self.tp, self.pod) < 1:
            raise ValueError(f"mesh extents must be >= 1, got {self}")

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp * self.pod

    @property
    def data_extent(self) -> int:
        """Total data-sharding ways (pod axis joins the data axis)."""
        return self.dp * self.pod

    def axes(self) -> Dict[str, int]:
        """Axis name -> extent in mesh order: ``pod`` (when above 1),
        ``data``, ``model`` -- the axes of the mesh
        :func:`make_production_mesh` or :func:`make_host_mesh` would make."""
        out = {"pod": self.pod} if self.pod > 1 else {}
        out.update(data=self.dp, model=self.tp)
        return out

    @classmethod
    def from_mesh(cls, mesh) -> "MeshSpec":
        """The extents of a ``DeviceMesh`` (absent axes count 1)."""
        shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        return cls(dp=int(shape.get("data", 1)),
                   tp=int(shape.get("model", 1)),
                   pod=int(shape.get("pod", 1)))

    def describe(self) -> str:
        tag = f"dp{self.data_extent}_tp{self.tp}"
        return tag if self.pod == 1 else f"{tag}_pod{self.pod}"


def _device_mesh(device_type: str, shape, names):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks; none is initialized")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh ({names}) needs {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16x16 (data, model) mesh, or 2x16x16 (pod, data, model) with
    ``multi_pod``, over a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device_type, shape, axes)


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   device_type: str = "cuda"):
    """A small (data, model) mesh over the current world of
    ``n_data * n_model`` ranks, for tests and single-host runs."""
    return _device_mesh(device_type, (n_data, n_model), ("data", "model"))


def _rank_main(fn, rank: int, world: int, backend: str, store_path: str,
               timeout_s: float, out, args) -> None:
    import torch.distributed as dist
    # one intra-op thread: ranks share the host's cores
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo",
                timeout_s: float = 600.0) -> List:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined into one ``backend`` process group through a
    ``FileStore`` in a fresh temporary directory, each process capped at
    one intra-op thread; return the results by rank.  ``fn`` and
    ``args`` are pickled (``fn`` by its import path), and so is each
    result.  A rank that raises or dies fails the call with its traceback,
    and the other ranks are stopped; so is a world that has not finished
    within ``timeout_s``, the process group's own timeout too."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results: Dict[int, object] = {}
    errors: Dict[int, str] = {}
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, world_size, backend, os.path.join(tmp, "store"),
            timeout_s, out, args)) for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) + len(errors) < world_size and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world_size)) - set(results))
                    raise TimeoutError(f"ranks {missing} did not finish in "
                                       f"{timeout_s:.0f} s")
                try:
                    rank, ok, payload = out.get(timeout=min(left, 2.0))
                except queue.Empty:
                    for rank, p in enumerate(procs):
                        if rank not in results and p.exitcode not in (None,
                                                                      0):
                            errors[rank] = f"exited with code {p.exitcode}"
                    continue
                (results if ok else errors)[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
            out.close()
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                           f"{errors[rank]}")
    return [results[r] for r in range(world_size)]


__all__ = ["MeshSpec", "make_production_mesh", "make_host_mesh",
           "spawn_ranks"]
