"""The abstract mesh descriptor plan transfer keys on.

The port's copy of the JAX package's ``launch/mesh.py:MeshSpec``.
:class:`MeshSpec` is the device-free description of a mesh (DP x TP x pod
extents).  DVFS plan transfer (:mod:`repro_torch.parallel.plan_transfer`)
only needs the extents — the per-device workload is ``global_batch / dp``
with kernels sharded ``tp`` ways — so planning for a 256-chip pod never
has to instantiate 256 devices.

The reference's ``MeshSpec.from_mesh`` (the extents of a concrete ``jax``
mesh), ``make_production_mesh`` and ``make_host_mesh`` are not here: they
come with the port's ``torch.distributed`` meshes (ROADMAP item 11).
"""
from __future__ import annotations

from dataclasses import dataclass


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

    def describe(self) -> str:
        tag = f"dp{self.data_extent}_tp{self.tp}"
        return tag if self.pod == 1 else f"{tag}_pod{self.pod}"
