"""repro_torch.fleet — energy-aware multi-replica serving.

The tier above :mod:`repro_torch.serve` and :mod:`repro_torch.dvfs`: replay an
open-loop request trace (:mod:`~repro_torch.fleet.traces`) across N
:class:`Replica` instances — each wrapping the serving scheduler, its
own chip model, and a :class:`~repro_torch.dvfs.DvfsSession`-planned DVFS
plan — behind a pluggable :func:`router`, with optional cluster-wide
power capping by the :class:`FleetGovernor` (one shared Lagrangian
budget across replicas, pushed through each replica's online re-plan
path) and fleet metering (joules/token, p50/p99 TTFT/TPOT).

The port's copy of the JAX package's ``fleet/`` (numpy, in modeled time
on chip models: it touches no device), its imports pointed at the port,
its arithmetic unchanged, so the same seeds, specs and traces give the
reference's reports.  The device path of disaggregated serving is
:mod:`repro_torch.serve.kv_pages`' ``PageBlockTransfer``.
"""
from .traces import (ARRIVALS, SLO_TTFT_S, Trace, TraceRequest,
                     generate_tenant_trace, generate_trace,
                     register_arrivals)
from .faults import (FAULTS, FaultEvent, FaultInjector, FaultSchedule,
                     apply_thermal_cap, clamp_table, generate_faults,
                     lift_thermal_cap, register_faults)
from .replica import (ACTIVE, DEAD, DECODE, DRAINING, PARKED, PREFILL,
                      UNIFIED, Replica, RequestState)
from .router import (ROUTERS, BaseRouter, CacheAffinityRouter,
                     EnergySloRouter, LeastQueueRouter, RoundRobinRouter,
                     register_router, router)
from .governor import TAU_SWEEP, FleetGovernor, FrontierPoint
from .metering import (TransferCostModel, fleet_report, kv_bytes_per_token,
                       latency_stats, migration_stats, power_stats)
from .cluster import (Fleet, ReplicaSpec, build_fleet, build_replica,
                      decode_tables, default_serve_shapes,
                      parse_replica_specs)

__all__ = [
    "ARRIVALS", "SLO_TTFT_S", "Trace", "TraceRequest",
    "generate_tenant_trace", "generate_trace",
    "register_arrivals", "FAULTS", "FaultEvent", "FaultInjector",
    "FaultSchedule", "apply_thermal_cap", "clamp_table",
    "generate_faults", "lift_thermal_cap", "register_faults",
    "ACTIVE", "DEAD", "DRAINING", "PARKED", "PREFILL",
    "DECODE", "UNIFIED", "Replica", "RequestState", "ROUTERS",
    "BaseRouter", "RoundRobinRouter", "LeastQueueRouter",
    "EnergySloRouter", "CacheAffinityRouter", "register_router",
    "router", "TAU_SWEEP",
    "FleetGovernor", "FrontierPoint", "TransferCostModel", "fleet_report",
    "kv_bytes_per_token", "latency_stats", "migration_stats",
    "power_stats", "Fleet", "ReplicaSpec", "build_fleet", "build_replica",
    "decode_tables", "default_serve_shapes", "parse_replica_specs",
]
