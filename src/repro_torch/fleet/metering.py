"""Fleet-level energy/latency accounting.

Aggregates per-replica books — each replica's
:class:`~repro_torch.dvfs.GovernorExecutor` energy meters (busy) plus its
integrated idle/parked dwell — into the quantities cluster papers argue
about: **joules per generated token** (the energy headline; includes
idle burn, so packing policies get credit for letting replicas idle or
park) and the **TTFT/TPOT tail** (p50/p99 over completed requests —
the SLO side of every energy claim).  A per-window cluster power series
(recorded by the fleet loop at governor-tick cadence) feeds the
power-cap verification: ``max_window_w`` against the cap, mean over
loaded windows for tracking tightness.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs import MetricsRegistry
from .replica import Replica, RequestState

#: a window is "loaded" when every replica spent at least this fraction
#: of it serving.  Deliberately not ~1.0: admission stalls dent util on
#: windows that are still loaded operation, and excluding them would
#: cherry-pick the prefill-hot windows into the loaded-power statistic.
#: Shared by Fleet._window (labeling) and FleetGovernor.control (bias
#: feedback) so the two layers can never disagree on what "loaded" is.
LOADED_UTIL_MIN = 0.8


def kv_bytes_per_token(cfg, kv_dtype: str = "none",
                       dtype_bytes: int = 2) -> int:
    """Analytic bytes of cached KV state one token position adds — the
    per-token payload a :class:`PageBlockTransfer` moves.  Attention
    layers contribute ``2 * n_kv_heads * head_dim`` elements each at the
    pool's storage width (quantized pools also ship their per-(page,
    KV-head) float32 scales, amortized per token); attention-free configs
    (pure SSM) still ship their constant-size recurrent state, modeled
    here as one d_model vector per layer per request amortized over a
    nominal prompt."""
    from ..serve.kv_pages import kv_dtype_bytes
    width = kv_dtype_bytes(kv_dtype, dtype_bytes)
    if cfg.n_kv_heads:
        per = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim
        nbytes = per * width
        if width != dtype_bytes:                    # quantized: + scales
            # 4B per (page, KV-head) scale over a 16-token page
            nbytes += cfg.n_layers * 2 * cfg.n_kv_heads * 4 // 16
        return int(nbytes)
    return int(cfg.n_layers * cfg.d_model * dtype_bytes)


@dataclass(frozen=True)
class TransferCostModel:
    """Modeled cost of migrating a KV page block between replicas.

    ``time = latency_s + bytes / bandwidth``, ``energy = link_w * time``
    — a flat-latency + line-rate interconnect model (NVLink/ICI-class
    defaults).  The fleet loop charges both to the migration books, so
    the disaggregation benchmark's J/token includes what migration
    costs, not just what phase-specialized plans save.
    """

    bandwidth_gbs: float = 50.0     # effective inter-replica GB/s
    latency_s: float = 20e-6        # per-transfer setup latency
    link_w: float = 15.0            # link + controller power while moving

    def cost(self, nbytes: int) -> Dict[str, float]:
        t = self.latency_s + nbytes / (self.bandwidth_gbs * 1e9)
        return {"bytes": int(nbytes), "time_s": t,
                "energy_j": self.link_w * t}


def _pcts(vals: Sequence[float], ps=(50, 99)) -> Dict[str, float]:
    if not vals:
        return {f"p{p}": float("nan") for p in ps}
    arr = np.asarray(vals, dtype=float)
    return {f"p{p}": float(np.percentile(arr, p)) for p in ps}


def latency_stats(requests: Sequence[RequestState],
                  registry: Optional[MetricsRegistry] = None) -> Dict:
    """p50/p99 TTFT and TPOT over the completed request set.

    Routed through :class:`~repro_torch.obs.MetricsRegistry` histograms (whose
    percentile computation is the exact ``_pcts`` arithmetic), so the
    output dict is byte-identical to the legacy builder while the
    samples become inspectable instruments.  Pass ``registry`` to
    accumulate into a caller-owned registry.
    """
    reg = registry if registry is not None else MetricsRegistry()
    h_ttft = reg.histogram("ttft_s")
    h_tpot = reg.histogram("tpot_s")
    done = [rs for rs in requests if rs.done]
    for rs in done:
        if rs.ttft_s is not None:
            h_ttft.observe(rs.ttft_s)
        if rs.tpot_s is not None:
            h_tpot.observe(rs.tpot_s)
    out = {"n_completed": len(done)}
    out.update({f"ttft_{k}_s": v for k, v in
                h_ttft.percentiles().items()})
    out.update({f"tpot_{k}_s": v for k, v in
                h_tpot.percentiles().items()})
    return out


def power_stats(series: Sequence[Dict],
                cap_w: Optional[float] = None) -> Dict:
    """Window power series -> tracking stats (vs the cap when given).

    ``loaded`` windows (any replica busy the whole window) are the ones
    a cap must hold on; ramp-in/drain windows dilute the mean."""
    if not series:
        return {"n_windows": 0}
    watts = np.asarray([w["power_w"] for w in series], dtype=float)
    loaded = np.asarray([w["power_w"] for w in series
                         if w.get("loaded", True)], dtype=float)
    out = {"n_windows": len(series),
           "max_window_w": float(watts.max()),
           "mean_window_w": float(watts.mean()),
           "mean_loaded_w": float(loaded.mean()) if loaded.size
           else float(watts.mean())}
    if cap_w:
        out["cap_w"] = float(cap_w)
        out["max_over_cap_frac"] = float(watts.max() / cap_w - 1.0)
        if loaded.size:
            out["loaded_tracking_err_frac"] = \
                float(abs(loaded.mean() / cap_w - 1.0))
    return out


def migration_stats(migrations: Sequence[Dict],
                    registry: Optional[MetricsRegistry] = None) -> Dict:
    """Aggregate the per-transfer cost records the fleet loop charged.

    Counter-backed (same registry-adapter pattern as
    :func:`latency_stats`); output keys and value types are unchanged.
    """
    reg = registry if registry is not None else MetricsRegistry()
    c_n = reg.counter("migrations")
    c_bytes = reg.counter("migration_bytes")
    c_s = reg.counter("migration_s")
    c_j = reg.counter("migration_energy_j")
    for m in migrations:
        c_n.inc(1)
        c_bytes.inc(m["bytes"])
        c_s.inc(m["time_s"])
        c_j.inc(m["energy_j"])
    return {"n_migrations": int(c_n.value),
            "migration_bytes": int(c_bytes.value),
            "migration_s": float(c_s.value),
            "migration_energy_j": float(c_j.value)}


def fleet_report(replicas: Sequence[Replica],
                 requests: Sequence[RequestState],
                 horizon_s: float,
                 power_series: Optional[List[Dict]] = None,
                 cap_w: Optional[float] = None,
                 migrations: Optional[Sequence[Dict]] = None,
                 n_stranded: int = 0,
                 recovery: Optional[Dict] = None) -> Dict:
    """The fleet run's single accounting artifact.  ``migrations`` (the
    disaggregated fleet's per-transfer cost records) are charged into the
    cluster energy total — and therefore joules/token — so the
    disaggregation claim pays for what it moves.  ``recovery`` (the
    fault books from :class:`~repro_torch.fleet.cluster.Fleet`) likewise
    charges dropped-link retry energy into the total: fault tolerance
    pays for its failed attempts too."""
    books = [r.energy_book() for r in replicas]
    energy = sum(b["energy_j"] for b in books)
    mig = migration_stats(migrations or [])
    energy += mig["migration_energy_j"]
    if recovery is not None:
        energy += recovery.get("link_retry_energy_j", 0.0)
    busy_energy = sum(b["busy_energy_j"] for b in books)
    base_busy = sum(b["base_busy_energy_j"] for b in books)
    tokens = sum(b["tokens"] for b in books)
    finishes = [rs.finish_s for rs in requests if rs.finish_s is not None]
    out = {
        "n_replicas": len(replicas),
        "horizon_s": horizon_s,
        "makespan_s": max(finishes) if finishes else horizon_s,
        "energy_j": energy,
        **mig,
        "busy_energy_j": busy_energy,
        "idle_energy_j": sum(b["idle_energy_j"] for b in books),
        "parked_energy_j": sum(b["parked_energy_j"] for b in books),
        "base_busy_energy_j": base_busy,
        "tokens": tokens,
        "joules_per_token": energy / tokens if tokens else float("nan"),
        "avg_power_w": energy / horizon_s if horizon_s > 0
        else float("nan"),
        "dvfs_busy_energy_pct": (100.0 * (busy_energy / base_busy - 1.0)
                                 if base_busy > 0 else 0.0),
        "replicas": books,
    }
    out["n_stranded"] = int(n_stranded)
    if recovery is not None:
        out["recovery"] = dict(recovery)
    out.update(latency_stats(requests))
    if power_series is not None:
        out["power"] = power_stats(power_series, cap_w)
    return out
