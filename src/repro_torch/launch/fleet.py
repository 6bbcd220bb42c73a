"""Fleet launcher of the port: ``python -m repro_torch.launch.fleet
--replicas ...``

The counterpart of the JAX package's ``launch/fleet.py``, with its flags:
builds an energy-aware serving fleet (one DVFS-planned replica per spec,
on ``h100`` chip models unless ``--replicas`` names others), replays a
seeded open-loop trace through the chosen router (and optional cluster
power cap), and prints the fleet report: joules per token, TTFT/TPOT
tails, per-replica books, and the governor's cap events.

The fleet runs in modeled time on the replicas' chip models and touches
no device, so the launcher takes no ``--device`` and runs on any host;
every second and joule it prints is modeled, none is a reading of a
card.  :func:`main` returns the report, the fleet and the trace.

Examples::

    python -m repro_torch.launch.fleet --replicas 3xh100:4 \
        --router energy-slo --process poisson --rate 80 --requests 200
    python -m repro_torch.launch.fleet --replicas 2xrtx3080ti:4,a4000:4 \
        --transfer-from rtx3080ti --process diurnal --rate 25
    python -m repro_torch.launch.fleet --replicas 3xh100:4 \
        --power-cap 1500 --rate 120
    python -m repro_torch.launch.fleet --replicas 3xh100:4 \
        --faults storm --controller rate-limited --rate 120
    python -m repro_torch.launch.fleet --replicas 3xh100:4 \
        --prefix-cache --tenants 4 --router cache-affinity --rate 150
    python -m repro_torch.launch.fleet \
        --replicas 2xh100@prefill,2xh100@decode --faults storm
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from ..configs import get_config
from ..fleet import (FaultInjector, FaultSchedule, FleetGovernor,
                     build_fleet, generate_faults, generate_tenant_trace,
                     generate_trace, parse_replica_specs, router)
from ..obs import Tracer


def main(argv: Optional[List[str]] = None) -> Dict:
    """Build, serve and report; returns the fleet report (``report``), the
    :class:`~repro_torch.fleet.Fleet` (``fleet``) and the trace
    (``trace``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--replicas", default="3xh100:4",
                    help="chip[:slots[:tau]][@role] list, Nx prefix "
                         "repeats (e.g. 2xh100:4,a4000:4; role "
                         "prefill/decode builds a disaggregated fleet: "
                         "2xh100@prefill,2xh100@decode)")
    ap.add_argument("--router", default="energy-slo",
                    help="repro_torch.fleet router registry name")
    ap.add_argument("--slo-ttft", type=float, default=0.1,
                    help="energy-slo router TTFT target (s)")
    ap.add_argument("--process", default="poisson",
                    choices=["poisson", "diurnal", "bursty"])
    ap.add_argument("--rate", type=float, default=60.0,
                    help="mean arrival rate (req/s)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--power-cap", type=float, default=None,
                    help="cluster power cap (W); enables FleetGovernor")
    ap.add_argument("--autopark", type=float, default=None,
                    help="park replicas idle longer than this (s)")
    ap.add_argument("--transfer-from", default=None,
                    help="chip whose plan seeds the other chips' plans "
                         "via cross-chip transfer")
    ap.add_argument("--faults", default=None,
                    help="fault schedule: a registered generator name "
                         "(e.g. storm, random) or a path to a saved "
                         "FaultSchedule JSON")
    ap.add_argument("--no-recover", action="store_true",
                    help="inject faults but strand orphans instead of "
                         "re-dispatching them (chaos baseline)")
    ap.add_argument("--controller", default=None,
                    help="frequency-controller backend per replica "
                         "(e.g. rate-limited; needed for driver-fail "
                         "fault events to bite)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the per-replica radix prefix cache "
                         "(CoW-shared KV pages across requests)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="override each replica's KV page-pool size "
                         "(default: sized for the slot count)")
    ap.add_argument("--tenants", type=int, default=None,
                    help="replay a multi-tenant trace with this many "
                         "tenants (Zipf-shared prefix templates + "
                         "per-tenant SLO classes) instead of the plain "
                         "open-loop trace")
    ap.add_argument("--save-trace", default=None,
                    help="write the generated trace JSON here")
    ap.add_argument("--trace-out", default=None,
                    help="record a Chrome/Perfetto-loadable telemetry "
                         "trace (repro_torch.obs schema) of the run here")
    ap.add_argument("--json", action="store_true",
                    help="dump the full report as JSON")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    specs = parse_replica_specs(args.replicas)
    if args.tenants:
        trace = generate_tenant_trace(
            args.process, n_requests=args.requests, rate_rps=args.rate,
            seed=args.seed, n_tenants=args.tenants)
    else:
        trace = generate_trace(args.process, n_requests=args.requests,
                               rate_rps=args.rate, seed=args.seed,
                               straggler_tokens=64, straggler_every=3)
    if args.save_trace:
        trace.save(args.save_trace)
    rt = router(args.router, slo_ttft_s=args.slo_ttft) \
        if args.router in ("energy-slo", "cache-affinity") else args.router
    gov = FleetGovernor(args.power_cap) if args.power_cap else None
    tracer = None
    if args.trace_out:
        tracer = Tracer(meta={"launcher": "fleet", "arch": args.arch,
                              "replicas": args.replicas,
                              "router": args.router, "seed": args.seed})
    fleet = build_fleet(specs, cfg, router=rt, fleet_governor=gov,
                        autopark_idle_s=args.autopark,
                        transfer_from=args.transfer_from,
                        seed=args.seed, controller=args.controller,
                        recover=not args.no_recover,
                        prefix_cache=args.prefix_cache,
                        pool_pages=args.pool_pages, tracer=tracer)
    if args.faults:
        # schedules are built against the fleet's replica names, so the
        # injector is attached after the replicas exist
        if os.path.exists(args.faults):
            sched = FaultSchedule.load(args.faults)
        else:
            sched = generate_faults(
                args.faults, seed=args.seed,
                replicas=[r.name for r in fleet.replicas],
                duration_s=trace.duration_s)
        fleet.injector = FaultInjector(sched)
    rep = fleet.serve(trace)
    if tracer is not None:
        print(f"[fleet] telemetry trace ({len(tracer.events)} events) "
              f"-> {tracer.save(args.trace_out)}")

    out = {"report": rep, "fleet": fleet, "trace": trace}
    if args.json:
        print(json.dumps(rep, indent=1, default=float))
        return out
    chips = sorted({b["chip"] for b in rep["replicas"]})
    print(f"[fleet] {len(specs)} replicas, router={args.router}, "
          f"{args.process}@{args.rate:g} rps, {args.requests} requests")
    print(f"[fleet] modeled time and energy ({', '.join(chips)} chip "
          f"models): no device is read")
    print(f"[fleet] {rep['tokens']} tokens in {rep['makespan_s']:.2f}s "
          f"makespan: {rep['joules_per_token']:.4f} J/tok "
          f"({rep['energy_j']:.0f} J total, "
          f"{rep['idle_energy_j']:.0f} J idle, "
          f"{rep['parked_energy_j']:.0f} J parked)")
    print(f"[fleet] TTFT p50/p99 {rep['ttft_p50_s']*1e3:.0f}/"
          f"{rep['ttft_p99_s']*1e3:.0f} ms, TPOT p99 "
          f"{rep['tpot_p99_s']*1e3:.1f} ms, "
          f"{rep['n_completed']}/{args.requests} completed")
    if args.prefix_cache:
        cs = [b["prefix_cache"] for b in rep["replicas"]
              if "prefix_cache" in b]
        hits = sum(c["hits"] for c in cs)
        look = hits + sum(c["misses"] for c in cs)
        cached = sum(b.get("cached_prompt_tokens", 0)
                     for b in rep["replicas"])
        prompt = sum(r.prompt_len for r in trace.requests) or 1
        pools = [b["pool"] for b in rep["replicas"]]
        print(f"[fleet] prefix cache: {hits}/{look} hits "
              f"({hits / max(look, 1) * 100:.0f}%), "
              f"{cached} prompt tokens served from cache "
              f"({cached / prompt * 100:.0f}%), "
              f"{sum(p['cow_copies'] for p in pools)} CoW copies, "
              f"{sum(p['evictions'] for p in pools)} evictions")
    if rep.get("n_migrations"):
        print(f"[fleet] disaggregated: {rep['n_migrations']} KV "
              f"migrations, {rep['migration_bytes']/1e6:.1f} MB moved, "
              f"{rep['migration_energy_j']:.2f} J / "
              f"{rep['migration_s']*1e3:.1f} ms charged")
    rec = rep.get("recovery")
    if rec is not None:
        print(f"[fleet] faults: {rec['n_crashes']} crashes "
              f"({rec['n_evicted']} evicted), "
              f"{rec['n_thermal_caps']} thermal caps, "
              f"{rec['n_driver_faults']} driver faults")
        print(f"[fleet] recovery: {rec['n_redispatched']} re-dispatched "
              f"({rec['n_reprefills']} prefills re-run, "
              f"{rec['reprefill_energy_j']:.2f} J), "
              f"{rec['n_redelivered']} re-delivered, link "
              f"{rec['n_link_retries']} retries / "
              f"{rec['n_link_fallbacks']} fallbacks / "
              f"{rec['n_link_degraded']} degraded "
              f"({rec['link_retry_energy_j']:.2f} J), "
              f"{rep['n_stranded']} stranded")
    for b in rep["replicas"]:
        print(f"[fleet]   {b['name']:16s} {b['chip']:15s} "
              f"{b['tokens']:5d} tok  busy {b['busy_s']:.2f}s "
              f"idle {b['idle_s']:.2f}s parked {b['parked_s']:.2f}s "
              f"rev={b['governor_revision']} ({b['state']})")
    if args.power_cap:
        # power_stats sets the tracking error only when some window ran
        # loaded; the reference's launcher reads it unconditionally
        p = rep["power"]
        err = p.get("loaded_tracking_err_frac")
        track = (f"{p['mean_loaded_w']:.1f} W (err {err * 100:.2f}%)"
                 if err is not None else
                 f"n/a (no loaded window; mean window "
                 f"{p['mean_window_w']:.1f} W)")
        print(f"[fleet] cap {args.power_cap:.0f} W (modeled): mean loaded "
              f"{track}, {rep['fleet_governor']['n_replans']} re-plans")
    return out


if __name__ == "__main__":
    main()
