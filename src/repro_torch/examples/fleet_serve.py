"""Fleet example: route one trace three ways, then cap the cluster.

The fleet tier composes everything below it: each replica runs its own
kernel-level DVFS plan, the router reads those plans to predict marginal
energy, and the :class:`~repro_torch.fleet.FleetGovernor` solves one
shared Lagrangian budget across replicas to hold a cluster power cap —
pushing revised plans through each replica's online re-plan path.

Three stages:

1. Generate a seeded peak-load trace (Poisson arrivals, heavy-tailed
   generation lengths) and replay it through round-robin, least-queue,
   and the energy/SLO-aware router: same requests, three energy/tail
   outcomes.
2. Re-serve under a cluster power cap 5% below the fleet's natural
   draw and watch the governor's control ticks track it.
3. Drain and park a replica mid-trace: autoscale-down as one more DVFS
   decision (the parked state is the chip's deepest frequency pair).

The fleet runs in modeled time on ``--chip``'s model (``h100`` by default;
the JAX package's example uses ``tpu-v5e``) and touches no device: every
second, joule and watt it prints is the model's, none a reading of a card
(a busy ``h100`` replica bills more than the card's 700 W limit).

Run:  python -m repro_torch.examples.fleet_serve [--chip h100]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from ..configs import REGISTRY
from ..fleet import (FleetGovernor, ReplicaSpec, build_fleet,
                     generate_trace, router)
from ._common import Printer, add_chip_flag

CFG = REGISTRY["llama3.2-1b"]
RKW = dict(slo_ttft_s=0.08, slo_weight=60.0, slack=0.3)


def serve(specs, router_obj, trace, governor=None, autopark=None):
    fleet = build_fleet(specs, CFG, router=router_obj, n_reps=3,
                        fleet_governor=governor,
                        autopark_idle_s=autopark)
    return fleet.serve(trace), fleet


def main(argv: Optional[List[str]] = None) -> Dict:
    """Route, cap, park; returns the printed ``lines`` and the reports of
    the three routers (``routers``), the uncapped and capped runs
    (``uncapped``, ``capped``) and the parked run (``parked``)."""
    ap = argparse.ArgumentParser()
    add_chip_flag(ap)
    args = ap.parse_args(argv)
    out = Printer()
    out.chip(args.chip)
    specs = [ReplicaSpec(chip=args.chip, n_slots=4, tau=0.005)] * 3

    trace = generate_trace("poisson", n_requests=200, rate_rps=80.0,
                           seed=0, straggler_tokens=64, straggler_every=3)
    out(f"trace: {len(trace)} requests over {trace.duration_s:.1f}s, "
        f"{trace.total_new_tokens} tokens to generate")

    # --- 1. one trace, three routers --------------------------------
    routers = {}
    for name in ("round-robin", "least-queue", "energy-slo"):
        rt = router(name, **RKW) if name == "energy-slo" else name
        rep, _ = serve(specs, rt, trace)
        routers[name] = rep
        out(f"  {name:12s}: {rep['joules_per_token']:.4f} J/tok, "
            f"TTFT p99 {rep['ttft_p99_s']*1e3:5.0f} ms, "
            f"idle {rep['idle_energy_j']:5.0f} J")

    # --- 2. cluster power cap ---------------------------------------
    rep, _ = serve(specs, router("energy-slo", **RKW), trace)
    cap = 0.95 * rep["power"]["mean_loaded_w"]
    capped, fleet = serve(specs, router("energy-slo", **RKW), trace,
                          governor=FleetGovernor(cap, interval_s=0.25))
    p = capped["power"]
    # power_stats sets the tracking error only when some window ran
    # loaded (a replica busy all of it); the reference reads it
    # unconditionally, and an h100 fleet drains this trace in windows
    # that none fills
    err = p.get("loaded_tracking_err_frac")
    track = (f"(tracking err {err*100:.2f}%)" if err is not None else
             f"(no loaded window: tracking err n/a, mean window "
             f"{p['mean_window_w']:.1f} W)")
    out(f"cap {cap:.0f} W: mean loaded {p['mean_loaded_w']:.1f} W "
        f"{track}, makespan {capped['makespan_s']:.2f}s vs "
        f"{rep['makespan_s']:.2f}s uncapped, "
        f"{capped['fleet_governor']['n_replans']} pushed re-plans")
    ticks = [e for e in fleet.governor.events if not e.get("hold")][:3]
    for e in ticks:
        out(f"   t={e['t']:.2f}s predicted {e['predicted_w']:.0f} W, "
            f"lambda={e['lambda']:.2e}, pushed "
            f"{[pp['replica'] for pp in e['pushed']]}")

    # --- 3. drain + park = autoscale-down ---------------------------
    parked, fleet = serve(specs, router("energy-slo", **RKW),
                          generate_trace("diurnal", n_requests=120,
                                         rate_rps=25.0, seed=0),
                          autopark=0.25)
    for b in parked["replicas"]:
        out(f"  {b['name']:12s}: busy {b['busy_s']:.2f}s idle "
            f"{b['idle_s']:.2f}s parked {b['parked_s']:.2f}s "
            f"({b['parked_energy_j']:.0f} J at "
            f"{fleet.replicas[0].parked_power_w:.0f} W deepest-state)"
            f" -> {b['state']}")
    return {"lines": out.lines, "routers": routers, "uncapped": rep,
            "capped": capped, "parked": parked}


if __name__ == "__main__":
    main()
