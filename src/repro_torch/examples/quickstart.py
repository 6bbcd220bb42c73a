"""Quickstart: the whole pipeline in one page, via the ``repro_torch.dvfs``
facade.

1. Decompose a GPT-3-xl training iteration into kernels (paper Table 1).
2. Run the simulated DVFS measurement campaign (paper §4) on ``--chip``'s
   model (``h100`` by default; the JAX package's example uses
   ``rtx3080ti``).
3. Plan with three governors from the registry: strict-waste kernel-level
   global optimum vs pass-level vs EDP.
4. Compile the winning plan into the unified, versioned DvfsPlan IR and
   save it (the artifact a DvfsSession executor replays).

Host only: it touches no tensor and no device, and every time and energy
it prints is modeled on the chip model.

Run:  python -m repro_torch.examples.quickstart [--chip h100]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

from ..configs import get_config, get_shape
from ..core import Campaign, build_workload, get_chip
from ..dvfs import DvfsPlan, governor
from ._common import HOST_MARK, Printer, add_chip_flag


def main(argv: Optional[List[str]] = None) -> Dict:
    """Plan and save; returns the printed ``lines``, each governor's
    ``summary()`` by name (``plans``), the saved ``plan``, its ``path``,
    whether it round-trips (``round_trips``) and the campaign's host
    seconds (``campaign_s``)."""
    ap = argparse.ArgumentParser()
    add_chip_flag(ap)
    ap.add_argument("--plan-out",
                    default="artifacts/torch_quickstart_plan.json")
    args = ap.parse_args(argv)
    out = Printer()
    out.chip(args.chip)

    cfg = get_config("gpt3-xl")
    shape = get_shape("paper_gpt3xl")
    kernels = build_workload(cfg, shape)
    out(f"workload: {len(kernels)} kernels / iteration "
        f"({sum(k.invocations for k in kernels)} launches)")

    chip = get_chip(args.chip)
    t0 = time.perf_counter()
    camp = Campaign(chip, seed=0, n_reps=5)
    table = camp.run(kernels)
    campaign_s = time.perf_counter() - t0
    tb, eb = table.baseline_totals()
    out(f"auto baseline: {tb*1e3:.0f} ms/iter, {eb:.0f} J/iter")

    plans = {}
    for name, kw in (("pass-level", {}), ("kernel-static", {}),
                     ("edp", {"level": "global"})):
        s = governor(name, **kw).solve(table).summary()
        plans[name] = s
        out(f"  {s['plan']:14s} time {s['time_pct']:+7.2f}%  "
            f"energy {s['energy_pct']:+7.2f}%")

    gov = governor("kernel-static")
    plan = gov.plan_table(table, meta={"model": cfg.name,
                                       "shape": shape.name})
    seg = plan.segment("iteration")
    out(f"plan IR: schema v{plan.schema_version}, "
        f"{len(plan.segments)} segment(s), "
        f"{len(seg.schedule.entries)} coalesced entries, "
        f"{seg.schedule.n_switches} clock switches per iteration")
    plan.save(args.plan_out)
    same = DvfsPlan.load(args.plan_out).summary() == plan.summary()
    out(f"saved {args.plan_out} (round-trips: {same})")
    out(f"campaign: {len(kernels)} kernels x {chip.grid.size()} clock "
        f"pairs in {campaign_s:.2f} s {HOST_MARK}")
    return {"lines": out.lines, "plans": plans, "plan": plan,
            "path": args.plan_out, "round_trips": same,
            "campaign_s": campaign_s}


if __name__ == "__main__":
    main()
