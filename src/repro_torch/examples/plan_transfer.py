"""Plan transfer across parallelism (paper §7/§8 as a workflow).

Discover the strict-waste plan once (batch 40, TP=1), then apply it to
data-parallel (smaller per-chip batch) and tensor-parallel (sharded
kernels) variants — the deployment pattern for a 1000-node fleet: one
3-GPU-day campaign, one plan, every worker.

The modeled workflow on ``--chip``'s model (``h100`` by default; the JAX
package's example uses ``rtx3080ti``): host only, no device.  A
transferred plan measured on the card is ``parallel/plan_transfer.py``'s
and ``chip_smoke.py``'s ``transfer_gpt3`` phase.

Run:  python -m repro_torch.examples.plan_transfer [--chip h100]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from ..configs import get_config, get_shape
from ..core import Campaign, build_workload, get_chip
from ..dvfs import governor
from ._common import Printer, add_chip_flag

#: "within a few pp": each variant's energy within this many points of
#: the discovered plan's, and no variant slower than this many percent
FEW_PP = 3.0


def main(argv: Optional[List[str]] = None) -> Dict:
    """Plan once, transfer; returns the printed ``lines``, the discovered
    plan's energy and time percentages (``discovered``) and each
    variant's (``dp`` by per-chip batch, ``tp`` by degree)."""
    ap = argparse.ArgumentParser()
    add_chip_flag(ap)
    args = ap.parse_args(argv)
    out = Printer()
    out.chip(args.chip)

    cfg = get_config("gpt3-xl")
    shape = get_shape("paper_gpt3xl")
    chip = get_chip(args.chip)

    kernels = build_workload(cfg, shape)
    table = Campaign(chip, seed=0, n_reps=5).run(kernels)
    plan = governor("kernel-static").solve(table)
    out(f"discovered (batch 40, TP=1): {plan.energy_pct:+.2f}% energy, "
        f"{plan.time_pct:+.2f}% time")

    def applied(t2):
        t, e = t2.totals(plan.choice)
        tb, eb = t2.baseline_totals()
        return 100 * (e / eb - 1), 100 * (t / tb - 1)

    dp, tp = {}, {}
    out("\n-- data parallelism (per-chip batch) --")
    for b in (20, 8, 2, 1):
        dp[b] = applied(Campaign(chip, seed=50 + b, n_reps=5).run(
            build_workload(cfg, shape, batch_override=b)))
        out(f"  batch {b:3d}: {dp[b][0]:+7.2f}% energy, "
            f"{dp[b][1]:+6.2f}% time")

    out("\n-- tensor parallelism (+ sequence parallel) --")
    for d in (2, 4, 8, 16):
        tp[d] = applied(Campaign(chip, seed=80 + d, n_reps=5).run(
            build_workload(cfg, shape, tp=d, sp=True)))
        out(f"  tp {d:2d}: {tp[d][0]:+7.2f}% energy, {tp[d][1]:+6.2f}% time")
    energy = [e for e, _ in (*dp.values(), *tp.values())]
    slowest = max(t for _, t in (*dp.values(), *tp.values()))
    if max(abs(e - plan.energy_pct) for e in energy) <= FEW_PP and \
            slowest <= FEW_PP:
        out("\nsavings transfer within a few pp — one campaign serves the "
            "whole fleet (paper §7-8).")
    else:
        out(f"\nsavings do not transfer within {FEW_PP:.0f} pp on this "
            f"chip model: {min(energy):+.2f}% to {max(energy):+.2f}% "
            f"energy against {plan.energy_pct:+.2f}% discovered, time up to "
            f"{slowest:+.2f}% — re-plan each variant here.")
    return {"lines": out.lines,
            "discovered": (plan.energy_pct, plan.time_pct), "dp": dp,
            "tp": tp}


if __name__ == "__main__":
    main()
