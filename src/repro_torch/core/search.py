"""Measurement-efficient frequency search (beyond-paper).

The paper's exhaustive campaign costs ~3 GPU-days (§4) and it argues an
*efficient* search that still optimizes **globally** "will be more complex
and will require a larger search space" (§6).  This module provides one:

1. **Boundedness-guided pruning** — each kernel's arithmetic intensity
   (known statically from the workload model) predicts which clock domain
   has headroom; compute-bound kernels only sweep memory clocks near the
   roofline-feasible range and vice versa.
2. **Successive halving** over the surviving (kernel, pair) cells: all
   cells get one cheap (noisy) measurement; the best half per kernel is
   re-measured with doubled repetitions, etc.  Measurement *cost* is
   counted in repetition-units, the currency of the paper's 5-second
   windows.
3. The surviving grid feeds the ordinary global (Lagrangian) planner, so
   the search stays globally-aggregated — the property the paper says is
   hard to keep.

``search_plan`` returns (plan, cost_report); `benchmarks/search_cost.py`
compares it against the exhaustive campaign.

The port's copy of the JAX package's ``core/search.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .freq import AUTO, ClockPair
from .measure import Campaign, MeasurementTable, NoiseModel
from .objectives import WastePolicy
from .planner import Plan, global_plan
from .power_model import Chip, KernelSpec


@dataclass
class SearchReport:
    measurements: int            # repetition-units spent
    exhaustive_measurements: int
    cells_swept: int
    cells_total: int

    @property
    def cost_fraction(self) -> float:
        return self.measurements / max(self.exhaustive_measurements, 1)


def _candidate_mask(chip: Chip, kernels: Sequence[KernelSpec],
                    pairs: Sequence[ClockPair]) -> np.ndarray:
    """(n_kernels, n_pairs) bool: cells worth measuring.

    Static pruning from the roofline: for a kernel bound on domain D at
    full clocks, lowering D's clock below its utilization ratio is a
    guaranteed slowdown — prune those cells; the *other* domain sweeps
    freely.  The auto pair is always kept (it is the baseline).
    """
    n_k, n_p = len(kernels), len(pairs)
    mask = np.zeros((n_k, n_p), dtype=bool)
    fmax_c = chip.grid.core_clocks_mhz[-1]
    fmax_m = chip.grid.mem_clocks_mhz[-1]
    for i, k in enumerate(kernels):
        t_c = k.flops / chip.peak_flops
        t_m = k.hbm_bytes / chip.hbm_bw
        bound = max(t_c, t_m, 1e-30)
        # headroom ratios: how far each domain's clock can drop before it
        # becomes the bottleneck (plus one grid step of margin)
        r_core = t_c / bound
        r_mem = t_m / bound
        for j, p in enumerate(pairs):
            if p.is_auto:
                mask[i, j] = True
                continue
            fc = 1.0 if p.core == AUTO else p.core / fmax_c
            fm = 1.0 if p.mem == AUTO else p.mem / fmax_m
            # keep a cell if neither clock dips far below its domain's
            # feasibility ratio (x0.7 margin: the global planner may
            # still buy small slowdowns)
            if fc >= 0.7 * r_core and fm >= 0.7 * r_mem * 0.5:
                # (mem has the bw-efficiency knee at 0.5: anything below
                # half clock is never useful — §5's 405/810 finding)
                if p.mem == AUTO or fm >= 0.45:
                    mask[i, j] = True
    return mask


def search_plan(chip: Chip, kernels: Sequence[KernelSpec],
                policy: Optional[WastePolicy] = None,
                rounds: int = 3, base_reps: int = 1, keep_frac: float = 0.5,
                seed: int = 0,
                noise: Optional[NoiseModel] = None
                ) -> Tuple[Plan, SearchReport]:
    """Boundedness-pruned successive-halving search + global planning."""
    policy = policy if policy is not None else WastePolicy()
    pairs = chip.grid.pairs()
    n_k, n_p = len(kernels), len(pairs)
    camp = Campaign(chip, seed=seed, n_reps=1, noise=noise)
    truth_t, truth_e = chip.evaluate_grid(kernels, pairs)

    mask = _candidate_mask(chip, kernels, pairs)
    auto_idx = pairs.index(ClockPair(AUTO, AUTO))

    rng = np.random.default_rng(seed)
    nm = noise or NoiseModel()
    est_t = np.full((n_k, n_p), np.inf)
    est_e = np.full((n_k, n_p), np.inf)
    reps_done = np.zeros((n_k, n_p), dtype=int)
    alive = mask.copy()
    measurements = 0
    reps = base_reps
    for rnd in range(rounds):
        # measure every live cell `reps` more times (averaging down noise)
        idx = np.where(alive)
        n_cells = len(idx[0])
        for _ in range(reps):
            tn, en = nm.sample(rng, truth_t, truth_e)
            for i, j in zip(*idx):
                prev = reps_done[i, j]
                if prev == 0:
                    est_t[i, j], est_e[i, j] = tn[i, j], en[i, j]
                else:
                    est_t[i, j] = (est_t[i, j] * prev + tn[i, j]) / (prev + 1)
                    est_e[i, j] = (est_e[i, j] * prev + en[i, j]) / (prev + 1)
                reps_done[i, j] = prev + 1
        measurements += n_cells * reps
        if rnd == rounds - 1:
            break
        # keep the most promising half per kernel: rank by energy among
        # cells that are not grossly slower than auto
        for i in range(n_k):
            live_j = np.where(alive[i])[0]
            if len(live_j) <= 2:
                continue
            t_auto = est_t[i, auto_idx]
            score = np.where(est_t[i, live_j] <= 1.3 * t_auto,
                             est_e[i, live_j], np.inf)
            order = live_j[np.argsort(score)]
            n_keep = max(int(np.ceil(len(live_j) * keep_frac)), 2)
            drop = order[n_keep:]
            alive[i, drop] = False
            alive[i, auto_idx] = True
        reps *= 2

    # unswept cells: fill with pessimistic values so the planner never
    # picks them
    t_fill = np.where(reps_done > 0, est_t, 1e12)
    e_fill = np.where(reps_done > 0, est_e, 1e12)
    t_fill[:, auto_idx] = est_t[:, auto_idx]
    e_fill[:, auto_idx] = est_e[:, auto_idx]
    table = MeasurementTable(chip_name=chip.name, kernels=list(kernels),
                             pairs=pairs, time=t_fill, energy=e_fill,
                             auto_idx=auto_idx)
    plan = global_plan(table, policy)
    report = SearchReport(
        measurements=measurements,
        exhaustive_measurements=n_k * n_p * (base_reps * (2 ** rounds - 1)),
        cells_swept=int(mask.sum()), cells_total=n_k * n_p)
    return plan, report


def evaluate_against_truth(chip: Chip, kernels, plan: Plan):
    """True (noise-free) totals of a plan vs the auto baseline."""
    pairs = plan.table.pairs
    T, E = chip.evaluate_grid(kernels, pairs)
    w = np.array([k.invocations for k in kernels], float)
    idx = np.arange(len(kernels))
    t = float((w * T[idx, plan.choice]).sum())
    e = float((w * E[idx, plan.choice]).sum())
    tb = float((w * T[:, plan.table.auto_idx]).sum())
    eb = float((w * E[:, plan.table.auto_idx]).sum())
    return 100 * (t / tb - 1), 100 * (e / eb - 1)
