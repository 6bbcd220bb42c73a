"""Frequency planners: pass-level vs kernel-level, local vs global.

The paper's comparison matrix (Table 2):

* granularity — coarse (one clock pair per *pass*) vs fine (per *kernel*);
* aggregation — local optima (every unit obeys the time constraint on its
  own) vs global optimum (only the *total* time is constrained; kernels
  cooperatively trade slack — found with a constraint solver in the paper).

The global problem is a multiple-choice knapsack:

    min Σ_k w_k · e[k, c_k]   s.t.   Σ_k w_k · t[k, c_k] ≤ (1+τ)·T_auto .

We solve it with Lagrangian relaxation (binary search on λ, optimal up to
the duality gap on the discrete frontier) followed by a greedy slack
refill, and provide an exact discretized DP for cross-validation.

The port's copy of the JAX package's ``core/planner.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .freq import ClockPair
from .measure import MeasurementTable
from .objectives import WastePolicy, pct


@dataclass
class Plan:
    """A per-kernel clock assignment plus expected outcome."""

    name: str
    choice: np.ndarray                  # (n_kernels,) pair index
    table: MeasurementTable
    time_s: float = 0.0
    energy_j: float = 0.0
    base_time_s: float = 0.0
    base_energy_j: float = 0.0

    def __post_init__(self):
        self.time_s, self.energy_j = self.table.totals(self.choice)
        self.base_time_s, self.base_energy_j = self.table.baseline_totals()

    @property
    def time_pct(self) -> float:
        return pct(self.time_s, self.base_time_s)

    @property
    def energy_pct(self) -> float:
        return pct(self.energy_j, self.base_energy_j)

    def summary(self) -> Dict:
        return {"plan": self.name,
                "time_pct": round(self.time_pct, 3),
                "energy_pct": round(self.energy_pct, 3),
                "time_s": self.time_s, "energy_j": self.energy_j,
                "base_time_s": self.base_time_s,
                "base_energy_j": self.base_energy_j}

    def per_kernel(self) -> List[Dict]:
        rows = []
        t = self.table
        for i, k in enumerate(t.kernels):
            c = int(self.choice[i])
            rows.append({
                "kernel": k.name, "kind": k.kind,
                "invocations": k.invocations,
                "mem": t.pairs[c].mem, "core": t.pairs[c].core,
                "time_pct": pct(t.time[i, c], t.time[i, t.auto_idx]),
                "energy_pct": pct(t.energy[i, c],
                                  t.energy[i, t.auto_idx]),
            })
        return rows


# ---------------------------------------------------------------------------
# Kernel-level planners
# ---------------------------------------------------------------------------

def local_plan(table: MeasurementTable, policy: Optional[WastePolicy] = None
               ) -> Plan:
    """Every kernel independently obeys t_k <= (1+tau) * t_k(auto)."""
    policy = policy if policy is not None else WastePolicy()
    n, _ = table.time.shape
    choice = np.full(n, table.auto_idx)
    for k in range(n):
        budget = (1.0 + policy.tau) * table.time[k, table.auto_idx]
        feas = table.time[k] <= budget * (1 + 1e-12)
        if feas.any():
            e = np.where(feas, table.energy[k], np.inf)
            choice[k] = int(np.argmin(e))
    return Plan("kernel-local", choice, table)


def _lagrangian_choice(table: MeasurementTable, lam: float) -> np.ndarray:
    score = table.energy + lam * table.time
    return np.argmin(score, axis=1)


def global_plan(table: MeasurementTable, policy: Optional[WastePolicy] = None,
                refine: bool = True) -> Plan:
    """Global optimum: only the total time is constrained (paper's
    constraint-solver aggregation), via Lagrangian relaxation + greedy
    slack refill."""
    policy = policy if policy is not None else WastePolicy()
    t_base, _ = table.baseline_totals()
    budget = policy.budget(t_base)

    choice = _lagrangian_choice(table, 0.0)
    t_tot, _ = table.totals(choice)
    if t_tot > budget:
        lo, hi = 0.0, 1.0
        while True:  # find upper bracket
            choice = _lagrangian_choice(table, hi)
            t_tot, _ = table.totals(choice)
            if t_tot <= budget or hi > 1e18:
                break
            hi *= 8.0
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            choice = _lagrangian_choice(table, mid)
            t_tot, _ = table.totals(choice)
            if t_tot <= budget:
                hi = mid
            else:
                lo = mid
        choice = _lagrangian_choice(table, hi)

    if refine:
        choice = _greedy_refill(table, choice, budget)
    return Plan("kernel-global", choice, table)


def _greedy_refill(table: MeasurementTable, choice: np.ndarray,
                   budget: float) -> np.ndarray:
    """Spend leftover time slack on the best remaining ΔE/Δt swaps.

    The running total and the per-kernel (Δt, ΔE) rows are maintained
    incrementally: a swap only touches kernel ``k``, so only row ``k`` of
    the delta matrices (and the scalar totals) change — O(n_pairs) per
    swap instead of the former O(n·n_pairs) ``table.totals`` recompute.
    """
    choice = choice.copy()
    w = table.weights
    idx = np.arange(len(table.kernels))
    Tw = table.time * w[:, None]                   # (n, pairs) weighted
    Ew = table.energy * w[:, None]
    t_tot = float(Tw[idx, choice].sum())
    dt = Tw - Tw[idx, choice][:, None]             # delta vs current choice
    de = Ew - Ew[idx, choice][:, None]
    for _ in range(4 * len(choice)):
        slack = budget - t_tot
        # candidates: save energy, fit in slack
        ok = (de < -1e-15) & (dt <= slack + 1e-15)
        if not ok.any():
            break
        ratio = np.where(ok, de / np.maximum(dt, 1e-12), np.inf)
        # prefer swaps that save energy per unit time spent; free swaps
        # (dt<=0, de<0) first
        free = ok & (dt <= 0)
        if free.any():
            gain = np.where(free, de, 0.0)
            k, c = np.unravel_index(np.argmin(gain), gain.shape)
        else:
            k, c = np.unravel_index(np.argmin(ratio), ratio.shape)
        if choice[k] == c:
            break
        t_tot += dt[k, c]
        choice[k] = c
        dt[k] = Tw[k] - Tw[k, c]
        de[k] = Ew[k] - Ew[k, c]
    return choice


def global_plan_dp(table: MeasurementTable,
                   policy: Optional[WastePolicy] = None,
                   n_bins: int = 2000) -> Plan:
    """Exact (discretized) multiple-choice knapsack DP, for validation."""
    policy = policy if policy is not None else WastePolicy()
    t_base, _ = table.baseline_totals()
    budget = policy.budget(t_base)
    w = table.weights
    T = table.time * w[:, None]
    E = table.energy * w[:, None]
    scale = n_bins / budget
    Tq = np.ceil(T * scale).astype(int)
    best = np.full(n_bins + 1, np.inf)
    best[0] = 0.0
    parent: List[np.ndarray] = []
    for k in range(len(table.kernels)):
        new = np.full(n_bins + 1, np.inf)
        arg = np.full(n_bins + 1, -1)
        for c in range(T.shape[1]):
            tq = Tq[k, c]
            if tq > n_bins:
                continue
            cand = np.full(n_bins + 1, np.inf)
            cand[tq:] = best[:n_bins + 1 - tq] + E[k, c]
            upd = cand < new
            new[upd] = cand[upd]
            arg[upd] = c
        parent.append(arg)
        best = new
    end = int(np.argmin(best))
    if not np.isfinite(best[end]):
        return Plan("kernel-global-dp",
                    np.full(len(table.kernels), table.auto_idx), table)
    choice = np.zeros(len(table.kernels), dtype=int)
    b = end
    for k in range(len(table.kernels) - 1, -1, -1):
        c = int(parent[k][b])
        choice[k] = c
        b -= Tq[k, c]
    return Plan("kernel-global-dp", choice, table)


# ---------------------------------------------------------------------------
# Pass-level (coarse-grained) planners
# ---------------------------------------------------------------------------

PASS_GROUPS = ("embed", "fwd", "loss", "bwd", "opt")


def _pass_tables(table: MeasurementTable) -> Dict[str, np.ndarray]:
    """Aggregate the kernel grid into per-pass (time, energy) rows."""
    phases = np.array([k.phase for k in table.kernels])
    w = table.weights[:, None]
    out = {}
    for ph in PASS_GROUPS:
        m = phases == ph
        if m.any():
            out[ph] = (np.sum(table.time[m] * w[m], axis=0),
                       np.sum(table.energy[m] * w[m], axis=0))
    return out


def pass_level_plan(table: MeasurementTable,
                    policy: Optional[WastePolicy] = None,
                    aggregation: str = "global") -> Plan:
    """One clock pair per pass (the paper's §5 coarse baseline)."""
    policy = policy if policy is not None else WastePolicy()
    groups = _pass_tables(table)
    names = list(groups)
    Tm = np.stack([groups[g][0] for g in names])   # (n_pass, n_pairs)
    Em = np.stack([groups[g][1] for g in names])
    auto = table.auto_idx
    if aggregation == "local":
        sel = {}
        for gi, g in enumerate(names):
            budget = (1.0 + policy.tau) * Tm[gi, auto]
            feas = Tm[gi] <= budget * (1 + 1e-12)
            e = np.where(feas, Em[gi], np.inf)
            sel[g] = int(np.argmin(e)) if feas.any() else auto
    else:
        # global over passes: tiny multiple-choice knapsack, solved exactly
        # by Lagrangian + refill on a pass-level pseudo-table
        pseudo = MeasurementTable(
            chip_name=table.chip_name,
            kernels=[dataclasses.replace(table.kernels[0], name=g,
                                         invocations=1) for g in names],
            pairs=table.pairs, time=Tm, energy=Em, auto_idx=auto)
        p = global_plan(pseudo, policy)
        sel = {g: int(p.choice[gi]) for gi, g in enumerate(names)}
    choice = np.array([sel.get(k.phase, auto) for k in table.kernels])
    return Plan(f"pass-{aggregation}", choice, table)


# ---------------------------------------------------------------------------
# EDP planners (prior-work objective, for Table 2)
# ---------------------------------------------------------------------------

def edp_local_plan(table: MeasurementTable) -> Plan:
    """Per-kernel argmin of t*e."""
    choice = np.argmin(table.time * table.energy, axis=1)
    return Plan("edp-local", choice, table)


def edp_global_plan(table: MeasurementTable, n_lambda: int = 200) -> Plan:
    """Global EDP: min (Σt)(Σe).  Sweep the Lagrangian frontier (all
    Pareto-optimal (T,E) aggregates) and pick the min-product point."""
    lams = np.concatenate([[0.0], np.logspace(-6, 18, n_lambda)])
    best = None
    for lam in lams:
        choice = _lagrangian_choice(table, lam)
        t, e = table.totals(choice)
        if best is None or t * e < best[0]:
            best = (t * e, choice)
    return Plan("edp-global", best[1], table)


def edp_pass_plan(table: MeasurementTable) -> Plan:
    """Coarse-grained EDP (per-pass argmin of pass-aggregated t*e)."""
    groups = _pass_tables(table)
    sel = {g: int(np.argmin(groups[g][0] * groups[g][1])) for g in groups}
    choice = np.array([sel.get(k.phase, table.auto_idx)
                       for k in table.kernels])
    return Plan("edp-pass", choice, table)
