"""Optimization goals: compute-waste reduction (the paper's §3) and EDP.

``waste`` (strict): minimize energy subject to *no* time loss vs the auto
baseline.  ``waste`` (relaxed, τ): time loss at most τ.  ``edp``: minimize
t·e — the prior-work objective the paper argues against (it happily trades
10 % slowdowns for energy; Table 2).

The port's copy of the JAX package's ``core/objectives.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass(frozen=True)
class WastePolicy:
    """Strict (tau=0) or relaxed (tau>0) waste-reduction policy."""

    tau: float = 0.0

    def budget(self, baseline_time: float) -> float:
        return (1.0 + self.tau) * baseline_time

    def feasible(self, time: float, baseline_time: float) -> bool:
        return time <= self.budget(baseline_time) * (1 + 1e-12)


def edp(t: float, e: float) -> float:
    return t * e


def ed2p(t: float, e: float) -> float:
    return t * t * e


def compute_waste(e: float, e_opt: float) -> float:
    """Paper Eq. (2): waste = e - e_o for the best config dominating on
    both axes.  Lower is better; 0 means no degenerate inefficiency."""
    return e - e_opt


def pct(new: float, base: float) -> float:
    """Percent change vs baseline (negative = saving)."""
    return 100.0 * (new - base) / base
