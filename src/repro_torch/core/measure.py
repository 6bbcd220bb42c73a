"""Measurement campaign simulator.

Stands in for the paper's §4 workflow (warm-up, clock pinning, 5 s windows,
NVML energy counters).  Produces a :class:`MeasurementTable` — the
(kernel × clock-pair) → (time, energy) grid every planner consumes.  The
noise model mirrors the paper's observations: power/energy readings are
noisier than CUDA-event timings (§7: "the variability in our measurements
is mostly caused by the latter [power]"), and planner selection bias over
that noise is what creates the discovered-vs-realized gap of Fig. 7.

The port's copy of the JAX package's ``core/measure.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from .freq import AUTO, ClockPair
from .power_model import Chip, KernelSpec


@dataclass
class MeasurementTable:
    """Per-invocation time/energy for each (kernel, clock pair)."""

    chip_name: str
    kernels: List[KernelSpec]
    pairs: List[ClockPair]
    time: np.ndarray      # (n_kernels, n_pairs), seconds
    energy: np.ndarray    # (n_kernels, n_pairs), Joules
    auto_idx: int

    @property
    def weights(self) -> np.ndarray:
        return np.array([k.invocations for k in self.kernels], dtype=float)

    def totals(self, choice: np.ndarray):
        """(total_time, total_energy) for a per-kernel clock choice."""
        w = self.weights
        idx = np.arange(len(self.kernels))
        return (float((w * self.time[idx, choice]).sum()),
                float((w * self.energy[idx, choice]).sum()))

    def baseline_totals(self):
        base = np.full(len(self.kernels), self.auto_idx)
        return self.totals(base)

    def subset(self, mask: Sequence[bool]) -> "MeasurementTable":
        mask = np.asarray(mask)
        return MeasurementTable(
            chip_name=self.chip_name,
            kernels=[k for k, m in zip(self.kernels, mask) if m],
            pairs=self.pairs, time=self.time[mask],
            energy=self.energy[mask], auto_idx=self.auto_idx)

    def subset_pairs(self, idx: Sequence[int]) -> "MeasurementTable":
        """Column counterpart of :meth:`subset`: restrict the clock-pair
        vocabulary to ``idx`` (e.g. a thermal cap clamping the grid).
        The AUTO pair must survive — every planner budget is anchored on
        ``auto_idx``."""
        idx = [int(i) for i in idx]
        if self.auto_idx not in idx:
            raise ValueError("subset_pairs must keep the AUTO pair "
                             "(planner budgets anchor on auto_idx)")
        return MeasurementTable(
            chip_name=self.chip_name, kernels=list(self.kernels),
            pairs=[self.pairs[i] for i in idx],
            time=self.time[:, idx].copy(),
            energy=self.energy[:, idx].copy(),
            auto_idx=idx.index(self.auto_idx))


@dataclass
class NoiseModel:
    """Multiplicative lognormal noise; energy noisier than time (§7)."""

    time_sigma: float = 0.002
    power_sigma: float = 0.008

    def sample(self, rng: np.random.Generator, t: np.ndarray,
               e: np.ndarray):
        tn = t * np.exp(rng.normal(0.0, self.time_sigma, t.shape))
        # energy = power * time; power noise is independent
        pn = np.exp(rng.normal(0.0, self.power_sigma, e.shape))
        return tn, e * pn * (tn / t)


class Campaign:
    """Simulated exhaustive search over (kernel x clock) combinations.

    ``n_reps`` models the paper's 5-second measurement windows (longer
    windows average more executions -> lower effective noise).
    """

    def __init__(self, chip: Chip, noise: Optional[NoiseModel] = None,
                 seed: int = 0, n_reps: int = 1):
        self.chip = chip
        self.noise = noise or NoiseModel()
        self.rng = np.random.default_rng(seed)
        self.n_reps = n_reps

    def run(self, kernels: Sequence[KernelSpec],
            pairs: Optional[Sequence[ClockPair]] = None,
            noisy: bool = True) -> MeasurementTable:
        pairs = list(pairs) if pairs is not None else self.chip.grid.pairs()
        T, E = self.chip.evaluate_grid(kernels, pairs)
        if noisy:
            acc_t = np.zeros_like(T)
            acc_e = np.zeros_like(E)
            for _ in range(self.n_reps):
                tn, en = self.noise.sample(self.rng, T, E)
                acc_t += tn
                acc_e += en
            T, E = acc_t / self.n_reps, acc_e / self.n_reps
        auto_idx = pairs.index(ClockPair(AUTO, AUTO))
        return MeasurementTable(
            chip_name=self.chip.name, kernels=list(kernels), pairs=pairs,
            time=T, energy=E, auto_idx=auto_idx)

    def remeasure(self, table: MeasurementTable,
                  choice: np.ndarray, n_reps: Optional[int] = None):
        """Fresh measurement of a chosen plan vs auto (the Fig. 7
        validation): returns (time_plan, energy_plan, time_auto,
        energy_auto) totals under new noise draws."""
        n_reps = n_reps or self.n_reps
        T, E = self.chip.evaluate_grid(table.kernels, table.pairs)
        tn, en = self.noise.sample(self.rng, T, E)
        w = table.weights
        idx = np.arange(len(table.kernels))
        t_plan = float((w * tn[idx, choice]).sum())
        e_plan = float((w * en[idx, choice]).sum())
        tn2, en2 = self.noise.sample(self.rng, T, E)
        t_auto = float((w * tn2[idx, table.auto_idx]).sum())
        e_auto = float((w * en2[idx, table.auto_idx]).sum())
        return t_plan, e_plan, t_auto, e_auto
