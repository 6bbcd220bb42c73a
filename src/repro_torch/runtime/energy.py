"""Runtime DVFS execution: frequency controllers and energy metering.

``FrequencyController`` is the deployment contract a DVFS plan executes
against.  On the paper's hardware this is the NVML/SMI path (~100 ms
switches); on IVR-class hardware it is a µs-scale register write; on TPU it
is the host power-management agent.  This container ships the
``SimulatedController`` which replays a :class:`DVFSSchedule` against the
analytical chip model and integrates energy — the accounting used by the
example training runs.

The port's copy of the JAX package's ``runtime/energy.py``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol

import numpy as np

from ..core.coalesce import SWITCH_POWER_W
from ..core.freq import AUTO, ClockPair
from ..core.power_model import Chip, KernelSpec
from ..core.schedule import DVFSSchedule


class FrequencyController(Protocol):
    """Driver contract for applying clock pairs around kernel launches."""

    def set_clocks(self, pair: ClockPair) -> None: ...
    def reset(self) -> None: ...
    @property
    def switch_latency_s(self) -> float: ...


class SimulatedController:
    """Tracks requested clocks + accumulated switch overhead."""

    def __init__(self, chip: Chip):
        self.chip = chip
        self.current = ClockPair(AUTO, AUTO)
        self.n_switches = 0
        self.switch_time_s = 0.0

    @property
    def switch_latency_s(self) -> float:
        return self.chip.switch_latency_s

    def set_clocks(self, pair: ClockPair) -> None:
        if pair != self.current:
            self.n_switches += 1
            self.switch_time_s += self.chip.switch_latency_s
            self.current = pair

    def reset(self) -> None:
        self.set_clocks(ClockPair(AUTO, AUTO))


@dataclass
class StepEnergy:
    step: int
    time_s: float
    energy_j: float
    n_switches: int


class EnergyMeter:
    """Per-step energy accounting for a training/serving loop.

    Given the iteration's DVFS schedule (or the auto baseline) it integrates
    the analytical model's energy; with real hardware this class would wrap
    the NVML total-energy counter exactly as the paper does (§4).
    """

    def __init__(self, chip: Chip, kernels: List[KernelSpec],
                 schedule: Optional[DVFSSchedule] = None):
        self.chip = chip
        self.kernels = kernels
        self.schedule = schedule
        self.records: List[StepEnergy] = []
        self._auto = ClockPair(AUTO, AUTO)
        # precompute per-iteration totals
        self._iter_time, self._iter_energy, self._iter_switches = \
            self._integrate()

    def _integrate(self):
        if self.schedule is None:
            t = e = 0.0
            for k in self.kernels:
                kt, ke = self.chip.evaluate(k, self._auto)
                t += kt * k.invocations
                e += ke * k.invocations
            return t, e, 0
        t = e = 0.0
        n_sw = self.schedule.n_switches
        # legacy schedules (entries without indices) fall back to a
        # best-effort name lookup over the "+"-coalesced display string
        by_name = {}
        if any(entry.kernel_idx is None for entry in self.schedule.entries):
            for k in self.kernels:
                by_name.setdefault(k.name, k)
        for entry in self.schedule.entries:
            pair = ClockPair(entry.mem, entry.core)
            if entry.kernel_idx is not None:
                # exact path: entries carry (kernel index, count) pairs, so
                # colliding names or names containing "+" integrate exactly
                for ki, cnt in entry.kernel_idx:
                    kt, ke = self.chip.evaluate(self.kernels[int(ki)], pair)
                    t += kt * cnt
                    e += ke * cnt
                continue
            for nm in entry.kernel.split("+"):
                k = by_name.get(nm)
                if k is None:
                    continue
                kt, ke = self.chip.evaluate(k, pair)
                t += kt * k.invocations
                e += ke * k.invocations
        t += n_sw * self.chip.switch_latency_s
        e += n_sw * self.chip.switch_latency_s * SWITCH_POWER_W
        return t, e, n_sw

    def on_step(self, step: int) -> StepEnergy:
        rec = StepEnergy(step=step, time_s=self._iter_time,
                         energy_j=self._iter_energy,
                         n_switches=self._iter_switches)
        self.records.append(rec)
        return rec

    def totals(self) -> Dict[str, float]:
        return {
            "steps": len(self.records),
            "time_s": sum(r.time_s for r in self.records),
            "energy_j": sum(r.energy_j for r in self.records),
        }
