"""Analytical two-clock-domain performance/power model.

This is the *measurement substrate* standing in for the paper's hardware
campaign (§4: nvidia-smi clock pinning + NVML energy counters).  It is a
mechanistic model, not a curve fit:

* time     — three-term roofline (compute / HBM / ICI) + fixed launch
             overhead + a small serialization fraction (imperfect overlap),
* power    — static + per-domain dynamic ``u · f · V(f)^2`` with a
             piecewise-linear f→V curve (paper §2.2 fn.15),
* governor — a power cap that throttles the *core* clock when exceeded
             (NVIDIA-style).  This mechanism reproduces the paper's key
             signature: lowering the **memory** clock makes compute-bound
             GEMMs *faster* (Table 1: −2.36 % time at mem 5001), because the
             freed power headroom relieves core throttling.

All quantities are per-kernel; a kernel is described by its FLOPs, HBM
bytes, and ICI bytes (see ``core/workload.py``).

The port's copy of the JAX package's ``core/power_model.py``, with
:func:`h100_like` (``CHIPS["h100"]``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..hw import h100
from .freq import AUTO, ClockPair, FrequencyGrid, h100_grid, \
    paper_grid_3080ti, tpu_v5e_grid


@dataclass(frozen=True)
class KernelSpec:
    """Static description of one kernel invocation (one call, not xlayers)."""

    name: str
    kind: str                 # gemm | softmax | permute | residual | gelu |
    #                           layernorm | bias | embed | scan | conv |
    #                           dispatch | allreduce | optimizer | ...
    flops: float              # useful FLOPs
    hbm_bytes: float          # HBM traffic (read+write)
    ici_bytes: float = 0.0    # interconnect traffic
    invocations: int = 1      # times per iteration (e.g. x n_layers)
    phase: str = "fwd"        # fwd | bwd | loss | embed | opt

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


@dataclass(frozen=True)
class Chip:
    """Hardware constants for one chip model."""

    name: str
    peak_flops: float          # FLOP/s at max core clock
    hbm_bw: float              # B/s at max mem clock
    ici_bw: float              # B/s
    grid: FrequencyGrid
    # power (Watts)
    p_static: float
    p_core_max: float          # dynamic core power at fmax, util 1
    p_mem_max: float
    p_ici_max: float
    p_cap: float               # governor power cap
    # f→V curve: piecewise-linear (paper §2.2 fn.15).  Real V/F tables are
    # concave — steep near fmax (the top bins are the inefficient ones, §5).
    v_points_f: Tuple[float, ...] = (0.0, 0.43, 0.52, 0.67, 0.81, 0.90, 1.0)
    v_points_v: Tuple[float, ...] = (0.60, 0.60, 0.65, 0.69, 0.79, 0.88, 1.0)
    # time model
    launch_overhead_s: float = 2.0e-6
    serial_fraction: float = 0.04   # imperfect compute/memory overlap
    switch_latency_s: float = 100e-3  # user-side clock-switch latency
    # activity model: SMs burn issue power even when memory-bound; the
    # memory domain (DRAM+PHY) burns background power whenever clocked up.
    idle_activity: float = 0.08
    core_active_floor: float = 0.45
    mem_background: float = 0.45

    # ------------------------------------------------------------------
    def rel_clock(self, value, domain: str) -> float:
        """MHz (or AUTO) -> relative clock in (0, 1]."""
        clocks = (self.grid.mem_clocks_mhz if domain == "mem"
                  else self.grid.core_clocks_mhz)
        fmax = clocks[-1]
        if value == AUTO:
            return 1.0
        return float(value) / fmax

    def voltage(self, f_rel: float) -> float:
        return float(np.interp(f_rel, self.v_points_f, self.v_points_v))

    def domain_power_factor(self, f_rel: float) -> float:
        """Dynamic power multiplier f·V(f)² (== 1 at f=1)."""
        return f_rel * self.voltage(f_rel) ** 2

    # ------------------------------------------------------------------
    def _raw_time(self, k: KernelSpec, fc: float, fm: float) -> Tuple[float, float, float, float]:
        t_c = k.flops / (self.peak_flops * fc) if k.flops else 0.0
        # DRAM access efficiency degrades super-linearly at very low clocks
        # (latency/refresh overheads; §5: 405/810 MHz never win):
        bw_eff = fm * min(1.0, fm / 0.5)
        t_m = k.hbm_bytes / (self.hbm_bw * bw_eff) if k.hbm_bytes else 0.0
        t_i = k.ici_bytes / self.ici_bw if k.ici_bytes else 0.0
        bound = max(t_c, t_m, t_i)
        # imperfect overlap: a small fraction of the non-dominant terms
        # serializes (models issue dependencies & cache effects: the core
        # domain owns L1/L2, so memory ops also see the core clock).
        t = (self.launch_overhead_s + bound
             + self.serial_fraction * (t_c + t_m + t_i - bound))
        return t, t_c, t_m, t_i

    def _power(self, k: KernelSpec, fc: float, fm: float, t: float,
               t_c: float, t_m: float, t_i: float) -> float:
        u_c = min(t_c / t, 1.0) if t > 0 else 0.0
        u_m = min(t_m / t, 1.0) if t > 0 else 0.0
        u_i = min(t_i / t, 1.0) if t > 0 else 0.0
        # SMs issue loads/stores even on memory-bound kernels:
        u_c = max(u_c, self.core_active_floor)
        ia = self.idle_activity
        u_c = ia + (1 - ia) * u_c
        # DRAM/PHY background draw is utilization-independent:
        u_m = self.mem_background + (1 - self.mem_background) * u_m
        return (self.p_static
                + self.p_core_max * u_c * self.domain_power_factor(fc)
                + self.p_mem_max * u_m * self.domain_power_factor(fm)
                + self.p_ici_max * u_i)

    def deepest_pair(self) -> ClockPair:
        """The lowest grid point in both domains — the park state a
        drained serving replica sits in (autoscale-down as a DVFS
        decision: parking is just the deepest frequency assignment)."""
        return ClockPair(self.grid.mem_clocks_mhz[0],
                         self.grid.core_clocks_mhz[0])

    def idle_power(self, pair: Optional[ClockPair] = None) -> float:
        """Power (W) of the chip holding ``pair`` with no work resident:
        the zero-utilization limit of the activity model (SM issue floor
        does not apply — nothing issues; DRAM background draw does)."""
        if pair is None:
            pair = ClockPair(AUTO, AUTO)
        fc = self.rel_clock(pair.core, "core")
        fm = self.rel_clock(pair.mem, "mem")
        return (self.p_static
                + self.p_core_max * self.idle_activity
                * self.domain_power_factor(fc)
                + self.p_mem_max * self.mem_background
                * self.domain_power_factor(fm))

    def evaluate(self, k: KernelSpec, pair: ClockPair) -> Tuple[float, float]:
        """True (noise-free) per-invocation (time_s, energy_J) for a kernel
        at a clock pair, including the power-cap governor."""
        fc = self.rel_clock(pair.core, "core")
        fm = self.rel_clock(pair.mem, "mem")
        # governor: throttle the core clock until under the power cap
        fc_eff = fc
        for _ in range(4):
            t, t_c, t_m, t_i = self._raw_time(k, fc_eff, fm)
            p = self._power(k, fc_eff, fm, t, t_c, t_m, t_i)
            if p <= self.p_cap or fc_eff <= 0.05:
                break
            # power ~ fc·V(fc)^2 ~ fc^3 in the linear-V regime
            fc_eff = max(fc_eff * (self.p_cap / p) ** (1.0 / 3.0), 0.05)
        t, t_c, t_m, t_i = self._raw_time(k, fc_eff, fm)
        p = self._power(k, fc_eff, fm, t, t_c, t_m, t_i)
        return t, p * t

    def evaluate_grid(self, kernels, pairs) -> Tuple[np.ndarray, np.ndarray]:
        """(n_kernels, n_pairs) noise-free time and energy tables
        (per invocation)."""
        T = np.zeros((len(kernels), len(pairs)))
        E = np.zeros_like(T)
        for i, k in enumerate(kernels):
            for j, pr in enumerate(pairs):
                T[i, j], E[i, j] = self.evaluate(k, pr)
        return T, E


# ---------------------------------------------------------------------------
# Chip definitions
# ---------------------------------------------------------------------------

def rtx3080ti_like() -> Chip:
    """The paper's testbed (§4), as a mechanistic model.

    12 GB GDDR6X @ 912 GB/s; ~34 fp32 TFLOP/s (llm.c mixed precision lands
    higher; absolute scale cancels out of all relative results).  Power
    split calibrated so the GPT-3-xl campaign reproduces the paper's
    Table 1/2 regime (see EXPERIMENTS.md §Paper-repro).
    """
    return Chip(
        name="rtx3080ti-like",
        peak_flops=34e12,
        hbm_bw=912e9,
        ici_bw=25e9,
        grid=paper_grid_3080ti(),
        p_static=45.0,
        p_core_max=240.0,
        p_mem_max=130.0,
        p_ici_max=10.0,
        p_cap=330.0,
        switch_latency_s=100e-3,
    )


def a4000_like() -> Chip:
    """§9 heterogeneity study: workstation card, lower cap, tighter V range
    (less aggressive clock reduction pays off less)."""
    return Chip(
        name="a4000-like",
        peak_flops=19.2e12,
        hbm_bw=448e9,
        ici_bw=25e9,
        grid=FrequencyGrid(
            mem_clocks_mhz=(405.0, 810.0, 3500.0, 6500.0, 7001.0),
            core_clocks_mhz=tuple(float(c) for c in range(210, 1561, 135)),
        ),
        p_static=35.0,
        p_core_max=92.0,
        p_mem_max=40.0,
        p_ici_max=5.0,
        p_cap=139.0,
        # narrower voltage range -> less DVFS headroom (§9: "kernels prefer
        # the same clock types, but reduce the clocks less aggressively").
        # Calibrated to the paper's A4000 result (-9.56% strict waste):
        # ours lands at -9.84%.
        v_points_f=(0.0, 0.45, 0.60, 0.80, 0.92, 1.0),
        v_points_v=(0.70, 0.70, 0.75, 0.82, 0.90, 1.0),
        switch_latency_s=100e-3,
    )


def tpu_v5e_like() -> Chip:
    """The deployment target: TPU v5e constants (197 bf16 TFLOP/s, 819 GB/s
    HBM, ~50 GB/s/link ICI), with an IVR-class switch latency (the ASPLOS'24
    fine-grain DVFS result the paper builds its argument on)."""
    return Chip(
        name="tpu-v5e-like",
        peak_flops=197e12,
        hbm_bw=819e9,
        ici_bw=50e9,
        grid=tpu_v5e_grid(),
        p_static=55.0,
        p_core_max=130.0,
        p_mem_max=45.0,
        p_ici_max=15.0,
        p_cap=230.0,
        launch_overhead_s=1.0e-6,
        switch_latency_s=1e-6,   # IVR-class
    )


def h100_like() -> Chip:
    """The port's card, NVIDIA H100 80GB HBM3 (SXM), in the form of
    :func:`rtx3080ti_like`.  Each constant and its source:

    * ``peak_flops`` 989e12 (bf16 dense) and ``hbm_bw`` 3.35e12 B/s:
      NVIDIA's data sheet (:mod:`repro_torch.hw.h100`), the peaks
      ``chip_smoke.py``'s kernel bounds use;
    * ``ici_bw`` 450e9 B/s: NVLink 4, 900 GB/s both directions (data
      sheet, ``hw.h100.NVLINK_BW``); no one-card path uses it;
    * ``p_cap`` 700 W: the card's ``power.limit`` as ``nvidia-smi`` reads it;
    * ``launch_overhead_s`` 3e-6: the ~2.6-3.0 us a kernel of a decode step
      measured on the card (``PERF.md`` section 5);
    * ``switch_latency_s`` 100e-3: the NVML user-side clock switch, as the
      paper and :func:`rtx3080ti_like` take it;
    * ``grid``: :func:`~repro_torch.core.freq.h100_grid`, read from the card;
    * ``p_static``, ``p_core_max``, ``p_mem_max``, ``p_ici_max``: an
      assumption, not a fit: :func:`rtx3080ti_like`'s split (45, 240, 130,
      10 W under a 330 W cap) scaled by 700 / 330, rounded to 5 W.  The f->V
      curve and the activity model are the :class:`Chip` defaults.
    """
    return Chip(
        name="h100-like",
        peak_flops=h100.PEAK_FLOPS_BF16,
        hbm_bw=h100.HBM_BW,
        ici_bw=h100.NVLINK_BW,
        grid=h100_grid(),
        p_static=95.0,
        p_core_max=510.0,
        p_mem_max=275.0,
        p_ici_max=20.0,
        p_cap=700.0,
        launch_overhead_s=3.0e-6,
        switch_latency_s=100e-3,
    )


CHIPS = {
    "rtx3080ti": rtx3080ti_like,
    "a4000": a4000_like,
    "tpu-v5e": tpu_v5e_like,
    "h100": h100_like,
}


def get_chip(name: str) -> Chip:
    return CHIPS[name]()
