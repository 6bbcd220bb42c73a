"""Clock domains, clock pairs, and frequency grids.

The paper sweeps (memory clock x core clock) pairs on an RTX 3080 Ti:
6 memory clocks x core clocks from 210..2100 MHz in 210 MHz steps, plus the
``auto`` pseudo-clock per domain (the vendor governor, which pursues max
clocks modulo power/thermal caps).  We keep that exact structure, but clocks
are attached to a :class:`~repro.core.power_model.Chip`, so the same grid
abstraction covers the GPU used by the paper, the A4000 of §9, and the
TPU-v5e-like chip this framework targets.

The port's copy of the JAX package's ``core/freq.py``, with :func:`h100_grid`.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

AUTO = "auto"


@dataclass(frozen=True, order=True)
class ClockPair:
    """One DVFS setting: (memory clock, core clock), in MHz or AUTO."""

    mem: object   # float MHz or AUTO
    core: object  # float MHz or AUTO

    def label(self) -> str:
        m = self.mem if self.mem == AUTO else f"{self.mem:g}"
        c = self.core if self.core == AUTO else f"{self.core:g}"
        return f"({m}, {c})"

    @property
    def is_auto(self) -> bool:
        return self.mem == AUTO and self.core == AUTO


@dataclass(frozen=True)
class FrequencyGrid:
    """The searchable set of clock pairs for one chip."""

    mem_clocks_mhz: Tuple[float, ...]    # ascending
    core_clocks_mhz: Tuple[float, ...]   # ascending
    include_auto: bool = True

    def pairs(self) -> List[ClockPair]:
        mems: List[object] = list(self.mem_clocks_mhz)
        cores: List[object] = list(self.core_clocks_mhz)
        if self.include_auto:
            mems = mems + [AUTO]
            cores = cores + [AUTO]
        return [ClockPair(m, c) for m, c in itertools.product(mems, cores)]

    @property
    def auto_pair(self) -> ClockPair:
        return ClockPair(AUTO, AUTO)

    def index_of(self, pair: ClockPair) -> int:
        return self.pairs().index(pair)

    def size(self) -> int:
        n_m = len(self.mem_clocks_mhz) + (1 if self.include_auto else 0)
        n_c = len(self.core_clocks_mhz) + (1 if self.include_auto else 0)
        return n_m * n_c


def paper_grid_3080ti() -> FrequencyGrid:
    """The exact search space of the paper (§4): 6 mem clocks; core clocks
    210..2100 MHz at 210 MHz increments (they skip the 15 MHz fine steps)."""
    return FrequencyGrid(
        mem_clocks_mhz=(405.0, 810.0, 5001.0, 9251.0, 9501.0),
        core_clocks_mhz=tuple(float(c) for c in range(210, 2101, 210)),
    )


def tpu_v5e_grid() -> FrequencyGrid:
    """TPU-v5e-like grid: relative steps expressed as pseudo-MHz.

    Public TPU clocks are not user-settable; this grid models the firmware
    DVFS states a power-management agent could request (10 core states, 6
    HBM states), mirroring the paper's search-space shape.
    """
    return FrequencyGrid(
        mem_clocks_mhz=(160.0, 320.0, 640.0, 1200.0, 1500.0, 1600.0),
        core_clocks_mhz=tuple(float(c) for c in range(94, 941, 94)),
    )


def h100_grid() -> FrequencyGrid:
    """NVIDIA H100 80GB HBM3 (SXM): the clocks its driver lists as supported
    (NVML ``nvmlDeviceGetSupportedMemoryClocks`` and
    ``...GraphicsClocks``, read once on the card and written here).

    It lists two memory clocks, 1593 and 2619 MHz, each with the same 110
    graphics clocks, 345..1980 MHz in 15 MHz steps.  The core grid takes
    them at the paper's 210 MHz spacing from the top clock down (1980,
    1770, .., 510), as :func:`paper_grid_3080ti` takes the 3080 Ti's.
    """
    return FrequencyGrid(
        mem_clocks_mhz=(1593.0, 2619.0),
        core_clocks_mhz=tuple(float(c) for c in range(510, 1981, 210)),
    )
