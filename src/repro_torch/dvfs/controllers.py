"""Frequency-controller backends, registered by name.

The :class:`~repro.runtime.energy.FrequencyController` protocol is the
deployment contract a plan executes against.  This module makes the
backend pluggable the same way governors are::

    ctl = controller("simulated", chip)          # ideal analytic replay
    ctl = controller("rate-limited", chip,       # real-driver constraints
                     min_interval_s=1e-3)

* ``simulated`` — :class:`~repro.runtime.energy.SimulatedController`:
  every requested switch lands, charged at the chip's switch latency.
* ``rate-limited`` — :class:`RateLimitedController`: models the two
  constraints real DVFS drivers impose (NVML ~100 ms application paths,
  locked sysfs intervals, firmware mailboxes):

  1. **step quantization** — arbitrary requested MHz snap to the chip's
     discrete frequency grid (drivers expose a table, not a dial);
  2. **rate limiting** — a request arriving within ``min_interval_s`` of
     the previous *applied* switch is dropped (the clocks simply stay
     put), counted in ``n_throttled``.  Executors advance the
     controller's virtual clock with each schedule entry's dwell, so the
     limit is enforced in modeled time, not host wall time.

Plans replayed through a rate-limited controller therefore realize fewer
switches than planned when the schedule switches faster than the driver
can — the paper's §9 observation that high switching latencies "worsen
the DVFS potential".  The executor surfaces this as realized switch
counts and an ``n_throttled`` total in its summary; the *energy/time*
integration itself stays plan-analytic (the meter charges the planned
schedule), so use the coalesce planner's ``switch_latency_s`` to model
the energy cost of slow switching, and this backend to audit how much of
a schedule a constrained driver would actually admit.

The port's copy of the JAX package's ``dvfs/controllers.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.freq import AUTO, ClockPair
from ..core.power_model import Chip
from ..runtime.energy import FrequencyController, SimulatedController

CONTROLLERS: Dict[str, type] = {}


def register_controller(name: str):
    """Class decorator: make a controller constructible by name."""
    def deco(cls):
        CONTROLLERS[name] = cls
        return cls
    return deco


def controller(name: str, chip: Chip, **kwargs) -> FrequencyController:
    """Instantiate a registered controller backend by name."""
    if name not in CONTROLLERS:
        raise ValueError(f"unknown controller {name!r}; registered: "
                         f"{sorted(CONTROLLERS)}")
    return CONTROLLERS[name](chip, **kwargs)


register_controller("simulated")(SimulatedController)


@register_controller("rate-limited")
class RateLimitedController:
    """Step-quantized, rate-limited controller (real driver constraints).

    Tracks the same observables as the simulated backend (``current``,
    ``n_switches``, ``switch_time_s``) plus ``n_throttled`` /
    ``n_quantized`` so an executor summary shows how much of the plan the
    driver actually admitted.
    """

    def __init__(self, chip: Chip, min_interval_s: float = 0.0,
                 quantize: bool = True, retry_backoff_s: float = 1e-3,
                 max_retries: int = 4):
        self.chip = chip
        self.min_interval_s = float(min_interval_s)
        self.quantize = quantize
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_retries = int(max_retries)
        self.current = ClockPair(AUTO, AUTO)
        self.n_switches = 0
        self.n_throttled = 0
        self.n_quantized = 0
        self.n_failed = 0
        self.n_giveups = 0
        #: structured log of driver faults / failed set-clocks / retries
        self.controller_events: list = []
        self.switch_time_s = 0.0
        self._t = 0.0                    # modeled time (advance())
        self._last_switch_t = -np.inf
        self._fail_until = -np.inf       # driver-fault window (modeled t)
        self._retry = None               # (pair, attempt, due_t) or None

    @property
    def switch_latency_s(self) -> float:
        return self.chip.switch_latency_s

    def _snap(self, value, grid_values) -> object:
        if value == AUTO or not self.quantize:
            return value
        arr = np.asarray(grid_values, dtype=float)
        snapped = float(arr[int(np.argmin(np.abs(arr - float(value))))])
        if snapped != float(value):
            self.n_quantized += 1
        return snapped

    def inject_failure(self, duration_s: float) -> None:
        """Open (or extend) a driver-fault window: every ``set_clocks``
        inside it returns an error, in modeled *busy* time (``_t`` only
        advances with schedule-entry dwells)."""
        until = self._t + max(float(duration_s), 0.0)
        self._fail_until = max(self._fail_until, until)
        self.controller_events.append(
            {"t": self._t, "event": "driver-fault",
             "until": float(self._fail_until)})

    def _apply(self, pair: ClockPair) -> None:
        self.n_switches += 1
        self.switch_time_s += self.chip.switch_latency_s
        self._last_switch_t = self._t
        self.current = pair

    def set_clocks(self, pair: ClockPair) -> None:
        g = self.chip.grid
        pair = ClockPair(self._snap(pair.mem, g.mem_clocks_mhz),
                         self._snap(pair.core, g.core_clocks_mhz))
        # a new request supersedes any pending retry (latest wins —
        # retrying a stale target would fight the plan)
        self._retry = None
        if pair == self.current:
            return
        if self._t - self._last_switch_t < self.min_interval_s:
            self.n_throttled += 1        # driver refuses: clocks stay put
            return
        if self._t < self._fail_until:
            # driver error: clocks stay on the LAST APPLIED pair (never
            # the requested one); schedule a capped-backoff retry
            self.n_failed += 1
            due = self._t + self.retry_backoff_s
            self.controller_events.append(
                {"t": self._t, "event": "set-freq-fail",
                 "requested": [pair.mem, pair.core],
                 "retry_t": float(due)})
            self._retry = (pair, 1, due)
            return
        self._apply(pair)

    def _pump_retry(self) -> None:
        while self._retry is not None:
            pair, attempt, due = self._retry
            if self._t < due:
                return
            if due >= self._fail_until:
                self._retry = None
                self._apply(pair)
                self.controller_events.append(
                    {"t": self._t, "event": "set-freq-retry-ok",
                     "applied": [pair.mem, pair.core],
                     "attempt": attempt})
                return
            if attempt >= self.max_retries:
                self._retry = None
                self.n_giveups += 1
                self.controller_events.append(
                    {"t": self._t, "event": "set-freq-giveup",
                     "requested": [pair.mem, pair.core],
                     "attempts": attempt})
                return
            self.n_failed += 1
            backoff = min(self.retry_backoff_s * 2.0 ** attempt,
                          16.0 * self.retry_backoff_s)
            self.controller_events.append(
                {"t": self._t, "event": "set-freq-retry-fail",
                 "requested": [pair.mem, pair.core],
                 "attempt": attempt + 1,
                 "retry_t": float(due + backoff)})
            self._retry = (pair, attempt + 1, due + backoff)

    def advance(self, dt: float) -> None:
        """Advance modeled time (called by executors with entry dwells),
        then land any due retry of a failed set-clocks."""
        self._t += max(float(dt), 0.0)
        self._pump_retry()

    def reset(self) -> None:
        # returning the chip to the governor always succeeds (drivers let
        # you release a lock even mid-interval)
        self._retry = None
        if self.current != ClockPair(AUTO, AUTO):
            self.n_switches += 1
            self.switch_time_s += self.chip.switch_latency_s
            self._last_switch_t = self._t
            self.current = ClockPair(AUTO, AUTO)
