"""Fault-tolerance runtime: failure injection and the straggler watchdog.

The port's own copy of the JAX package's ``runtime/ft.py`` (without the
heartbeat registry, which no ported module uses yet).

At 1000+ nodes, step-time outliers (stragglers) and node failures are the
norm.  The trainer integrates:

* ``FailureInjector`` — deterministic fault injection for tests/drills
  (the checkpoint-restart path is exercised in CI, not discovered in prod);
* ``StragglerWatchdog`` — EWMA step-time monitor that flags outlier steps
  (on real deployments this triggers hot-spare swap / checkpoint-evict;
  with relaxed-waste DVFS plans, the τ budget is the same slack Perseus
  exploits — the watchdog exposes it to the planner).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


class InjectedFailure(RuntimeError):
    """Simulated node failure."""


class FailureInjector:
    """Raises InjectedFailure at the configured steps (once each)."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(int(s) for s in fail_at_steps)
        self.fired = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclass
class StragglerEvent:
    step: int
    step_time_s: float
    ewma_s: float
    ratio: float


class StragglerWatchdog:
    """EWMA-based step-time outlier detection."""

    def __init__(self, alpha: float = 0.2, threshold: float = 1.5,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, step_time_s: float) -> Optional[StragglerEvent]:
        self.n += 1
        if self.ewma is None:
            self.ewma = step_time_s
            return None
        event = None
        if self.n > self.warmup and \
                step_time_s > self.threshold * self.ewma:
            event = StragglerEvent(step=step, step_time_s=step_time_s,
                                   ewma_s=self.ewma,
                                   ratio=step_time_s / self.ewma)
            self.events.append(event)
            # do not pollute the EWMA with the outlier
            return event
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time_s
        return event
