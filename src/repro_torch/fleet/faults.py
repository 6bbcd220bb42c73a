"""Seeded, trace-replayable fault injection for fleet serving.

A :class:`FaultSchedule` is the chaos twin of
:class:`~repro_torch.fleet.traces.Trace`: a sorted list of
:class:`FaultEvent` that the :class:`~repro_torch.fleet.cluster.Fleet` event
loop replays *identically* across runs — registered generators by name,
seeded via ``numpy`` RNG, bit-identical JSON round-trip — so every
recovery comparison (fault-free vs storm-with-recovery vs
storm-without) replays the exact same failure sequence.

Fault kinds:

* ``crash`` — the replica dies at ``t``: in-flight and queued requests
  are orphaned, its pages freed, its clock frozen (a dead chip draws
  0 W).  The fleet detects the death after its heartbeat timeout and
  re-dispatches the orphans (see ``Fleet._recover``).
* ``thermal-cap`` — for ``dwell_s`` the replica's frequency vocabulary
  is clamped to ``max_core_frac`` of the top core clock
  (:func:`clamp_table`) and its plans are re-planned *within* the
  clamped grid — budget repair, like
  :func:`~repro_torch.parallel.plan_transfer.transfer_serve_plan` repairs a
  plan onto a different chip's grid.
* ``link-drop`` / ``link-degrade`` — for ``dwell_s`` the migration link
  drops every ``PageBlockTransfer`` (the fleet retries with capped
  exponential backoff, then falls back to a prefill re-run on the
  decode side) or stretches its time/energy by ``params["factor"]``.
* ``driver-fail`` — the replica's DVFS driver rejects set-frequency
  calls for ``dwell_s`` of *controller* (busy) time; a
  :class:`~repro_torch.dvfs.controllers.RateLimitedController` retries with
  capped backoff and keeps accounting on the last-*applied* frequency.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.freq import AUTO
from ..core.measure import MeasurementTable
from ..core.objectives import WastePolicy
from ..core.phase_plan import compile_phase
from ..dvfs.governors import OnlineGovernor
from ..dvfs.plan_ir import PlanSegment

#: every fault kind a schedule may carry
FAULT_KINDS = ("crash", "thermal-cap", "link-drop", "link-degrade",
               "driver-fail")
#: kinds that are windows over the shared migration link (no replica)
LINK_KINDS = ("link-drop", "link-degrade")

FAULTS: Dict[str, Callable] = {}


def register_faults(name: str):
    """Decorator: make a fault-schedule generator constructible by name."""
    def deco(fn):
        FAULTS[name] = fn
        return fn
    return deco


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault: what breaks, when, for how long."""

    kind: str
    t: float
    replica: Optional[str] = None    # None for link-wide faults
    dwell_s: float = 0.0             # window length (0 = instantaneous)
    params: Dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.kind not in LINK_KINDS and self.replica is None:
            raise ValueError(f"{self.kind!r} fault needs a target replica")

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "t": self.t, "replica": self.replica,
                "dwell_s": self.dwell_s, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultEvent":
        return cls(kind=str(d["kind"]), t=float(d["t"]),
                   replica=d.get("replica"),
                   dwell_s=float(d.get("dwell_s", 0.0)),
                   params=dict(d.get("params", {})))


@dataclass
class FaultSchedule:
    """A replayable fault sequence plus the recipe that generated it."""

    events: List[FaultEvent]
    meta: Dict = field(default_factory=dict)

    def __post_init__(self):
        ts = [e.t for e in self.events]
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError("fault events must be sorted by time")

    def __len__(self) -> int:
        return len(self.events)

    def summary(self) -> Dict:
        by_kind: Dict[str, int] = {}
        for e in self.events:
            by_kind[e.kind] = by_kind.get(e.kind, 0) + 1
        return {"n_events": len(self.events), "by_kind": by_kind,
                "meta": dict(self.meta)}

    # -- JSON round-trip (bit-identical replay) ---------------------------
    def to_dict(self) -> Dict:
        return {"meta": self.meta,
                "events": [e.to_dict() for e in self.events]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultSchedule":
        return cls(events=[FaultEvent.from_dict(e) for e in d["events"]],
                   meta=d.get("meta", {}))

    @classmethod
    def from_json(cls, s: str) -> "FaultSchedule":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            return cls.from_json(f.read())


def generate_faults(name: str = "storm", *, seed: int = 0,
                    **kwargs) -> FaultSchedule:
    """Build a seeded fault schedule from a registered generator."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault generator {name!r}; "
                         f"registered: {sorted(FAULTS)}")
    rng = np.random.default_rng(seed)
    sched = FAULTS[name](rng, **kwargs)
    meta = {"name": name, "seed": seed}
    for k, v in kwargs.items():
        meta[k] = list(v) if isinstance(v, (tuple, set)) else v
    sched.meta = {**meta, **sched.meta}
    return sched


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

@register_faults("storm")
def storm_faults(rng: np.random.Generator, replicas: Sequence[str],
                 duration_s: float = 1.5,
                 max_core_frac: float = 0.6) -> FaultSchedule:
    """The claim-14 fault storm: two crashes (first and last replica),
    a thermal cap and a driver fault on the middle ones, and a degraded
    then dropped migration link — all at fixed fractions of
    ``duration_s`` (deterministic given the replica list; the rng only
    matters for generators that sample)."""
    reps = list(replicas)
    if len(reps) < 3:
        raise ValueError(f"the storm needs >= 3 replicas so survivors "
                         f"remain, got {reps}")
    events = [
        FaultEvent("thermal-cap", 0.15 * duration_s, replica=reps[1],
                   dwell_s=0.5 * duration_s,
                   params={"max_core_frac": float(max_core_frac)}),
        FaultEvent("link-degrade", 0.2 * duration_s,
                   dwell_s=0.15 * duration_s, params={"factor": 3.0}),
        FaultEvent("crash", 0.3 * duration_s, replica=reps[0]),
        FaultEvent("link-drop", 0.45 * duration_s,
                   dwell_s=0.1 * duration_s),
        FaultEvent("driver-fail", 0.5 * duration_s, replica=reps[2],
                   dwell_s=0.2 * duration_s),
        FaultEvent("crash", 0.7 * duration_s, replica=reps[-1]),
    ]
    events.sort(key=lambda e: (e.t, e.kind, e.replica or ""))
    return FaultSchedule(events=events)


@register_faults("random")
def random_faults(rng: np.random.Generator, replicas: Sequence[str],
                  duration_s: float = 1.0,
                  protect: Sequence[str] = (),
                  max_crashes: int = 2,
                  p_thermal: float = 0.7, p_link: float = 0.7,
                  p_driver: float = 0.5) -> FaultSchedule:
    """Randomized schedules for property tests: up to ``max_crashes``
    crashes (never on a ``protect``-ed replica, so every pool keeps a
    survivor), plus coin-flip thermal/link/driver events."""
    reps = list(replicas)
    victims = [n for n in reps if n not in set(protect)]
    events: List[FaultEvent] = []
    n_crash = int(rng.integers(0, min(max_crashes, len(victims)) + 1))
    if n_crash:
        for name in rng.choice(victims, size=n_crash, replace=False):
            events.append(FaultEvent(
                "crash", float(rng.uniform(0.1, 0.9) * duration_s),
                replica=str(name)))
    if rng.uniform() < p_thermal:
        events.append(FaultEvent(
            "thermal-cap", float(rng.uniform(0.05, 0.5) * duration_s),
            replica=str(rng.choice(reps)),
            dwell_s=float(rng.uniform(0.2, 0.6) * duration_s),
            params={"max_core_frac": float(rng.uniform(0.5, 0.85))}))
    if rng.uniform() < p_link:
        drop = bool(rng.uniform() < 0.5)
        events.append(FaultEvent(
            "link-drop" if drop else "link-degrade",
            float(rng.uniform(0.05, 0.7) * duration_s),
            dwell_s=float(rng.uniform(0.05, 0.3) * duration_s),
            params={} if drop
            else {"factor": float(rng.uniform(2.0, 6.0))}))
    if rng.uniform() < p_driver:
        events.append(FaultEvent(
            "driver-fail", float(rng.uniform(0.05, 0.8) * duration_s),
            replica=str(rng.choice(reps)),
            dwell_s=float(rng.uniform(0.1, 0.4) * duration_s)))
    events.sort(key=lambda e: (e.t, e.kind, e.replica or ""))
    return FaultSchedule(events=events)


# ---------------------------------------------------------------------------
# Runtime injector
# ---------------------------------------------------------------------------

class FaultInjector:
    """Drives a schedule through the fleet loop: expands dwell faults
    into apply/lift timeline actions, answers "what does the migration
    link look like at t", and hands due actions to the fleet."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        timeline = []
        #: (kind, t0, t1, params) migration-link windows
        self.windows: List[tuple] = []
        for ev in schedule.events:
            if ev.kind in LINK_KINDS:
                self.windows.append((ev.kind, ev.t, ev.t + ev.dwell_s,
                                     dict(ev.params)))
            elif ev.kind == "thermal-cap":
                timeline.append((ev.t, "thermal-cap", ev))
                timeline.append((ev.t + ev.dwell_s, "thermal-lift", ev))
            else:
                timeline.append((ev.t, ev.kind, ev))
        timeline.sort(key=lambda x: (x[0], x[1], x[2].replica or ""))
        self._timeline = timeline
        self._i = 0

    def next_s(self) -> float:
        """Time of the next pending timeline action (inf when drained)."""
        if self._i < len(self._timeline):
            return self._timeline[self._i][0]
        return float("inf")

    def pop_due(self, now: float, eps: float = 1e-12) -> List[tuple]:
        """Consume every (action, event) due at or before ``now``."""
        out = []
        while self._i < len(self._timeline) \
                and self._timeline[self._i][0] <= now + eps:
            t, action, ev = self._timeline[self._i]
            self._i += 1
            out.append((action, ev))
        return out

    def link_state(self, t: float) -> tuple:
        """Migration-link condition at ``t``: ``("drop", 0.0)``,
        ``("degrade", factor)``, or ``("ok", 1.0)``.  A drop window
        beats any overlapping degradation."""
        factor = 1.0
        for kind, t0, t1, params in self.windows:
            if t0 - 1e-12 <= t < t1 - 1e-12:
                if kind == "link-drop":
                    return ("drop", 0.0)
                factor = max(factor, float(params.get("factor", 2.0)))
        return ("degrade", factor) if factor > 1.0 else ("ok", 1.0)


# ---------------------------------------------------------------------------
# Thermal clamping (DVFS graceful degradation)
# ---------------------------------------------------------------------------

def clamp_table(table: MeasurementTable,
                max_core_frac: float) -> MeasurementTable:
    """A thermally capped copy of a measurement table: only fully pinned
    pairs with core clock <= ``max_core_frac`` of the top core survive
    (at least the deepest core state always does), and the AUTO column
    is rewritten to the fastest *surviving* pinned pair — under a
    thermal cap the vendor governor runs at the cap, so the planner's
    slowdown budget anchors on the capped reality (budget repair), not
    on a top clock the silicon can no longer reach."""
    pinned = sorted({p.core for p in table.pairs
                     if p.core != AUTO and p.mem != AUTO})
    if not pinned:
        raise ValueError("table has no fully pinned clock pairs to clamp")
    cap_core = max([c for c in pinned
                    if c <= float(max_core_frac) * pinned[-1] + 1e-9]
                   or pinned[:1])
    keep = [i for i, p in enumerate(table.pairs)
            if (p.mem != AUTO and p.core != AUTO
                and p.core <= cap_core + 1e-9) or i == table.auto_idx]
    sub = table.subset_pairs(keep)
    fastest = max((j for j, p in enumerate(sub.pairs) if p.core != AUTO),
                  key=lambda j: (sub.pairs[j].core, sub.pairs[j].mem))
    sub.time[:, sub.auto_idx] = sub.time[:, fastest]
    sub.energy[:, sub.auto_idx] = sub.energy[:, fastest]
    return sub


def _replan_clamped(replica, reasons: List[str]) -> None:
    """Re-plan the replica inside its (newly clamped or restored) grid:
    decode segments through the OnlineGovernor re-plan path when it has
    decode tables, otherwise a manual revision bump (so executors
    remount their meters either way), plus a prefill re-compile."""
    gov = replica.governor
    if isinstance(gov, OnlineGovernor) and gov.can_replan():
        mix = gov.observed_mix() or gov._ref_mix \
            or {b: 1.0 for b in replica.plan.decode_buckets}
        gov.replan(mix, reasons=reasons, refresh=False)
    else:
        gov.revision += 1
        gov.events.append({"revision": gov.revision,
                           "reason": list(reasons)})
    if replica.prefill_table is not None:
        seg = replica.plan.prefill_segment()
        pp = compile_phase(replica.prefill_table, seg.name, replica.chip,
                           WastePolicy(gov.policy.tau))
        replica.plan.replace_segment(PlanSegment.from_phase_plan(
            pp, scope="serve-prefill"))


def apply_thermal_cap(replica, max_core_frac: float) -> None:
    """Clamp the replica's frequency vocabulary (governor decode tables
    + prefill table) to ``max_core_frac`` and force a re-plan within the
    clamped grid.  Originals are saved for :func:`lift_thermal_cap`;
    tables shared with sibling replicas are untouched (each governor
    holds its own dict, and clamping builds new tables)."""
    if getattr(replica, "thermal_cap", None) is not None:
        raise RuntimeError(f"replica {replica.name!r} is already "
                           f"thermally capped")
    gov = replica.governor
    saved = {"tables": dict(getattr(gov, "tables", None) or {}),
             "prefill": replica.prefill_table}
    if saved["tables"]:
        gov.tables = {b: clamp_table(t, max_core_frac)
                      for b, t in saved["tables"].items()}
    if replica.prefill_table is not None:
        replica.prefill_table = clamp_table(replica.prefill_table,
                                            max_core_frac)
    replica.thermal_cap = float(max_core_frac)
    replica._thermal_saved = saved
    _replan_clamped(replica,
                    [f"thermal-cap:frac={float(max_core_frac):.2f}"])
    replica._event({"t": replica.clock, "event": "thermal-cap",
                    "max_core_frac": float(max_core_frac)}, cat="fault")


def lift_thermal_cap(replica) -> None:
    """Restore the pre-cap tables and re-plan on the full grid."""
    saved = getattr(replica, "_thermal_saved", None)
    if saved is None:
        raise RuntimeError(f"replica {replica.name!r} has no thermal "
                           f"cap to lift")
    gov = replica.governor
    if saved["tables"]:
        gov.tables = saved["tables"]
    replica.prefill_table = saved["prefill"]
    replica.thermal_cap = None
    replica._thermal_saved = None
    _replan_clamped(replica, ["thermal-lift"])
    replica._event({"t": replica.clock, "event": "thermal-lift"},
                   cat="fault")
