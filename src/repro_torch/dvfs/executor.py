"""Governor-driven DVFS execution: replay + accounting for any plan.

``GovernorExecutor`` closes the plan → runtime loop for whatever plan a
:class:`~repro.dvfs.governors.Governor` currently holds: it replays each
executed segment's clock schedule through a registered
:class:`~repro.runtime.energy.FrequencyController` backend, integrates
energy with one :class:`~repro.runtime.energy.EnergyMeter` per segment
(plus an auto-clock twin, so savings are measured against the governor
baseline the paper compares to), and feeds every execution back to the
governor's ``observe`` hook — which is how :class:`OnlineGovernor`
detects drift.  When the governor re-plans (its ``revision`` bumps), the
executor *flushes* the affected segment's books into a carry accumulator
and re-meters against the new schedule, so accounting survives online
re-planning without losing pre-drift records.

* :class:`ServeGovernorExecutor` — serving hooks (``on_prefill`` /
  ``on_decode(n_active)``), the engine-facing adapter.
* :class:`TrainGovernorExecutor` — training hook (``on_step``), replays
  ``fwd`` → ``bwd`` → ``opt`` back-to-back, and round-trips its books
  through ``state_dict()`` / ``load_state_dict()`` for checkpoint-restart.

The legacy :class:`~repro.runtime.dvfs_exec.PhaseExecutor` /
``TrainPhaseExecutor`` are thin deprecation shims over these two.

The port's copy of the JAX package's ``dvfs/executor.py``.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

from ..core.coalesce import SWITCH_POWER_W
from ..core.freq import ClockPair
from ..core.objectives import pct
from ..core.power_model import Chip
from ..obs import NULL_TRACER, MetricsRegistry, segment_breakdown
from ..runtime.energy import (EnergyMeter, FrequencyController,
                              SimulatedController, StepEnergy)
from .governors import BaseGovernor, StaticPlanGovernor
from .plan_ir import DvfsPlan, PlanSegment

TRAIN_SCOPE_ORDER = ("train-fwd", "train-bwd", "train-opt")


class GovernorExecutor:
    """Replay + accounting machinery over a governor's current plan."""

    def __init__(self, governor: BaseGovernor, chip: Chip,
                 controller: Optional[object] = None,
                 measure_fn: Optional[
                     Callable[[str], Tuple[float, float]]] = None,
                 tracer: Optional[object] = None):
        plan = governor.plan
        if plan is None:
            raise ValueError("governor has no plan to execute; plan first "
                             "(DvfsSession.plan_* or governor.adopt)")
        if plan.chip_name != chip.name:
            raise ValueError(f"bundle planned for {plan.chip_name!r}, "
                             f"executing on {chip.name!r}")
        self.governor = governor
        self.chip = chip
        if controller is None:
            controller = SimulatedController(chip)
        elif isinstance(controller, str):
            # local import: repro.runtime <-> repro.dvfs are mutually
            # importable; the registry is only needed for by-name resolution
            from .controllers import controller as make_controller
            controller = make_controller(controller, chip)
        self.controller: FrequencyController = controller
        self.measure_fn = measure_fn
        # tracing: modeled-time spans/instants on one track; the owner
        # (replica, session) may retarget track/clock after construction
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_track = "dvfs"
        #: modeled-clock source for span starts; when None the executor
        #: accumulates its own busy-time axis in ``_trace_t``
        self.clock_fn: Optional[Callable[[], float]] = None
        self._trace_t = 0.0
        # accounting: one (meter, baseline twin) per segment name, plus a
        # carry accumulator that survives governor re-plans
        self.meters: Dict[str, EnergyMeter] = {}
        self.baseline: Dict[str, EnergyMeter] = {}
        self.switches: Dict[str, int] = {}
        self._steps: Dict[str, int] = {}
        self._revision: Dict[str, int] = {}
        self._carry: Dict[str, Dict[str, float]] = {}
        for seg in plan.segments:
            self._mount(seg)

    # -- segment metering -------------------------------------------------
    def _mount(self, seg: PlanSegment) -> None:
        self.meters[seg.name] = EnergyMeter(self.chip, seg.kernels,
                                            seg.schedule)
        self.baseline[seg.name] = EnergyMeter(self.chip, seg.kernels, None)
        self.switches.setdefault(seg.name, 0)
        self._steps.setdefault(seg.name, 0)
        self._revision[seg.name] = self.governor.revision
        self._carry.setdefault(seg.name, {
            "steps": 0, "time_s": 0.0, "energy_j": 0.0,
            "base_time_s": 0.0, "base_energy_j": 0.0,
            "internal_switches": 0})
        if self.tracer.enabled:
            self.tracer.note_segment(self.trace_track, seg.name,
                                     self.governor.revision,
                                     segment_breakdown(self.chip, seg))

    def _flush(self, name: str) -> None:
        """Fold the current meter's books into the carry accumulator (a
        re-planned segment gets fresh meters without losing history)."""
        m = self.meters[name].totals()
        b = self.baseline[name].totals()
        sched = self.meters[name].schedule
        c = self._carry[name]
        c["steps"] += int(m["steps"])
        c["time_s"] += m["time_s"]
        c["energy_j"] += m["energy_j"]
        c["base_time_s"] += b["time_s"]
        c["base_energy_j"] += b["energy_j"]
        c["internal_switches"] += (sched.n_switches if sched is not None
                                   else 0) * int(m["steps"])
        self.meters[name].records.clear()
        self.baseline[name].records.clear()

    def _trace_now(self) -> float:
        """Current modeled time for trace emission: the owner's clock
        when wired (replica tier), else the accumulated busy axis."""
        return self.clock_fn() if self.clock_fn is not None \
            else self._trace_t

    def note_segments(self) -> None:
        """(Re-)stash every mounted segment's planned-vs-auto breakdown
        under the *current* trace track — called by owners that retarget
        ``trace_track`` after construction (replicas)."""
        if not self.tracer.enabled:
            return
        for name in self.meters:
            seg = self.governor.segment(name)
            self.tracer.note_segment(self.trace_track, name,
                                     self._revision.get(name, 1),
                                     segment_breakdown(self.chip, seg))

    def _segment(self, name: str) -> PlanSegment:
        seg = self.governor.segment(name)
        if self._revision.get(name) != self.governor.revision:
            # governor re-planned since we last metered this segment
            if name in self.meters:
                self._flush(name)
            if self.tracer.enabled:
                self.tracer.instant(
                    self.trace_track, "replan", self._trace_now(),
                    cat="replan",
                    args={"segment": name,
                          "revision": self.governor.revision})
            self._mount(seg)
        return seg

    # -- execution --------------------------------------------------------
    def execute(self, name: str, frac: float = 1.0) -> StepEnergy:
        """Replay one segment's clock schedule and meter it.

        ``frac`` scales the charged work: a prefix-cache hit prefills
        only the uncached suffix, so the books (measured *and* baseline
        twin — savings percentages stay comparable) bill ``frac`` of the
        planned segment while the clock schedule replays in full.  The
        governor still observes the planned per-execution cost — a
        smaller workload is a mix effect, not clock drift.
        """
        seg = self._segment(name)
        sw0 = getattr(self.controller, "n_switches", 0)
        advance = getattr(self.controller, "advance", None)
        for entry in seg.schedule.entries:
            self.controller.set_clocks(ClockPair(entry.mem, entry.core))
            if advance is not None:
                advance(entry.expected_time_s * frac)
        dsw = getattr(self.controller, "n_switches", sw0) - sw0
        self.switches[name] += dsw
        step = self._steps[name]
        rec = self.meters[name].on_step(step)
        self.baseline[name].on_step(step)
        self._steps[name] = step + 1
        if self.measure_fn is not None:
            mt, me = self.measure_fn(name)
            self.governor.observe(name, mt, me)
        else:
            self.governor.observe(name, rec.time_s, rec.energy_j)
        if frac != 1.0:
            for m in (self.meters[name], self.baseline[name]):
                r = m.records[-1]
                m.records[-1] = StepEnergy(
                    step=r.step, time_s=r.time_s * frac,
                    energy_j=r.energy_j * frac, n_switches=r.n_switches)
            rec = self.meters[name].records[-1]
        tr = self.tracer
        if tr.enabled:
            t0 = self._trace_now()
            args = {"scope": seg.scope, "energy_j": rec.energy_j,
                    "planned_time_s": seg.time_s,
                    "planned_energy_j": seg.energy_j,
                    "rev": self._revision.get(name, 1)}
            if frac != 1.0:
                args["frac"] = frac
            tr.span(self.trace_track, name, t0, rec.time_s, cat="phase",
                    args=args)
            if dsw:
                tr.instant(self.trace_track, "freq-switch", t0,
                           cat="freq", args={"n": dsw})
            self._trace_t = t0 + rec.time_s
        return rec

    # -- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """Clear accumulated accounting (per-segment records, switch
        counts) AND the governor's feedback windows, so a warm-up
        workload pollutes neither the measured books nor drift
        detection."""
        self.governor.reset_feedback()
        for name in list(self.meters):
            self.meters[name].records.clear()
            self.baseline[name].records.clear()
            self.switches[name] = 0
            self._steps[name] = 0
            c = self._carry[name]
            for k in c:
                c[k] = 0 if isinstance(c[k], int) else 0.0
        self.controller.reset()

    def finish(self) -> None:
        """Return the chip to the governor (auto) clocks."""
        self.controller.reset()

    # -- reporting --------------------------------------------------------
    def summary(self) -> Dict:
        """Per-segment and total executed time/energy vs the auto
        baseline, with per-segment switch counts."""
        phases = {}
        tot = {"steps": 0, "time_s": 0.0, "energy_j": 0.0,
               "base_time_s": 0.0, "base_energy_j": 0.0, "n_switches": 0}
        for name in self.meters:
            m = self.meters[name].totals()
            b = self.baseline[name].totals()
            c = self._carry[name]
            row = {"steps": int(m["steps"]) + int(c["steps"]),
                   "time_s": m["time_s"] + c["time_s"],
                   "energy_j": m["energy_j"] + c["energy_j"],
                   "base_time_s": b["time_s"] + c["base_time_s"],
                   "base_energy_j": b["energy_j"] + c["base_energy_j"],
                   "n_switches": self.switches[name]}
            # the meter charges the schedule's *internal* switches; phase-
            # boundary transitions (observed at the controller) are extra
            sched = self.meters[name].schedule
            internal = (sched.n_switches if sched is not None else 0) \
                * int(m["steps"]) + int(c["internal_switches"])
            extra = max(row["n_switches"] - internal, 0)
            row["time_s"] += extra * self.chip.switch_latency_s
            row["energy_j"] += extra * self.chip.switch_latency_s \
                * SWITCH_POWER_W
            if row["base_energy_j"] > 0:
                row["time_pct"] = pct(row["time_s"], row["base_time_s"])
                row["energy_pct"] = pct(row["energy_j"],
                                        row["base_energy_j"])
            phases[name] = row
            tot["steps"] += row["steps"]
            tot["time_s"] += row["time_s"]
            tot["energy_j"] += row["energy_j"]
            tot["base_time_s"] += row["base_time_s"]
            tot["base_energy_j"] += row["base_energy_j"]
            tot["n_switches"] += row["n_switches"]
        if tot["base_energy_j"] > 0:
            tot["time_pct"] = pct(tot["time_s"], tot["base_time_s"])
            tot["energy_pct"] = pct(tot["energy_j"], tot["base_energy_j"])
        out = {"chip": self.chip.name, "phases": phases, "totals": tot}
        if getattr(self.controller, "n_throttled", 0):
            out["n_throttled"] = self.controller.n_throttled
        if getattr(self.controller, "n_failed", 0):
            out["n_failed"] = self.controller.n_failed
        if getattr(self.controller, "n_giveups", 0):
            out["n_giveups"] = self.controller.n_giveups
        if getattr(self.controller, "controller_events", None):
            # deep copies: the payloads are live controller/governor
            # state — callers mutating a summary must not reach back
            # into the event books
            out["controller_events"] = \
                copy.deepcopy(list(self.controller.controller_events))
        if self.governor.revision > 1:
            out["governor_revision"] = self.governor.revision
            out["governor_events"] = \
                copy.deepcopy(list(self.governor.events))
        return out

    def ledger_rows(self) -> Dict[str, Dict[str, float]]:
        """Kernel-tier ledger: each segment's charge split into its three
        sources — the live meter, the carry flushed by re-plans, and the
        phase-boundary switch surcharge.  The split uses exactly the
        :meth:`summary` arithmetic, so
        ``metered + carry + boundary == summary()`` is the conservation
        invariant :func:`repro.obs.check_executor` asserts."""
        rows: Dict[str, Dict[str, float]] = {}
        for name in self.meters:
            m = self.meters[name].totals()
            c = self._carry[name]
            sched = self.meters[name].schedule
            internal = (sched.n_switches if sched is not None else 0) \
                * int(m["steps"]) + int(c["internal_switches"])
            extra = max(self.switches[name] - internal, 0)
            rows[name] = {
                "steps": int(m["steps"]) + int(c["steps"]),
                "metered_time_s": m["time_s"],
                "metered_j": m["energy_j"],
                "carry_time_s": c["time_s"],
                "carry_j": c["energy_j"],
                "boundary_switch_s": extra * self.chip.switch_latency_s,
                "boundary_switch_j": (extra * self.chip.switch_latency_s
                                      * SWITCH_POWER_W),
            }
        return rows

    def metrics(self, registry: Optional[MetricsRegistry] = None
                ) -> MetricsRegistry:
        """Adapter: the executed books as typed registry instruments
        (``summary()`` itself stays the wire format)."""
        reg = registry if registry is not None else MetricsRegistry()
        summ = self.summary()
        for name, row in summ["phases"].items():
            reg.counter("segment_steps", segment=name).inc(row["steps"])
            reg.counter("segment_time_s",
                        segment=name).inc(row["time_s"])
            reg.counter("segment_energy_j",
                        segment=name).inc(row["energy_j"])
            reg.counter("segment_switches",
                        segment=name).inc(row["n_switches"])
        reg.gauge("governor_revision").set(self.governor.revision)
        return reg


class ServeGovernorExecutor(GovernorExecutor):
    """Serving adapter: the engine calls the phase-transition hooks."""

    @classmethod
    def from_bundle(cls, bundle, chip: Chip, controller=None, **kw
                    ) -> "ServeGovernorExecutor":
        gov = StaticPlanGovernor(DvfsPlan.from_phase_bundle(bundle))
        return cls(gov, chip, controller, **kw)

    # -- phase hooks ------------------------------------------------------
    def on_prefill(self, frac: float = 1.0) -> StepEnergy:
        # by scope, not by name — prefill segments may be named freely.
        # ``frac`` bills a prefix-cache hit's suffix-only prefill.
        return self.execute(self.governor.plan.prefill_segment().name,
                            frac=frac)

    def on_decode(self, n_active: int) -> StepEnergy:
        # by scope+bucket, not by a "decode@<b>" name convention
        seg = self.governor.plan.decode_segment(max(n_active, 1))
        return self.execute(seg.name)


class TrainGovernorExecutor(GovernorExecutor):
    """Training adapter: replays fwd -> bwd -> opt around every step."""

    def __init__(self, governor: BaseGovernor, chip: Chip,
                 controller=None, **kw):
        super().__init__(governor, chip, controller, **kw)
        self.last_step: Optional[int] = None

    @classmethod
    def from_bundle(cls, bundle, chip: Chip, controller=None, **kw
                    ) -> "TrainGovernorExecutor":
        gov = StaticPlanGovernor(DvfsPlan.from_train_bundle(bundle))
        return cls(gov, chip, controller, **kw)

    def _phase_names(self):
        plan = self.governor.plan
        by_scope = {s.scope: s.name for s in plan.segments}
        return [by_scope[sc] for sc in TRAIN_SCOPE_ORDER if sc in by_scope]

    # -- step hook --------------------------------------------------------
    def on_step(self, step: int) -> StepEnergy:
        """Execute one train step's fwd -> bwd -> opt segment schedules.

        Returns the step's combined simulated time/energy (switch overhead
        internal to each segment schedule included; segment-boundary
        switches are accounted in :meth:`summary`)."""
        t = e = 0.0
        n_sw = 0
        for name in self._phase_names():
            rec = self.execute(name)
            t += rec.time_s
            e += rec.energy_j
            n_sw += rec.n_switches
        self.last_step = step
        return StepEnergy(step=step, time_s=t, energy_j=e, n_switches=n_sw)

    # -- checkpoint-resume ------------------------------------------------
    def state_dict(self) -> Dict:
        """Accounting state for checkpointing.  Records metered against
        the *current* plan revision are analytic per-step constants, so
        counts reconstruct them; books flushed into the carry by earlier
        re-plans are checkpointed verbatim (their schedules may be gone)."""
        return {"steps": dict(self._steps),
                "switches": dict(self.switches),
                "carry": {k: dict(v) for k, v in self._carry.items()},
                "last_step": self.last_step}

    def load_state_dict(self, state: Dict) -> None:
        """Resume accounting mid-plan after a checkpoint restart."""
        self.reset()
        carry = state.get("carry", {})
        for name, c in carry.items():
            if name in self._carry:
                self._carry[name].update(c)
        for name, n in state.get("steps", {}).items():
            if name not in self.meters:
                continue
            # only the steps metered against the current schedule are
            # replayed; pre-re-plan steps are already in the carry
            live = int(n) - int(carry.get(name, {}).get("steps", 0))
            for i in range(max(live, 0)):
                self.meters[name].on_step(i)
                self.baseline[name].on_step(i)
            self._steps[name] = int(n)
        for name, n in state.get("switches", {}).items():
            if name in self.switches:
                self.switches[name] = int(n)
        self.last_step = state.get("last_step")
