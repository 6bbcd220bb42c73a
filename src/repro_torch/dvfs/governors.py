"""Pluggable DVFS governors: one protocol, a string registry, and an
online re-planning governor.

A *governor* owns a :class:`~repro.dvfs.plan_ir.DvfsPlan` and decides how
each segment is planned and what happens when runtime feedback arrives.
The registry makes policies swappable by name::

    gov = governor("kernel-static")           # today's offline replay
    gov = governor("pass-level")              # the paper's §5 baseline
    gov = governor("edp", level="global")     # prior-work objective
    gov = governor("online", tables=..., mix_threshold=0.2)

* :class:`StaticPlanGovernor` — replays a fixed plan; plans segments with
  the switch-aware coalesced kernel-level planner (the repo's default).
* :class:`PassLevelGovernor` — one clock pair per pass (coarse baseline).
* :class:`EDPGovernor` — the t·e objective the paper argues against.
* :class:`OnlineGovernor` — the DSO-style fusion of a static plan with
  online feedback: it watches the decode-bucket mix and measured-vs-
  planned time/energy, and when either drifts beyond a threshold it
  re-plans the decode segments *jointly* over the observed mix (shared
  time budget across buckets — see :func:`plan_decode_joint`) via the
  vectorized coalesce planner, between phase executions: mix-drift
  re-plans reuse cached tables (pure ms-scale planning); only perf
  drift re-measures.  Tang et al. (2019)
  observe optimal clocks drift with workload; this is the control loop
  that tracks the drift.

The port's copy of the JAX package's ``dvfs/governors.py``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np

from ..core.measure import MeasurementTable
from ..core.objectives import WastePolicy
from ..core.phase_plan import compile_phase
from ..core.planner import (Plan, edp_global_plan, edp_local_plan,
                            edp_pass_plan, global_plan, local_plan,
                            pass_level_plan)
from ..core.power_model import Chip
from .plan_ir import DvfsPlan, PlanSegment


class Governor(Protocol):
    """The contract the executors and :class:`DvfsSession` drive."""

    revision: int

    @property
    def plan(self) -> Optional[DvfsPlan]: ...
    def adopt(self, plan: DvfsPlan, reason: str = "adopt") -> None: ...
    def segment(self, name: str) -> PlanSegment: ...
    def solve(self, table: MeasurementTable,
              policy: Optional[WastePolicy] = None) -> Plan: ...
    def observe(self, name: str, time_s: float, energy_j: float) -> None:
        ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

GOVERNORS: Dict[str, type] = {}


def register_governor(name: str):
    """Class decorator: make a governor constructible by name."""
    def deco(cls):
        GOVERNORS[name] = cls
        cls.name = name
        return cls
    return deco


def governor(name: str, **kwargs) -> "BaseGovernor":
    """Instantiate a registered governor by name (the facade entry)."""
    if name not in GOVERNORS:
        raise ValueError(f"unknown governor {name!r}; registered: "
                         f"{sorted(GOVERNORS)}")
    return GOVERNORS[name](**kwargs)


# ---------------------------------------------------------------------------
# Governors
# ---------------------------------------------------------------------------

class BaseGovernor:
    """Shared plan ownership + the default (no-feedback) control loop."""

    name = "?"
    #: planner handed to plan_phase_bundle/plan_train_bundle; None means
    #: the switch-aware coalesced default.
    phase_planner: Optional[Callable[..., Plan]] = None

    def __init__(self, plan: Optional[DvfsPlan] = None, *,
                 policy: Optional[WastePolicy] = None):
        self.policy = policy if policy is not None else WastePolicy()
        self._plan = plan
        self.revision = 1 if plan is not None else 0
        self.events: List[Dict] = []

    @property
    def plan(self) -> Optional[DvfsPlan]:
        return self._plan

    def adopt(self, plan: DvfsPlan, reason: str = "adopt") -> None:
        self._plan = plan
        self.revision += 1
        # reason is always a list, like every other event kind
        self.events.append({"revision": self.revision, "reason": [reason]})

    def segment(self, name: str) -> PlanSegment:
        if self._plan is None:
            raise RuntimeError(f"governor {self.name!r} has no plan; "
                               f"call adopt()/plan_table() first")
        return self._plan.segment(name)

    def observe(self, name: str, time_s: float, energy_j: float) -> None:
        """Runtime feedback hook; static governors ignore it."""

    def reset_feedback(self) -> None:
        """Discard accumulated runtime feedback (executor warm-up reset);
        static governors have none."""

    # -- planning strategy ----------------------------------------------
    def solve(self, table: MeasurementTable,
              policy: Optional[WastePolicy] = None) -> Plan:
        """Produce this governor's legacy per-kernel assignment for one
        measurement table (analysis workflows; no switch accounting)."""
        raise NotImplementedError

    def compile_segment(self, table: MeasurementTable, name: str,
                        chip: Chip, *, scope: str = "iteration",
                        bucket: Optional[int] = None) -> PlanSegment:
        """Compile one phase table into a deployable, switch-aware
        segment using this governor's planning strategy."""
        pp = compile_phase(table, name, chip, self.policy,
                           self.phase_planner)
        return PlanSegment.from_phase_plan(pp, scope=scope, bucket=bucket)

    def plan_table(self, table: MeasurementTable, *,
                   meta: Optional[Dict] = None) -> DvfsPlan:
        """Plan one whole iteration and adopt the result."""
        plan = DvfsPlan.from_kernel_plan(self.solve(table), meta=meta)
        self.adopt(plan, reason=f"plan_table:{self.name}")
        return plan


@register_governor("kernel-static")
class StaticPlanGovernor(BaseGovernor):
    """Today's replay path: a fixed kernel-level plan, no feedback."""

    def __init__(self, plan: Optional[DvfsPlan] = None, *,
                 policy: Optional[WastePolicy] = None,
                 aggregation: str = "global"):
        super().__init__(plan, policy=policy)
        if aggregation not in ("global", "local"):
            raise ValueError(f"aggregation must be global|local, got "
                             f"{aggregation!r}")
        self.aggregation = aggregation
        if aggregation == "local":
            # the global default (phase_planner=None) compiles phases with
            # the switch-aware coalesced planner; local aggregation must
            # honor the per-kernel budget in the phase path too
            self.phase_planner = lambda table, pol: local_plan(table, pol)

    def solve(self, table, policy=None):
        fn = global_plan if self.aggregation == "global" else local_plan
        return fn(table, policy if policy is not None else self.policy)


@register_governor("pass-level")
class PassLevelGovernor(BaseGovernor):
    """One clock pair per pass — the paper's §5 coarse baseline."""

    def __init__(self, plan: Optional[DvfsPlan] = None, *,
                 policy: Optional[WastePolicy] = None,
                 aggregation: str = "global"):
        super().__init__(plan, policy=policy)
        self.aggregation = aggregation
        self.phase_planner = lambda table, pol: pass_level_plan(
            table, pol, aggregation=self.aggregation)

    def solve(self, table, policy=None):
        return pass_level_plan(
            table, policy if policy is not None else self.policy,
            aggregation=self.aggregation)


@register_governor("edp")
class EDPGovernor(BaseGovernor):
    """min t·e (prior-work objective, Table 2) at pass|local|global."""

    LEVELS = {"pass": edp_pass_plan, "local": edp_local_plan,
              "global": edp_global_plan}

    def __init__(self, plan: Optional[DvfsPlan] = None, *,
                 policy: Optional[WastePolicy] = None,
                 level: str = "global"):
        super().__init__(plan, policy=policy)
        if level not in self.LEVELS:
            raise ValueError(f"level must be one of "
                             f"{sorted(self.LEVELS)}, got {level!r}")
        self.level = level
        self.phase_planner = lambda table, pol: self.LEVELS[level](table)

    def solve(self, table, policy=None):
        return self.LEVELS[self.level](table)


# ---------------------------------------------------------------------------
# Joint (mix-weighted) decode planning — the online governor's re-plan
# ---------------------------------------------------------------------------

def plan_decode_joint(tables: Dict[int, MeasurementTable],
                      mix: Dict[int, float], chip: Chip,
                      policy: Optional[WastePolicy] = None
                      ) -> List[PlanSegment]:
    """Plan all decode buckets under ONE shared time budget weighted by
    the (observed or assumed) bucket mix.

    Per-bucket planning gives every bucket its own ``(1+tau)*T_b``
    budget; with a traffic mix the right objective is the *aggregate*
    budget ``(1+tau) * sum_b f_b T_b`` — slack flows to the buckets where
    a marginal second buys the most energy.  Solved as one Lagrangian
    knapsack over the concatenated tables (bucket rows weighted by their
    mix share), then each bucket's allocated share is re-compiled with
    the switch-aware coalesced planner so the executed segment charges
    its own clock switches.  A mix shift moves the shared multiplier, so
    a plan frozen under the old mix strands slack — exactly the gap
    :class:`OnlineGovernor` closes by re-running this between phase
    executions (from cached tables: pure planning, no campaign).
    """
    policy = policy if policy is not None else WastePolicy()
    buckets = sorted(tables)
    tot = sum(max(float(mix.get(b, 0.0)), 0.0) for b in buckets)
    w = {b: (max(float(mix.get(b, 0.0)), 0.0) / tot if tot > 0
             else 1.0 / len(buckets)) for b in buckets}
    active = [b for b in buckets if w[b] > 0]

    # joint table: bucket kernels with invocations scaled by mix share
    ref = tables[buckets[0]]
    joint_kernels, rows_t, rows_e, slices = [], [], [], {}
    for b in active:
        t = tables[b]
        start = len(joint_kernels)
        joint_kernels.extend(
            dataclasses.replace(k, invocations=k.invocations * w[b])
            for k in t.kernels)
        rows_t.append(t.time)
        rows_e.append(t.energy)
        slices[b] = slice(start, len(joint_kernels))
    joint = MeasurementTable(
        chip_name=ref.chip_name, kernels=joint_kernels, pairs=ref.pairs,
        time=np.vstack(rows_t), energy=np.vstack(rows_e),
        auto_idx=ref.auto_idx)
    jp = global_plan(joint, policy)

    segments = []
    for b in buckets:
        t = tables[b]
        if b in slices:
            choice = jp.choice[slices[b]]
            idx = np.arange(len(t.kernels))
            t_b = float((t.weights * t.time[idx, choice]).sum())
            t_auto, _ = t.baseline_totals()
            tau_b = max(t_b / t_auto - 1.0, 0.0)
        else:
            tau_b = policy.tau          # unseen bucket: local budget
        pp = compile_phase(t, f"decode@{b}", chip, WastePolicy(tau_b))
        seg = PlanSegment.from_phase_plan(pp, scope="serve-decode",
                                          granularity="kernel", bucket=b)
        segments.append(seg)
    return segments


@register_governor("online")
class OnlineGovernor(BaseGovernor):
    """Static plan + online drift detection + incremental re-planning.

    The executor feeds every phase execution through :meth:`observe`.
    Two drift signals are watched over a sliding window:

    * **bucket-mix drift** — the empirical decode-bucket distribution vs
      the mix the current plan was optimized for (total-variation
      distance > ``mix_threshold``);
    * **perf drift** — measured vs planned time/energy per segment
      (mean relative deviation > ``perf_threshold``; in production these
      are hardware counters, in this container the executor's optional
      ``measure_fn``).

    On drift the governor re-plans the decode segments jointly over the
    observed mix (:func:`plan_decode_joint`) — between phase executions,
    never inside a kernel replay; mix drift re-plans from the cached
    ``tables`` (milliseconds of pure planning), while perf drift
    re-measures through ``table_provider`` (a fresh campaign on the
    drifted workload; in production, a background thread) — bumps its
    ``revision``, and logs the event.  Executors notice the revision and
    swap their meters; in-flight accounting is preserved.
    """

    def __init__(self, plan: Optional[DvfsPlan] = None, *,
                 policy: Optional[WastePolicy] = None,
                 chip: Optional[Chip] = None,
                 tables: Optional[Dict[int, MeasurementTable]] = None,
                 table_provider: Optional[
                     Callable[[int], MeasurementTable]] = None,
                 mix_threshold: float = 0.25,
                 perf_threshold: float = 0.02,
                 window: int = 64, min_perf_obs: int = 8):
        super().__init__(plan, policy=policy)
        self.chip = chip
        self.tables: Dict[int, MeasurementTable] = dict(tables or {})
        self.table_provider = table_provider
        self.mix_threshold = mix_threshold
        self.perf_threshold = perf_threshold
        self.window = window
        self.min_perf_obs = min_perf_obs
        self._recent: deque = deque(maxlen=window)
        self._perf: Dict[str, List[float]] = {}
        self._noted: set = set()
        self._cooldown = 0
        self._ref_mix: Optional[Dict[int, float]] = None
        if plan is not None:
            self._ref_mix = self._normalize_mix(
                plan.meta.get("decode_mix"))

    def adopt(self, plan: DvfsPlan, reason: str = "adopt") -> None:
        """Adopting a plan (re-)anchors drift detection on *that* plan:
        its recorded decode_mix becomes the reference, and the feedback
        windows restart."""
        super().adopt(plan, reason)
        self._ref_mix = self._normalize_mix(plan.meta.get("decode_mix"))
        self._recent.clear()
        self._perf.clear()
        self._noted.clear()
        self._cooldown = 0

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _normalize_mix(mix) -> Optional[Dict[int, float]]:
        if not mix:
            return None
        tot = sum(float(v) for v in mix.values())
        if tot <= 0:
            return None
        return {int(b): float(v) / tot for b, v in mix.items()}

    def observed_mix(self) -> Dict[int, float]:
        counts: Dict[int, int] = {}
        for b in self._recent:
            counts[b] = counts.get(b, 0) + 1
        n = sum(counts.values())
        return {b: c / n for b, c in counts.items()} if n else {}

    @staticmethod
    def _tv_distance(p: Dict[int, float], q: Dict[int, float]) -> float:
        keys = set(p) | set(q)
        return 0.5 * sum(abs(p.get(k, 0.0) - q.get(k, 0.0))
                         for k in keys)

    # -- feedback --------------------------------------------------------
    def observe(self, name: str, time_s: float, energy_j: float) -> None:
        if self._plan is None:
            return
        try:
            seg = self._plan.segment(name)
        except KeyError:
            return
        if seg.scope == "serve-decode" and seg.bucket is not None:
            self._recent.append(int(seg.bucket))
        if seg.time_s > 0 and seg.energy_j > 0 and time_s is not None:
            dev = max(abs(time_s / seg.time_s - 1.0),
                      abs(energy_j / seg.energy_j - 1.0))
            if seg.scope == "serve-decode":
                # only decode drift is actionable (replan() rebuilds
                # decode segments); accumulate toward a trigger
                self._perf.setdefault(name, []).append(dev)
                if len(self._perf[name]) > self.window:
                    self._perf[name] = self._perf[name][-self.window:]
            elif dev > self.perf_threshold and name not in self._noted:
                # drift replan() cannot fix: surface once, don't loop
                self._noted.add(name)
                self.events.append({"revision": self.revision,
                                    "reason": [f"perf-drift:{name}:"
                                               f"dev={dev:.3f}"],
                                    "replan": "no-target"})
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        self._maybe_replan()

    def _drift_reasons(self) -> List[str]:
        reasons = []
        if len(self._recent) >= self._recent.maxlen:
            mix = self.observed_mix()
            if self._ref_mix is not None and mix:
                tv = self._tv_distance(mix, self._ref_mix)
                if tv > self.mix_threshold:
                    reasons.append(f"mix-drift:tv={tv:.3f}")
            elif self._ref_mix is None and mix:
                # no planned mix recorded: first full window becomes the
                # reference against which future drift is judged
                self._ref_mix = mix
        for name, devs in self._perf.items():
            if len(devs) >= self.min_perf_obs:
                m = float(np.mean(devs[-self.min_perf_obs:]))
                if m > self.perf_threshold:
                    reasons.append(f"perf-drift:{name}:dev={m:.3f}")
        return reasons

    def can_replan(self) -> bool:
        """True when a re-plan is actionable: a chip, a serve plan with
        decode segments, and somewhere to get tables from."""
        return (self.chip is not None and self._plan is not None
                and bool(self._plan.decode_buckets)
                and (bool(self.tables) or self.table_provider is not None))

    def _maybe_replan(self) -> None:
        reasons = self._drift_reasons()
        if not reasons:
            return
        if not self.can_replan():
            # drift detected but nothing to re-plan with (e.g. a loaded
            # plan with no tables wired, or a train plan): record it once
            # per window instead of raising out of the serving hot path
            self.events.append({"revision": self.revision,
                                "reason": list(reasons),
                                "replan": "unavailable"})
            self._cooldown = self.window
            return
        self.replan(self.observed_mix() or self._ref_mix or {},
                    reasons=reasons)

    def reset_feedback(self) -> None:
        """Discard warm-up observations so a measured run's drift
        detection starts clean (the executor's reset() calls this)."""
        self._recent.clear()
        self._perf.clear()
        self._cooldown = 0

    # -- re-planning -----------------------------------------------------
    def decode_tables(self, refresh: bool = True
                      ) -> Dict[int, MeasurementTable]:
        """Current per-bucket tables.  With ``refresh`` (perf drift: the
        cached tables are the thing that's wrong) each bucket is
        re-measured through ``table_provider``; otherwise cached tables
        are reused and the provider only fills gaps — a mix-drift re-plan
        is then pure planning (millisecond-scale DP), no campaign."""
        buckets = self._plan.decode_buckets if self._plan else \
            sorted(self.tables)
        out = {}
        for b in buckets:
            if self.table_provider is not None \
                    and (refresh or b not in self.tables):
                self.tables[b] = self.table_provider(b)
            if b in self.tables:
                out[b] = self.tables[b]
        return out

    def replan(self, mix: Dict[int, float],
               reasons: Optional[Sequence[str]] = None,
               refresh: Optional[bool] = None) -> None:
        if self._plan is None or self.chip is None:
            raise RuntimeError("OnlineGovernor needs an adopted plan and "
                               "a chip to re-plan")
        if refresh is None:
            # only measured-vs-planned drift invalidates the tables; a
            # bucket-mix shift re-plans from cache
            refresh = any(r.startswith("perf-drift")
                          for r in (reasons or []))
        tables = self.decode_tables(refresh=refresh)
        if not tables:
            raise RuntimeError("OnlineGovernor has no decode tables; pass "
                               "tables= or table_provider=")
        for seg in plan_decode_joint(tables, mix, self.chip, self.policy):
            self._plan.replace_segment(seg)
        self._plan.meta["decode_mix"] = {int(b): float(f)
                                         for b, f in mix.items()}
        self._ref_mix = self._normalize_mix(mix)
        self._perf.clear()
        self._cooldown = self.window
        self.revision += 1
        self.events.append({"revision": self.revision,
                            "reason": list(reasons or ["manual"]),
                            "mix": dict(mix)})

    def solve(self, table, policy=None):
        return global_plan(table,
                           policy if policy is not None else self.policy)
