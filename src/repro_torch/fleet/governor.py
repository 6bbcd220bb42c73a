"""FleetGovernor: one power cap, many replicas, one shared multiplier.

The fleet tier's energy knob is the same one the paper turns per kernel:
trade a bounded slowdown for power.  A :class:`FleetGovernor` enforces a
**cluster-wide power cap** by solving one shared Lagrangian budget across
replicas — the fleet analogue of :func:`~repro_torch.dvfs.plan_decode_joint`'s
shared budget across decode buckets, and built *from* it:

1. **Frontier** — per replica, sweep a grid of slowdown budgets
   ``tau`` and re-plan its decode segments jointly over the observed
   bucket mix (``plan_decode_joint`` on the governor's cached tables —
   pure planning, no campaign).  Weighting each candidate plan by the
   replica's observed phase execution counts yields its busy
   power/slowdown frontier ``P_r(tau)``.
2. **Shared multiplier** — the cap couples the replicas:
   ``min Σ slowdown_r  s.t.  Σ u_r·P_r(tau_r) + idle ≤ cap``.  The
   Lagrangian decouples per replica — each picks
   ``argmin_tau slowdown(tau) + λ·u_r·P(tau)`` — and one bisection on
   the shared ``λ`` meets the cap: slack flows to the replicas where a
   watt costs the least slowdown (exactly how the joint decode budget
   flows between buckets).
3. **Push** — every changed ``tau_r`` is pushed through the replica's
   existing :class:`~repro_torch.dvfs.OnlineGovernor` re-plan path
   (``replan`` with the observed mix), so executors swap meters with
   carry and the revision/event log records the cap action like any
   other drift re-plan.

Because the per-kernel frontier is steep near the operating point (the
paper's core result: double-digit energy at sub-percent time), a
several-percent cap cut costs well under 1% slowdown — the claim the
fleet benchmark asserts.  If even the deepest frontier point cannot meet
the cap, the governor (optionally) drains the least-utilized replica so
parking — the deepest frequency state — absorbs the rest.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..core.objectives import WastePolicy
from ..core.phase_plan import compile_phase
from ..dvfs.governors import OnlineGovernor, plan_decode_joint
from ..dvfs.plan_ir import PlanSegment
from ..obs import NULL_TRACER
from .metering import LOADED_UTIL_MIN
from .replica import DEAD, PARKED, Replica

#: tau offsets (added to each replica's base policy tau) swept into the
#: power/slowdown frontier; spacing keeps adjacent cluster-power steps
#: well inside the cap tolerance
TAU_SWEEP = (0.0, 0.001, 0.002, 0.003, 0.005, 0.0075,
             0.01, 0.015, 0.02, 0.03)


@dataclass(frozen=True)
class FrontierPoint:
    """One candidate operating point of one replica."""

    tau: float
    time_s: float          # phase-count-weighted busy time per unit work
    energy_j: float
    slowdown: float        # vs the replica's base-tau point

    @property
    def power_w(self) -> float:
        return self.energy_j / self.time_s if self.time_s > 0 else 0.0


class FleetGovernor:
    """Cluster power-cap enforcement over OnlineGovernor replicas."""

    def __init__(self, power_cap_w: float, *, interval_s: float = 1.0,
                 tolerance: float = 0.02,
                 tau_sweep: Sequence[float] = TAU_SWEEP,
                 allow_park: bool = False):
        if power_cap_w <= 0:
            raise ValueError(f"power_cap_w must be > 0, got {power_cap_w}")
        self.power_cap_w = float(power_cap_w)
        self.interval_s = float(interval_s)
        self.tolerance = float(tolerance)
        self.tau_sweep = tuple(tau_sweep)
        self.allow_park = allow_park
        self.events: List[Dict] = []
        #: trace sink for cap-tick instants (the fleet loop retargets
        #: this to its own tracer before serving)
        self.tracer = NULL_TRACER
        self.n_replans = 0
        # frontier cache: replica -> (phase-weight shares, points); a
        # material shift of the observed shares rebuilds the frontier
        self._frontiers: Dict[str, tuple] = {}
        self._applied: Dict[str, float] = {}
        # slow feedback nulling model-vs-measured bias (idle slivers in
        # windows, mix shift since the frontier was built)
        self._bias_w = 0.0
        self._last_predicted: Optional[float] = None

    # -- frontier ---------------------------------------------------------
    @staticmethod
    def _require_online(r: Replica) -> OnlineGovernor:
        gov = r.governor
        if not isinstance(gov, OnlineGovernor):
            raise TypeError(
                f"replica {r.name!r} runs governor {gov.name!r}; the "
                f"fleet power cap pushes plans through the online "
                f"re-plan path — build capped replicas with "
                f"governor='online'")
        return gov

    def _phase_weights(self, r: Replica):
        """Observed execution counts per (prefill, decode-bucket) — the
        workload weighting of the frontier.  Before any execution, fall
        back to the plan's recorded decode mix at unit prefill."""
        plan = r.plan
        pre = 0.0
        buckets: Dict[int, float] = {}
        for name, row in r.executor.summary()["phases"].items():
            seg = plan.segment(name)
            if seg.scope == "serve-prefill":
                pre += row["steps"]
            elif seg.scope == "serve-decode" and seg.bucket is not None:
                buckets[int(seg.bucket)] = buckets.get(int(seg.bucket),
                                                       0.0) + row["steps"]
        if not any(buckets.values()):
            mix = plan.meta.get("decode_mix") or \
                {b: 1.0 for b in plan.decode_buckets}
            buckets = {int(b): float(f) for b, f in mix.items()}
            pre = pre or 1.0
        return pre, buckets

    def _prefill_at(self, r: Replica, tau: float):
        """(time_s, energy_j) of the replica's prefill re-planned at
        ``tau`` — prefill is compute-bound, so it is the fleet cap's
        widest lever (big V² headroom the decode segments, already near
        their energy floor, no longer have).  Without a prefill table
        the segment stays fixed."""
        seg = r.plan.prefill_segment()
        if r.prefill_table is None:
            return seg.time_s, seg.energy_j
        pp = compile_phase(r.prefill_table, seg.name, r.chip,
                           WastePolicy(tau))
        m = pp.schedule.meta
        return float(m["time_s"]), float(m["energy_j"])

    @staticmethod
    def _weight_shares(n_pre: float, buckets: Dict[int, float]) -> Dict:
        tot = n_pre + sum(buckets.values())
        if tot <= 0:
            return {}
        out = {"prefill": n_pre / tot}
        out.update({b: w / tot for b, w in buckets.items()})
        return out

    def replica_frontier(self, r: Replica) -> List[FrontierPoint]:
        """The replica's busy power/slowdown curve.  Cached — candidate
        re-planning is pure DP on the governor's cached tables — and
        rebuilt when the observed phase mix drifts from the one the
        cache was weighted with."""
        n_pre, buckets = self._phase_weights(r)
        shares = self._weight_shares(n_pre, buckets)
        cached = self._frontiers.get(r.name)
        if cached is not None:
            old_shares, points = cached
            if OnlineGovernor._tv_distance(shares, old_shares) <= 0.1:
                return points
        gov = self._require_online(r)
        tables = gov.decode_tables(refresh=False)
        if not tables and buckets:
            raise RuntimeError(f"replica {r.name!r} has no decode tables "
                               f"to build a power frontier from")
        if not tables and not r.plan.decode_buckets:
            # prefill-role replica: the frontier is the prefill lever
            # alone — a different (compute-tilted, much steeper) curve
            # than its decode siblings, arbitrated by the same shared λ
            buckets = {}
            n_pre = n_pre or 1.0
        mix = gov.observed_mix() or gov._ref_mix \
            or {b: 1.0 for b in tables}
        base_tau = r.session.policy.tau
        points: List[FrontierPoint] = []
        for dt in self.tau_sweep:
            tau = base_tau + dt
            by_bucket = {}
            if tables:
                segs = plan_decode_joint(tables, mix, r.chip,
                                         WastePolicy(tau))
                by_bucket = {s.bucket: s for s in segs}
            t_pre, e_pre = self._prefill_at(r, tau)
            t = n_pre * t_pre
            e = n_pre * e_pre
            for b, w in buckets.items():
                seg = by_bucket.get(b)
                if seg is None:
                    continue
                t += w * seg.time_s
                e += w * seg.energy_j
            points.append(FrontierPoint(tau=tau, time_s=t,
                                        energy_j=e, slowdown=0.0))
        base_t = points[0].time_s
        points = [FrontierPoint(tau=p.tau, time_s=p.time_s,
                                energy_j=p.energy_j,
                                slowdown=p.time_s / base_t - 1.0)
                  for p in points]
        self._frontiers[r.name] = (shares, points)
        return points

    def invalidate(self, name: Optional[str] = None) -> None:
        """Drop cached frontiers (e.g. after a large mix shift)."""
        if name is None:
            self._frontiers.clear()
        else:
            self._frontiers.pop(name, None)

    # -- the shared-λ solve ----------------------------------------------
    def _choose(self, lam: float, live: List[Replica],
                util: Dict[str, float]) -> Dict[str, FrontierPoint]:
        chosen = {}
        for r in live:
            u = util.get(r.name, 1.0)
            chosen[r.name] = min(
                self.replica_frontier(r),
                key=lambda p: p.slowdown + lam * u * p.power_w)
        return chosen

    def _cluster_power(self, chosen: Dict[str, FrontierPoint],
                       replicas: Sequence[Replica],
                       util: Dict[str, float]) -> float:
        tot = 0.0
        for r in replicas:
            if r.state == DEAD:
                continue                  # a dead chip draws nothing
            if r.state == PARKED:
                tot += r.parked_power_w
                continue
            u = min(util.get(r.name, 1.0), 1.0)
            busy = chosen[r.name].power_w if r.name in chosen \
                else (r.plan.energy_j / r.plan.time_s)
            tot += u * busy + (1.0 - u) * r.idle_power_w
        return tot

    def solve(self, replicas: Sequence[Replica], util: Dict[str, float],
              cap_w: Optional[float] = None) -> Dict:
        """One shared-λ bisection: per-replica operating points meeting
        the cap (or the deepest feasible set if the cap is unreachable)."""
        cap_w = self.power_cap_w if cap_w is None else cap_w
        live = [r for r in replicas if r.state not in (PARKED, DEAD)]
        lo, hi = 0.0, 1e-6
        chosen = self._choose(0.0, live, util)
        p0 = self._cluster_power(chosen, replicas, util)
        if p0 <= cap_w:
            return {"lambda": 0.0, "chosen": chosen, "predicted_w": p0,
                    "feasible": True}
        # grow hi until under cap (or the frontier bottoms out)
        for _ in range(60):
            chosen = self._choose(hi, live, util)
            if self._cluster_power(chosen, replicas, util) <= cap_w:
                break
            hi *= 2.0
        else:
            return {"lambda": hi, "chosen": chosen,
                    "predicted_w": self._cluster_power(chosen, replicas,
                                                       util),
                    "feasible": False}
        for _ in range(50):
            mid = 0.5 * (lo + hi)
            c = self._choose(mid, live, util)
            if self._cluster_power(c, replicas, util) <= cap_w:
                hi, chosen = mid, c
            else:
                lo = mid
        chosen = self._choose(hi, live, util)
        return {"lambda": hi, "chosen": chosen,
                "predicted_w": self._cluster_power(chosen, replicas,
                                                   util),
                "feasible": True}

    # -- push -------------------------------------------------------------
    def _push(self, r: Replica, pt: FrontierPoint, lam: float) -> None:
        """Apply one operating point: decode segments through the
        replica's OnlineGovernor re-plan path (revision bump, meter
        swap-with-carry), prefill re-compiled at the same tau."""
        gov = self._require_online(r)
        gov.policy = WastePolicy(pt.tau)
        if r.plan.decode_buckets:
            mix = gov.observed_mix() or gov._ref_mix \
                or {b: 1.0 for b in r.plan.decode_buckets}
            gov.replan(mix, reasons=[
                f"fleet-power-cap:{self.power_cap_w:.0f}W:"
                f"tau={pt.tau:.4f}:lambda={lam:.2e}"], refresh=False)
        if r.prefill_table is not None:
            seg = r.plan.prefill_segment()
            pp = compile_phase(r.prefill_table, seg.name, r.chip,
                               WastePolicy(pt.tau))
            r.plan.replace_segment(PlanSegment.from_phase_plan(
                pp, scope="serve-prefill"))
        self._applied[r.name] = pt.tau
        self.n_replans += 1

    def _trace_tick(self, event: Dict) -> None:
        if self.tracer.enabled:
            name = "cap-hold" if event.get("hold") else "cap-tick"
            self.tracer.instant(
                "fleet", name, event["t"], cat="replan",
                args={k: v for k, v in event.items() if k != "t"})

    # -- control loop -----------------------------------------------------
    def control(self, replicas: Sequence[Replica], *, now_s: float,
                measured_w: Optional[float] = None,
                util: Optional[Dict[str, float]] = None) -> Dict:
        """One control tick: null the model-vs-measured bias, solve the
        shared budget against the corrected cap, and push every changed
        operating point through the replicas' online re-plan paths."""
        util = util or {}
        loaded = bool(util) and min(util.values()) > LOADED_UTIL_MIN
        if loaded and measured_w is not None \
                and self._last_predicted is not None:
            # EMA of the feed-forward model's error on loaded windows
            self._bias_w = 0.7 * self._bias_w \
                + 0.3 * (measured_w - self._last_predicted)
            if abs(measured_w - self.power_cap_w) \
                    <= 0.75 * self.tolerance * self.power_cap_w:
                # inside the hold band: don't chase window noise
                event = {"t": now_s, "cap_w": self.power_cap_w,
                         "predicted_w": self._last_predicted,
                         "measured_w": measured_w, "lambda": None,
                         "feasible": True, "pushed": [], "hold": True}
                self.events.append(event)
                self._trace_tick(event)
                return event
        sol = self.solve(replicas, util,
                         cap_w=self.power_cap_w - self._bias_w)
        self._last_predicted = sol["predicted_w"] + self._bias_w
        pushed = []
        for r in replicas:
            pt = sol["chosen"].get(r.name)
            if pt is None:
                continue
            prev = self._applied.get(r.name, r.session.policy.tau)
            if abs(pt.tau - prev) < 1e-12:
                continue
            self._push(r, pt, sol["lambda"])
            pushed.append({"replica": r.name, "tau": pt.tau})
        if not sol["feasible"] and self.allow_park:
            live = [r for r in replicas if r.state == "active"]
            if len(live) > 1:
                victim = min(live, key=lambda r: util.get(r.name, 1.0))
                victim.drain()
                pushed.append({"replica": victim.name, "drain": True})
        event = {"t": now_s, "cap_w": self.power_cap_w,
                 "predicted_w": sol["predicted_w"],
                 "measured_w": measured_w, "lambda": sol["lambda"],
                 "feasible": sol["feasible"], "pushed": pushed}
        self.events.append(event)
        self._trace_tick(event)
        return event

    def summary(self) -> Dict:
        return {"power_cap_w": self.power_cap_w,
                "interval_s": self.interval_s,
                "n_ticks": len(self.events),
                "n_replans": self.n_replans,
                "applied_taus": dict(self._applied),
                "feasible": all(e["feasible"] for e in self.events)
                if self.events else True}
