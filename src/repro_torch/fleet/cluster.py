"""The fleet: N replicas, one router, an optional power-cap governor.

:class:`Fleet` drives an open-loop :class:`~repro_torch.fleet.traces.Trace`
through the replica pool in modeled time: every arrival advances all
replica clocks to the arrival instant, the router places the request,
and (when a :class:`~repro_torch.fleet.governor.FleetGovernor` is attached)
control ticks interleave at a fixed cadence — measuring the last
window's cluster power and re-solving the shared cap budget.  After the
last arrival the loop keeps ticking until every queue drains, then pads
every replica to the common horizon so idle/parked energy covers the
same span on all of them.

:func:`build_fleet` is the constructor the CLI/benchmark use: a list of
:class:`ReplicaSpec` (chip, slots, tau, governor), one *template* plan
per distinct spec (campaign + plan once, then each replica adopts its
own copy and shares the cached decode tables — replicas re-plan
independently but never re-measure), and optional cross-chip plan
transfer: with ``transfer_from``, secondary chip models get their plan
by :func:`~repro_torch.parallel.plan_transfer.transfer_serve_plan` from the
primary's — the §7–8 "frequencies translate" claim promoted to
heterogeneous fleets.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from ..configs.base import ModelConfig, ShapeConfig
from ..core.measure import Campaign, MeasurementTable
from ..core.workload import WorkloadBuilder, decode_slot_buckets
from ..dvfs.governors import governor as make_governor
from ..dvfs.plan_ir import PHASE_ROLES, DvfsPlan, derive_role_plan
from ..dvfs.session import DvfsSession
from .faults import (FaultInjector, FaultSchedule, apply_thermal_cap,
                     lift_thermal_cap)
from .governor import FleetGovernor
from ..obs import NULL_TRACER, from_controller_events, from_recovery_books
from .metering import (LOADED_UTIL_MIN, TransferCostModel, fleet_report,
                       kv_bytes_per_token)
from .replica import (ACTIVE, DEAD, DECODE, PREFILL, Replica,
                      RequestState)
from .router import BaseRouter, router as make_router
from .traces import Trace


@dataclass(frozen=True)
class ReplicaSpec:
    """Recipe for one replica (hashable: equal specs share a template)."""

    chip: str = "tpu-v5e"
    n_slots: int = 4
    tau: float = 0.005
    governor: str = "online"
    #: phase role for disaggregated serving: "unified" serves both
    #: phases; "prefill"/"decode" replicas form the two-stage pools
    role: str = "unified"

    def __post_init__(self):
        if self.role not in PHASE_ROLES:
            raise ValueError(f"unknown replica role {self.role!r}; "
                             f"expected one of {PHASE_ROLES}")


def decode_tables(cfg: ModelConfig, chip, decode_shape: ShapeConfig,
                  n_slots: int, *, tp: int = 1, dp: int = 1, seed: int = 0,
                  n_reps: int = 5) -> Dict[int, MeasurementTable]:
    """One measurement table per decode slot bucket on ``chip`` — the
    shared cache every replica's online re-planning (and the fleet
    governor's frontier sweep) plans from."""
    camp = Campaign(chip, seed=seed, n_reps=n_reps)
    out = {}
    for b in decode_slot_buckets(n_slots):
        kernels = WorkloadBuilder(cfg, decode_shape, tp=tp, dp=dp,
                                  batch_override=b).build()
        out[b] = camp.run(kernels)
    return out


class Fleet:
    """A replica pool behind one router, in one modeled timeline."""

    def __init__(self, replicas: Sequence[Replica],
                 router: Union[str, BaseRouter] = "round-robin",
                 governor: Optional[FleetGovernor] = None,
                 autopark_idle_s: Optional[float] = None,
                 tick_interval_s: Optional[float] = None,
                 transfer_cost: Optional[TransferCostModel] = None,
                 kv_token_bytes: int = 0,
                 faults: Optional[FaultSchedule] = None,
                 recover: bool = True,
                 heartbeat_timeout_s: float = 0.02,
                 migration_max_retries: int = 3,
                 migration_backoff_s: float = 2e-3,
                 tracer: Optional[object] = None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self.replicas = list(replicas)
        roles = {r.role for r in replicas}
        #: disaggregated when a prefill pool exists; it needs somewhere
        #: to migrate multi-token requests to
        self.disaggregated = PREFILL in roles
        if self.disaggregated and roles == {PREFILL}:
            raise ValueError("a prefill-only fleet cannot finish "
                             "multi-token requests; add decode or "
                             "unified replicas")
        self.router = make_router(router) if isinstance(router, str) \
            else router
        # tracing: fleet-level events (migrations, faults, power, cap
        # ticks) on their own tracks; inherits the replicas' tracer when
        # none is given so one Tracer covers every tier of the run
        self.tracer = tracer if tracer is not None else next(
            (r.tracer for r in self.replicas if r.tracer.enabled),
            NULL_TRACER)
        self._n_transfers = 0
        self.governor = governor
        self.autopark_idle_s = autopark_idle_s
        #: power-window cadence when no governor drives it (keep equal
        #: across runs being compared — window length shapes the
        #: loaded-power statistics)
        self.tick_interval_s = tick_interval_s
        #: migration cost model + per-token KV payload (bytes); defaults
        #: cover direct Fleet construction — build_fleet derives the
        #: payload analytically from the model config
        self.transfer_cost = transfer_cost or TransferCostModel()
        self.kv_token_bytes = int(kv_token_bytes)
        self.power_series: List[Dict] = []
        self.migrations: List[Dict] = []
        self._pending: List[RequestState] = []
        self._snap_energy: Dict[str, float] = {}
        self._snap_busy: Dict[str, float] = {}
        self._snap_t = 0.0
        # fault injection + recovery (see repro_torch.fleet.faults)
        self.injector = FaultInjector(faults) if faults is not None \
            else None
        self.recover = recover
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.migration_max_retries = int(migration_max_retries)
        self.migration_backoff_s = float(migration_backoff_s)
        self._by_name = {r.name: r for r in self.replicas}
        #: dropped transfers awaiting their backoff retry
        self._retry: List[RequestState] = []
        #: crashed replica -> its orphans, until the heartbeat expires
        self._orphans: Dict[str, Dict[str, List[RequestState]]] = {}
        #: orphans abandoned because recovery is off
        self._stranded: List[RequestState] = []
        self.recovery = {
            "n_crashes": 0, "n_evicted": 0, "n_redispatched": 0,
            "n_redelivered": 0, "n_link_retries": 0,
            "n_link_fallbacks": 0, "n_link_degraded": 0,
            "n_thermal_caps": 0, "n_driver_faults": 0,
            "link_retry_energy_j": 0.0}

    # -- two-stage dispatch pools ----------------------------------------
    @property
    def admit_pool(self) -> List[Replica]:
        """Stage 1 (arrivals): everything that can run a prefill."""
        return [r for r in self.replicas
                if r.role != DECODE and r.state != DEAD]

    @property
    def decode_dispatch_pool(self) -> List[Replica]:
        """Stage 2 (migrations): everything that can continue a decode."""
        return [r for r in self.replicas
                if r.role != PREFILL and r.state != DEAD]

    # -- clock helpers ----------------------------------------------------
    def _advance_all(self, t: float) -> None:
        for r in self.replicas:
            r.run_until(t)
        if self.autopark_idle_s is not None:
            for r in self.replicas:
                if r.state == ACTIVE and not r.has_work() \
                        and t - r.last_work_s >= self.autopark_idle_s:
                    r.drain()
                    r.park()

    def _window(self, now: float) -> Dict:
        """Measure the cluster over the window since the last tick."""
        dt = now - self._snap_t
        d_energy, util = 0.0, {}
        for r in self.replicas:
            e = r.energy_book()["energy_j"]
            d_energy += e - self._snap_energy.get(r.name, 0.0)
            db = r.busy_s - self._snap_busy.get(r.name, 0.0)
            util[r.name] = min(db / dt, 1.0) if dt > 0 else 0.0
            self._snap_energy[r.name] = e
            self._snap_busy[r.name] = r.busy_s
        self._snap_t = now
        return {"t": now, "dt": dt,
                "power_w": d_energy / dt if dt > 0 else 0.0,
                "util": util,
                "loaded": bool(util)
                and min(util.values()) > LOADED_UTIL_MIN}

    def _tick(self, now: float) -> None:
        win = self._window(now)
        self.power_series.append(win)
        if self.tracer.enabled:
            self.tracer.counter("fleet", "cluster_power_w", now,
                                {"power_w": win["power_w"]},
                                cat="power")
        if self.governor is not None:
            self.governor.control(self.replicas, now_s=now,
                                  measured_w=win["power_w"],
                                  util=win["util"])

    # -- migration (disaggregated prefill -> decode) -----------------------
    def _transfer(self, rs: RequestState, start_s: float) -> None:
        """Launch (or re-launch) one page-block transfer at ``start_s``.

        On a healthy link this charges the modeled cost record and
        schedules the delivery — byte-for-byte the legacy path.  Inside a
        ``link-degrade`` window time and energy stretch by the window's
        factor; inside a ``link-drop`` window the attempt burns its link
        energy and is retried with capped exponential backoff, falling
        back to a decode-side prefill re-run once retries are spent."""
        cost = self.transfer_cost.cost(
            self.kv_token_bytes * rs.page_tokens)
        state, factor = self.injector.link_state(start_s) \
            if self.injector is not None else ("ok", 1.0)
        if state == "drop":
            rs.link_attempts += 1
            # the failed attempt still drove the link
            self.recovery["link_retry_energy_j"] += cost["energy_j"]
            if self.tracer.enabled:
                self.tracer.instant(
                    "migrations", "link-drop", start_s, cat="fault",
                    args={"uid": rs.req.uid,
                          "attempt": rs.link_attempts,
                          "energy_j": cost["energy_j"]})
            if rs.link_attempts > self.migration_max_retries:
                self.recovery["n_link_fallbacks"] += 1
                rs.needs_reprefill = True
                rs.migrate_ready_s = start_s
                self._pending.append(rs)
            else:
                self.recovery["n_link_retries"] += 1
                backoff = min(
                    self.migration_backoff_s
                    * 2.0 ** (rs.link_attempts - 1),
                    8.0 * self.migration_backoff_s)
                rs.migrate_ready_s = start_s + backoff
                self._retry.append(rs)
            return
        if state == "degrade":
            self.recovery["n_link_degraded"] += 1
            cost = {"bytes": cost["bytes"],
                    "time_s": cost["time_s"] * factor,
                    "energy_j": cost["energy_j"] * factor}
        self.migrations.append(cost)
        rs.migrate_ready_s = start_s + cost["time_s"]
        if self.tracer.enabled:
            # async span: in-flight transfers overlap, so they pair by
            # correlation id instead of B/E nesting
            self._n_transfers += 1
            self.tracer.aspan(
                "migrations", f"migrate:{rs.req.uid}", start_s,
                cost["time_s"], id=f"{rs.req.uid}:{self._n_transfers}",
                cat="migration",
                args={"bytes": cost["bytes"],
                      "energy_j": cost["energy_j"],
                      "degraded": state == "degrade"})
        self._pending.append(rs)

    def _drain_outboxes(self) -> None:
        """Turn every prefill replica's finished-prefill outbox into an
        in-flight page-block transfer: charge the modeled cost record and
        schedule the delivery at prefill-finish + transfer time."""
        for r in self.replicas:
            while r.outbox:
                rs = r.outbox.pop(0)
                self._transfer(rs, rs.first_token_s)

    def _retry_due(self, now: float) -> None:
        """Re-launch every dropped transfer whose backoff has elapsed."""
        due = [rs for rs in self._retry
               if rs.migrate_ready_s <= now + 1e-12]
        if not due:
            return
        self._retry = [rs for rs in self._retry
                       if rs.migrate_ready_s > now + 1e-12]
        due.sort(key=lambda rs: (rs.migrate_ready_s, rs.req.uid))
        for rs in due:
            self._transfer(rs, now)

    def _deliver_due(self, now: float) -> None:
        """Stage-2 dispatch: route every landed transfer into the decode
        pool.  Deliveries are ordered by (ready time, uid) so replay of
        the same trace is bit-identical."""
        due = [rs for rs in self._pending
               if rs.migrate_ready_s <= now + 1e-12]
        if not due:
            return
        self._pending = [rs for rs in self._pending
                         if rs.migrate_ready_s > now + 1e-12]
        due.sort(key=lambda rs: (rs.migrate_ready_s, rs.req.uid))
        pool = self.decode_dispatch_pool
        if not pool:
            self._raise_stalled("decode", len(due))
        for rs in due:
            rep = self.router.route(rs.req, pool)
            rep.enqueue(rs)

    def _next_migration_s(self) -> float:
        return min(min((rs.migrate_ready_s for rs in self._pending),
                       default=float("inf")),
                   min((rs.migrate_ready_s for rs in self._retry),
                       default=float("inf")))

    # -- faults: injection, detection, recovery ---------------------------
    def _raise_stalled(self, kind: str, n: int) -> None:
        """Satellite of the fault work: the fleet must fail loudly, not
        loop forever, when work remains but no replica can take it."""
        dead = [r.name for r in self.replicas if r.state == DEAD]
        raise RuntimeError(
            f"fleet cannot make progress: every {kind}-capable replica "
            f"is dead ({', '.join(dead) or 'none alive'}) and {n} "
            f"request(s) still need one — they would strand forever. "
            f"Add {kind} replicas, protect one from the fault schedule, "
            f"or accept the loss via a no-recovery run's "
            f"fleet_report()['n_stranded'].")

    def _next_fault_s(self) -> float:
        """Next injected fault or pending heartbeat-timeout detection."""
        t = self.injector.next_s() if self.injector is not None \
            else float("inf")
        for name in self._orphans:
            t = min(t, self._by_name[name].dead_since
                    + self.heartbeat_timeout_s)
        return t

    def _process_faults(self, now: float) -> None:
        """Apply every due injected fault, then run heartbeat detection
        (a death is only *acted on* once its timeout expires)."""
        if self.injector is not None:
            for action, ev in self.injector.pop_due(now):
                self._apply_fault(action, ev, now)
        for name in sorted(self._orphans):
            r = self._by_name[name]
            if now + 1e-12 >= r.dead_since + self.heartbeat_timeout_s:
                self._detect(r, self._orphans.pop(name), now)

    def _apply_fault(self, action: str, ev, now: float) -> None:
        r = self._by_name.get(ev.replica) if ev.replica else None
        if action == "crash":
            if r is None or r.state == DEAD:
                return
            self.recovery["n_crashes"] += 1
            self._orphans[r.name] = r.fail(now)
            # the crash snapshot fail() took before flushing the radix
            # tree — the at-crash cache/pool books would otherwise be
            # silently lost with the replica
            if r.crash_stats is not None:
                self.recovery.setdefault("crash_books", {})[r.name] = \
                    r.crash_stats
            if self.governor is not None:
                self.governor.invalidate(r.name)
        elif action == "thermal-cap":
            if r is None or r.state == DEAD \
                    or r.thermal_cap is not None:
                return
            self.recovery["n_thermal_caps"] += 1
            apply_thermal_cap(r, float(ev.params.get("max_core_frac",
                                                     0.6)))
            if self.governor is not None:
                self.governor.invalidate(r.name)
        elif action == "thermal-lift":
            if r is None or r.state == DEAD or r.thermal_cap is None:
                return
            lift_thermal_cap(r)
            if self.governor is not None:
                self.governor.invalidate(r.name)
        elif action == "driver-fail":
            if r is None or r.state == DEAD:
                return
            ctl = getattr(r.executor, "controller", None)
            if ctl is not None and hasattr(ctl, "inject_failure"):
                self.recovery["n_driver_faults"] += 1
                ctl.inject_failure(ev.dwell_s)
                r._event({"t": now, "event": "driver-fail",
                          "dwell_s": ev.dwell_s}, cat="fault")
            else:
                r._event({"t": now, "event": "driver-fail-skipped",
                          "why": "controller cannot fail "
                                 "(simulated backend)"}, cat="fault")

    def _detect(self, r: Replica, orphans: Dict, now: float) -> None:
        """Heartbeat expired: evict the dead replica and re-dispatch its
        orphans exactly once each.  Queued requests that never prefilled
        re-route like fresh arrivals; requests whose KV still exists at a
        live prefiller get a re-delivered transfer; everything else
        (mid-decode slots, unsent outbox, dead prefiller) re-runs its
        prefill on the decode side with its token budget resumed."""
        self.recovery["n_evicted"] += 1
        r._event({"t": now, "event": "evicted"}, cat="fault")
        if not self.recover:
            for bucket in ("queued", "slots", "outbox"):
                self._stranded.extend(orphans[bucket])
            return
        for rs in sorted(orphans["queued"],
                         key=lambda rs: rs.req.uid):
            if rs.first_token_s is None:
                pool = self.admit_pool
                if not pool:
                    self._raise_stalled("prefill", 1)
                self.router.route(rs.req, pool).enqueue(rs)
                self.recovery["n_redispatched"] += 1
                continue
            src = self._by_name.get(rs.prefilled_on)
            if rs.needs_reprefill or src is None or src.state == DEAD:
                rs.needs_reprefill = True
                rs.migrate_ready_s = now
                self._pending.append(rs)
                self.recovery["n_redispatched"] += 1
            else:
                # the prefiller survives: re-deliver a fresh transfer
                self.recovery["n_redelivered"] += 1
                self._transfer(rs, now)
        for rs in sorted(orphans["slots"] + orphans["outbox"],
                         key=lambda rs: rs.req.uid):
            rs.needs_reprefill = True
            rs.migrate_ready_s = now
            self._pending.append(rs)
            self.recovery["n_redispatched"] += 1

    def _recovery_books(self) -> Dict:
        rec = dict(self.recovery)
        rec["n_reprefills"] = sum(r.n_recovery_prefills
                                  for r in self.replicas)
        rec["reprefill_energy_j"] = sum(r.recovery_prefill_j
                                        for r in self.replicas)
        return rec

    # -- serving ----------------------------------------------------------
    def serve(self, trace: Trace) -> Dict:
        """Replay the trace; returns the fleet accounting report.

        Disaggregated fleets run two-stage dispatch: arrivals route over
        the prefill(+unified) pool; a finished prefill's KV pages migrate
        (modeled time + energy charged to the books) and the landed
        transfer routes over the decode(+unified) pool, where admission
        continues the decode without re-billing the prefill.  Decode-pool
        backpressure is the replica's own admission queue + page pool: a
        migrated request that finds no slot/pages waits exactly like any
        queued request."""
        interval = self.governor.interval_s if self.governor is not None \
            else (self.tick_interval_s
                  or max(trace.duration_s / 16.0, 1e-3))
        states = [RequestState(req=q) for q in trace.requests]
        if self.governor is not None:
            self.governor.tracer = self.tracer
            # pre-control: cap the initial plans before the first window
            # (otherwise the ramp-in window runs uncapped and overshoots)
            self.governor.control(self.replicas, now_s=0.0)
        next_tick = interval
        i = 0
        while i < len(states) or self._pending or self._retry \
                or self._orphans \
                or any(r.has_work() or r.outbox for r in self.replicas):
            t_arr = states[i].req.arrival_s if i < len(states) \
                else float("inf")
            t_mig = self._next_migration_s()
            t_evt = self._next_fault_s()
            if t_evt <= min(t_mig, t_arr, next_tick):
                # faults fire before outbox drain so a crash mid-
                # migration-prep orphans the undrained outbox items
                self._advance_all(t_evt)
                self._process_faults(t_evt)
                self._drain_outboxes()
                self._retry_due(t_evt)
                self._deliver_due(t_evt)
                continue
            if t_mig <= min(t_arr, next_tick):
                self._advance_all(t_mig)
                self._drain_outboxes()
                self._retry_due(t_mig)
                self._deliver_due(t_mig)
                continue
            if next_tick <= t_arr:
                self._advance_all(next_tick)
                self._drain_outboxes()
                self._deliver_due(next_tick)
                self._tick(next_tick)
                next_tick += interval
                continue
            # next_tick > t_arr here, and t_arr is inf once the trace is
            # exhausted — so this branch only handles real arrivals (the
            # post-trace drain always goes through the tick branch above)
            self._advance_all(t_arr)
            self._drain_outboxes()
            rs = states[i]
            pool = self.admit_pool
            if not pool:
                self._raise_stalled("prefill", len(states) - i)
            rep = self.router.route(rs.req, pool)
            rep.enqueue(rs)
            i += 1
        horizon = max(max((rs.finish_s or 0.0) for rs in states),
                      max(r.clock for r in self.replicas))
        self._advance_all(horizon)        # idle-pad to a common horizon
        self._tick(horizon)
        n_stranded = sum(1 for rs in states if not rs.done)
        report = fleet_report(
            self.replicas, states, horizon,
            power_series=self.power_series,
            cap_w=self.governor.power_cap_w if self.governor is not None
            else None,
            migrations=self.migrations,
            n_stranded=n_stranded,
            recovery=self._recovery_books()
            if self.injector is not None else None)
        report["router"] = self.router.name
        report["disaggregated"] = self.disaggregated
        if self.governor is not None:
            report["fleet_governor"] = self.governor.summary()
        if self.tracer.enabled:
            # fold the remaining legacy streams onto the schema: driver/
            # freq records live in each controller's own busy-time axis
            # (the replica spans already cover phases live), and the
            # recovery books close the trace at the horizon
            for r in self.replicas:
                evs = getattr(r.executor.controller,
                              "controller_events", None)
                if evs:
                    self.tracer.extend(
                        from_controller_events(evs, track=r.name))
            if self.injector is not None:
                self.tracer.extend(from_recovery_books(
                    report["recovery"], track="fleet", ts=horizon))
        return report


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def default_serve_shapes(n_slots: int):
    pre = ShapeConfig(name="serve_prefill", seq_len=512, global_batch=1,
                      kind="prefill")
    dec = ShapeConfig(name="serve_decode", seq_len=512,
                      global_batch=n_slots, kind="decode")
    return pre, dec


def _clone_plan(plan: DvfsPlan) -> DvfsPlan:
    """Each replica owns a mutable copy (online re-plans are per-replica);
    the JSON round-trip is the IR's lossless clone."""
    return DvfsPlan.from_json(plan.to_json())


def build_replica(name: str, spec: ReplicaSpec, plan: DvfsPlan,
                  tables: Dict[int, MeasurementTable], *,
                  wake_latency_s: float = 0.0,
                  prefill_table: Optional[MeasurementTable] = None,
                  controller: Optional[str] = None,
                  prefix_cache: bool = False,
                  pool_pages: Optional[int] = None,
                  cache_seed: int = 0,
                  tracer: Optional[object] = None) -> Replica:
    """One replica from a template plan + shared decode tables."""
    if spec.role == PREFILL:
        # a prefill-only plan has no decode segments to re-plan; give the
        # online governor no tables so nothing can ask it to
        tables = {}
    gov_kwargs = {"tables": tables} if spec.governor == "online" else {}
    gov = make_governor(spec.governor, **gov_kwargs)
    sess = DvfsSession(chip=spec.chip, tau=spec.tau, governor=gov,
                       controller=controller)
    sess.adopt(_clone_plan(plan))
    return Replica(name, sess, n_slots=spec.n_slots,
                   wake_latency_s=wake_latency_s,
                   prefill_table=prefill_table,
                   n_pages=pool_pages,
                   prefix_cache=prefix_cache,
                   cache_seed=cache_seed,
                   tracer=tracer)


def build_fleet(specs: Sequence[ReplicaSpec], cfg: ModelConfig, *,
                router: Union[str, BaseRouter] = "energy-slo",
                power_cap_w: Optional[float] = None,
                cap_interval_s: float = 1.0,
                autopark_idle_s: Optional[float] = None,
                wake_latency_s: float = 0.05,
                transfer_from: Optional[str] = None,
                seed: int = 0, n_reps: int = 5,
                fleet_governor: Optional[FleetGovernor] = None,
                tick_interval_s: Optional[float] = None,
                transfer_cost: Optional[TransferCostModel] = None,
                kv_dtype: str = "none",
                controller: Optional[str] = None,
                faults: Optional[FaultSchedule] = None,
                recover: bool = True,
                heartbeat_timeout_s: float = 0.02,
                prefix_cache: bool = False,
                pool_pages: Optional[int] = None,
                tracer: Optional[object] = None) -> Fleet:
    """Plan once per distinct spec, instantiate one replica per entry.

    With ``transfer_from`` (a chip name appearing in ``specs``), every
    *other* chip model's template plan is derived from that chip's plan
    via cross-chip transfer instead of its own planning run (the target
    is still measured, for repair and metering) — the
    heterogeneous-fleet deployment story: one plan search, every chip
    model of the fleet.

    Phase-specialized specs (``role="prefill"``/``"decode"``) share the
    planning run with their unified sibling spec — the base plan is
    campaigned once per (chip, slots, tau, governor), then specialized
    via :func:`~repro_torch.dvfs.plan_ir.derive_role_plan` (prefill roles keep
    only the compute-tilted prefill segment) — and the fleet runs
    two-stage dispatch with a modeled
    :class:`~repro_torch.fleet.metering.TransferCostModel` charging each KV
    page-block migration (payload derived analytically from ``cfg`` at
    ``kv_dtype`` storage width) into the books.

    ``prefix_cache=True`` gives every replica a radix prefix cache over
    its page pool (admission splices cached prompt pages and bills only
    the uncached suffix fraction of each prefill); ``pool_pages``
    overrides the default never-backpressuring pool geometry so cache
    eviction pressure is benchmarkable.
    """
    from ..parallel.plan_transfer import transfer_serve_plan

    plans: Dict[ReplicaSpec, DvfsPlan] = {}
    tables: Dict[ReplicaSpec, Dict[int, MeasurementTable]] = {}
    pre_tables: Dict[ReplicaSpec, MeasurementTable] = {}
    src_plan: Optional[DvfsPlan] = None
    # roles share one campaign: plan the unified base per distinct
    # (chip, slots, tau, governor), specialize per spec afterwards
    ordered = [dataclasses.replace(s, role="unified") for s in specs]
    if transfer_from is not None:
        if not any(s.chip == transfer_from for s in ordered):
            raise ValueError(f"transfer_from={transfer_from!r} does not "
                             f"appear in the replica specs")
        ordered.sort(key=lambda s: s.chip != transfer_from)
    for spec in ordered:
        if spec in plans:
            continue
        pre, dec = default_serve_shapes(spec.n_slots)
        sess = DvfsSession(chip=spec.chip, tau=spec.tau,
                           governor="online", seed=seed, n_reps=n_reps)
        tabs = decode_tables(cfg, sess.chip, dec, spec.n_slots,
                             seed=seed, n_reps=n_reps)
        pre_tables[spec] = Campaign(sess.chip, seed=seed, n_reps=n_reps) \
            .run(WorkloadBuilder(cfg, pre).build())
        if transfer_from is not None and spec.chip != transfer_from \
                and src_plan is not None:
            plan = transfer_serve_plan(src_plan, cfg, sess.chip,
                                       prefill_shape=pre,
                                       decode_shape=dec,
                                       tables=tabs, seed=seed,
                                       n_reps=n_reps)
        else:
            plan = sess.plan_serve(cfg, n_slots=spec.n_slots,
                                   prefill_shape=pre, decode_shape=dec)
            if transfer_from is not None and spec.chip == transfer_from:
                src_plan = plan
        plans[spec] = plan
        tables[spec] = tabs
    replicas = []
    for i, spec in enumerate(specs):
        base = dataclasses.replace(spec, role="unified")
        plan = derive_role_plan(plans[base], spec.role)
        suffix = "" if spec.role == "unified" else f"-{spec.role[:3]}"
        replicas.append(build_replica(
            f"r{i}-{spec.chip}{suffix}", spec, plan, tables[base],
            wake_latency_s=wake_latency_s,
            prefill_table=pre_tables[base],
            controller=controller,
            prefix_cache=prefix_cache,
            pool_pages=pool_pages,
            cache_seed=seed + i,
            tracer=tracer))
    gov = fleet_governor
    if gov is None and power_cap_w is not None:
        gov = FleetGovernor(power_cap_w, interval_s=cap_interval_s)
    return Fleet(replicas, router=router, governor=gov,
                 autopark_idle_s=autopark_idle_s,
                 tick_interval_s=tick_interval_s,
                 transfer_cost=transfer_cost,
                 kv_token_bytes=kv_bytes_per_token(cfg, kv_dtype),
                 faults=faults, recover=recover,
                 heartbeat_timeout_s=heartbeat_timeout_s,
                 tracer=tracer)


def parse_replica_specs(text: str) -> List[ReplicaSpec]:
    """CLI grammar: ``chip[:slots[:tau]][@role][,chip...]`` or
    ``Nxchip[...]``, e.g. ``2xtpu-v5e:4,a4000:4`` -> two tpu-v5e
    replicas + one a4000; ``tpu-v5e@prefill,2xtpu-v5e@decode`` -> a
    disaggregated 1-prefill/2-decode pool."""
    specs: List[ReplicaSpec] = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        count = 1
        if "x" in part and part.split("x", 1)[0].isdigit():
            head, part = part.split("x", 1)
            count = int(head)
        role = "unified"
        if "@" in part:
            part, role = part.rsplit("@", 1)
        bits = part.split(":")
        spec = ReplicaSpec(
            chip=bits[0],
            n_slots=int(bits[1]) if len(bits) > 1 else 4,
            tau=float(bits[2]) if len(bits) > 2 else 0.005,
            role=role)
        specs.extend([spec] * count)
    if not specs:
        raise ValueError(f"no replica specs parsed from {text!r}")
    return specs
