"""DvfsSession: the campaign -> plan -> govern -> meter -> report facade.

One context manager replaces the hand-wired pipeline every benchmark and
example used to rebuild (build workload, run campaign, call the right
planner, construct the right bundle, wire the right executor)::

    from repro.dvfs import DvfsSession

    with DvfsSession(chip="tpu-v5e", tau=0.005) as sess:
        sess.plan_serve(cfg, n_slots=4, prefill_shape=pre,
                        decode_shape=dec)
        engine = ServeEngine(model, params, batch_slots=4,
                             executor=sess.serve_executor())
        engine.generate(requests)
        report = sess.report()

    with DvfsSession(chip="tpu-v5e", tau=0.006,
                     governor="pass-level") as sess:
        sess.plan_train(cfg, shape=shape)
        trainer = Trainer(..., executor=sess.train_executor())

The session owns one governor (by name or instance), one controller
backend, and at most one plan at a time.  Planning delegates to the
legacy ``plan_phase_bundle`` / ``plan_train_bundle`` pipelines and
converts the result through the lossless IR bridge, so a session-planned
``DvfsPlan`` reproduces the legacy artifacts bit-for-bit — same campaign
seed, same planner, same schedules.  On exit the session returns the
chip to the auto governor and freezes the report.

The port's copy of the JAX package's ``dvfs/session.py``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Union

from ..configs.base import ModelConfig, ShapeConfig
from ..core.measure import Campaign, MeasurementTable
from ..core.objectives import WastePolicy
from ..core.phase_plan import plan_phase_bundle, plan_train_bundle
from ..core.power_model import Chip, get_chip
from ..core.workload import WorkloadBuilder
from .executor import (GovernorExecutor, ServeGovernorExecutor,
                       TrainGovernorExecutor)
from .governors import BaseGovernor, governor as make_governor
from .plan_ir import DvfsPlan, derive_role_plan


class DvfsSession:
    """Unified planning/execution session for serve and train paths."""

    def __init__(self, *, chip: Union[str, Chip] = "tpu-v5e",
                 policy: Optional[WastePolicy] = None,
                 tau: Optional[float] = None,
                 governor: Union[str, BaseGovernor] = "kernel-static",
                 controller: Optional[Union[str, object]] = None,
                 tracer: Optional[object] = None,
                 seed: int = 0, n_reps: int = 5, **governor_kwargs):
        if policy is not None and tau is not None:
            raise ValueError("pass policy= or tau=, not both")
        explicit_policy = policy is not None or tau is not None
        self.policy = policy if policy is not None \
            else WastePolicy(tau if tau is not None else 0.0)
        self.chip = get_chip(chip) if isinstance(chip, str) else chip
        if isinstance(governor, str):
            governor = make_governor(governor, policy=self.policy,
                                     **governor_kwargs)
        elif governor_kwargs:
            raise ValueError("governor kwargs only apply to by-name "
                             "construction")
        elif explicit_policy:
            # session policy wins, as with by-name construction — so
            # solve()/replan() can never plan at a different tau than the
            # one the session stamps into plan meta
            governor.policy = self.policy
        else:
            # no session policy given: inherit the instance governor's
            self.policy = governor.policy
        self.governor = governor
        # an online governor re-plans against this session's chip; the
        # decode-table provider is wired when plan_serve knows the workload
        if getattr(self.governor, "chip", None) is None \
                and hasattr(self.governor, "table_provider"):
            self.governor.chip = self.chip
        self.controller = controller        # resolved by the executor
        self.tracer = tracer                # threaded into executors
        self.seed = seed
        self.n_reps = n_reps
        self.planner_wall_s = 0.0
        self._executors: list = []
        self._closed = False

    # -- context management ----------------------------------------------
    def __enter__(self) -> "DvfsSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Return the chip to the auto governor on every executor."""
        if not self._closed:
            for ex in self._executors:
                ex.finish()
            self._closed = True

    # -- plan ------------------------------------------------------------
    @property
    def plan(self) -> Optional[DvfsPlan]:
        return self.governor.plan

    def adopt(self, plan: DvfsPlan) -> DvfsPlan:
        """Adopt an externally produced/loaded plan (e.g. DvfsPlan.load)."""
        self.governor.adopt(plan, reason="session-adopt")
        return plan

    def plan_serve(self, cfg: ModelConfig, *, n_slots: int,
                   prefill_shape: ShapeConfig, decode_shape: ShapeConfig,
                   tp: int = 1, dp: int = 1,
                   kv_dtype: Optional[str] = None,
                   role: str = "unified",
                   meta: Optional[Dict] = None) -> DvfsPlan:
        """Campaign + plan every serving phase (prefill, decode buckets)
        with this session's governor; adopts and returns the plan.
        ``kv_dtype`` plans against a quantized KV page pool's workload
        model (the engine serving that pool should be built with the same
        ``kv_dtype``).  ``role`` phase-specializes the plan for a
        disaggregated pool (see :func:`~repro.dvfs.plan_ir
        .derive_role_plan`): prefill replicas keep only the
        compute-tilted prefill segment, decode replicas stamp their
        memory-tilted role."""
        t0 = time.perf_counter()
        bundle = plan_phase_bundle(
            cfg, self.chip, n_slots=n_slots, prefill_shape=prefill_shape,
            decode_shape=decode_shape, policy=self.policy,
            planner=self.governor.phase_planner, seed=self.seed,
            n_reps=self.n_reps, tp=tp, dp=dp, kv_dtype=kv_dtype,
            meta=meta)
        self.planner_wall_s += time.perf_counter() - t0
        plan = DvfsPlan.from_phase_bundle(bundle)
        plan.meta.setdefault("n_slots", int(n_slots))
        # the bundle plans each decode bucket under its own (1+tau)*T_b
        # budget — implicitly a uniform-traffic assumption.  Record that
        # assumption so online governors measure mix drift against what
        # the *planner* believed (a skewed serve mix — e.g. prefix-cache
        # hits tilting occupancy decode-ward — then fires a joint
        # re-plan that reallocates the shared slack budget) instead of
        # silently anchoring the reference to the first observed window.
        if plan.decode_buckets:
            plan.meta.setdefault("decode_mix", {
                int(b): 1.0 / len(plan.decode_buckets)
                for b in plan.decode_buckets})
        if role != "unified":
            plan = derive_role_plan(plan, role)
        plan.meta["governor"] = self.governor.name
        # online governor: perf-drift re-planning re-measures the decode
        # workload through this provider (mix-drift re-plans reuse the
        # cache) unless the caller supplied tables/table_provider
        if hasattr(self.governor, "table_provider") \
                and self.governor.table_provider is None \
                and not getattr(self.governor, "tables", None):
            def _measure_bucket(b: int) -> MeasurementTable:
                kernels = WorkloadBuilder(cfg, decode_shape, tp=tp, dp=dp,
                                          batch_override=b,
                                          kv_dtype=kv_dtype).build()
                return Campaign(self.chip, seed=self.seed,
                                n_reps=self.n_reps).run(kernels)
            self.governor.table_provider = _measure_bucket
        self.governor.adopt(plan, reason="plan_serve")
        return plan

    def plan_train(self, cfg: ModelConfig, *, shape: ShapeConfig,
                   tp: int = 1, dp: int = 1,
                   include_optimizer: bool = True,
                   hlo_text: Optional[str] = None,
                   table: Optional[MeasurementTable] = None,
                   meta: Optional[Dict] = None) -> DvfsPlan:
        """Campaign + plan the fwd/bwd/opt phases of one train step with
        this session's governor; adopts and returns the plan."""
        t0 = time.perf_counter()
        bundle = plan_train_bundle(
            cfg, self.chip, shape=shape, policy=self.policy,
            planner=self.governor.phase_planner, seed=self.seed,
            n_reps=self.n_reps, tp=tp, dp=dp,
            include_optimizer=include_optimizer, hlo_text=hlo_text,
            table=table, meta=meta)
        self.planner_wall_s += time.perf_counter() - t0
        plan = DvfsPlan.from_train_bundle(bundle)
        plan.meta["governor"] = self.governor.name
        self.governor.adopt(plan, reason="plan_train")
        return plan

    def plan_iteration(self, cfg: ModelConfig, shape: ShapeConfig, *,
                       tp: int = 1, dp: int = 1, sp: bool = False,
                       batch_override: Optional[int] = None,
                       include_comm: bool = False,
                       table: Optional[MeasurementTable] = None,
                       meta: Optional[Dict] = None) -> DvfsPlan:
        """Campaign + single whole-iteration plan (the quickstart path)."""
        t0 = time.perf_counter()
        if table is None:
            kernels = WorkloadBuilder(
                cfg, shape, tp=tp, dp=dp, sp=sp,
                batch_override=batch_override,
                include_comm=include_comm).build()
            table = Campaign(self.chip, seed=self.seed,
                             n_reps=self.n_reps).run(kernels)
        plan = DvfsPlan.from_kernel_plan(
            self.governor.solve(table),
            meta={**(meta or {}), "model": cfg.name, "shape": shape.name,
                  "tau": self.policy.tau, "governor": self.governor.name})
        self.planner_wall_s += time.perf_counter() - t0
        self.governor.adopt(plan, reason="plan_iteration")
        return plan

    # -- govern / meter --------------------------------------------------
    def serve_executor(self, **kw) -> ServeGovernorExecutor:
        """Engine-facing executor over this session's governor + plan."""
        kw.setdefault("tracer", self.tracer)
        ex = ServeGovernorExecutor(self.governor, self.chip,
                                   self.controller, **kw)
        self._executors.append(ex)
        return ex

    def train_executor(self, **kw) -> TrainGovernorExecutor:
        """Trainer-facing executor over this session's governor + plan."""
        kw.setdefault("tracer", self.tracer)
        ex = TrainGovernorExecutor(self.governor, self.chip,
                                   self.controller, **kw)
        self._executors.append(ex)
        return ex

    def executor(self, **kw) -> GovernorExecutor:
        kw.setdefault("tracer", self.tracer)
        ex = GovernorExecutor(self.governor, self.chip, self.controller,
                              **kw)
        self._executors.append(ex)
        return ex

    # -- report ----------------------------------------------------------
    def report(self) -> Dict:
        """Plan summary + every executor's realized accounting."""
        out: Dict = {"chip": self.chip.name, "tau": self.policy.tau,
                     "governor": self.governor.name,
                     "governor_revision": self.governor.revision,
                     "planner_wall_s": self.planner_wall_s}
        if self.governor.plan is not None:
            out["plan"] = self.governor.plan.summary()
        if self.governor.events:
            out["governor_events"] = list(self.governor.events)
        if self._executors:
            # stable shape regardless of executor count: always a list
            out["executed"] = [ex.summary() for ex in self._executors]
        return out
