"""Per-phase DVFS plan bundles: the deployable planning artifacts for both
the serving and the training path.

**Serving** (:class:`PhasePlanBundle`).  A serving step is either a
*prefill* (one admitted prompt) or a *decode* step over the currently
active slots.  The two phases sit at opposite ends of the roofline —
prefill is GEMM/compute-heavy, decode is HBM-bound weight/KV streaming
(paper §10–11) — so they get separate clock plans.  Decode additionally
varies with how many slots are occupied, so the bundle keys decode plans
by active-slot-count *bucket* (powers of two, see
:func:`~repro.core.workload.decode_slot_buckets`).

**Training** (:class:`TrainPlanBundle`).  One optimizer step decomposes
into three kernel phases executed back-to-back every step:

* ``fwd``  — embedding, forward layers, and the loss head (including the
  lm-head backward GEMMs the workload builder tags ``loss``; they run
  contiguously at the fwd/bwd boundary, so either side is switch-neutral),
* ``bwd``  — the backward pass proper,
* ``opt``  — the optimizer update (paper beyond-§5 extension).

Each phase carries its own switch-cost-aware schedule planned against the
phase's share of the measurement table (the paper's headline claim: a
per-*kernel* plan recovers 14.6 % of training energy where a per-*pass*
plan recovers ~2 %, §5–6).  The train-phase lifecycle is::

    plan_train_bundle()            offline: decompose -> measure -> plan
        -> TrainPlanBundle.save()  ship JSON to the training job
        -> TrainPhaseExecutor      online: replay fwd|bwd|opt clocks
           .on_step(step)          around every Trainer step, meter energy
        -> state_dict()/load_      survive checkpoint-restart mid-plan

Both bundles are the artifact the planner emits offline and the runtime
executes online through ``FrequencyController`` / ``EnergyMeter`` hooks —
the DSO-style fusion of offline models with online control.  JSON
round-trip like :class:`~repro.core.schedule.DVFSSchedule`; each phase
also carries its kernel list so replay accounting needs nothing but the
bundle + a chip.

The port's copy of the JAX package's ``core/phase_plan.py``; its HLO
calibration raises (the port compiles no HLO).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from .coalesce import coalesced_global_plan
from .freq import AUTO
from .measure import Campaign, MeasurementTable
from .objectives import WastePolicy
from .planner import Plan
from .power_model import Chip, KernelSpec
from .schedule import (DVFSSchedule, schedule_from_plan,
                       schedule_from_coalesced)
from .workload import (WorkloadBuilder, decode_slot_buckets,
                       pick_decode_bucket)


@dataclass
class PhasePlan:
    """One phase's deployable plan: schedule + the kernels it covers."""

    name: str                      # "prefill" | "decode@<bucket>"
    schedule: DVFSSchedule
    kernels: List[KernelSpec]

    @property
    def energy_j(self) -> float:
        return float(self.schedule.meta.get("energy_j", 0.0))

    @property
    def time_s(self) -> float:
        return float(self.schedule.meta.get("time_s", 0.0))

    def to_dict(self) -> Dict:
        return {"name": self.name,
                "schedule": json.loads(self.schedule.to_json()),
                "kernels": [dataclasses.asdict(k) for k in self.kernels]}

    @classmethod
    def from_dict(cls, d: Dict) -> "PhasePlan":
        return cls(name=d["name"],
                   schedule=DVFSSchedule.from_json(
                       json.dumps(d["schedule"])),
                   kernels=[KernelSpec(**k) for k in d["kernels"]])

    def kernel_clock_pairs(self) -> List[Tuple[object, object]]:
        """Per-kernel dominant (mem, core) pair, indexed like ``kernels``.

        A coalesced schedule may assign different clocks to different
        *instances* of the same kernel; the dominant pair (most instances)
        is what DP/TP plan transfer replays on the resharded workload.
        Kernels absent from the schedule fall back to AUTO.
        """
        counts: List[Dict[Tuple[object, object], int]] = \
            [{} for _ in self.kernels]
        for e in self.schedule.entries:
            for ki, cnt in (e.kernel_idx or []):
                d = counts[int(ki)]
                key = (e.mem, e.core)
                d[key] = d.get(key, 0) + int(cnt)
        return [max(d.items(), key=lambda kv: kv[1])[0] if d
                else (AUTO, AUTO) for d in counts]


class _IRBundleIO:
    """Serialization + reporting shared by both bundles.

    Single-sourced in the unified plan IR
    (:class:`~repro.dvfs.plan_ir.DvfsPlan`): ``to_json`` emits the
    versioned IR wire format, ``from_json`` reads it (and falls back to
    the pre-IR legacy format for old artifacts), and ``summary`` is the
    IR's one reporting implementation.
    """

    def to_ir(self):
        raise NotImplementedError

    @classmethod
    def _from_ir(cls, ir):
        raise NotImplementedError

    @classmethod
    def _from_legacy_dict(cls, d: Dict):
        raise NotImplementedError

    def to_json(self) -> str:
        return self.to_ir().to_json()

    @classmethod
    def from_json(cls, s: str):
        d = json.loads(s)
        if "segments" in d or "schema_version" in d:
            from ..dvfs.plan_ir import DvfsPlan
            return cls._from_ir(DvfsPlan.from_dict(d))
        return cls._from_legacy_dict(d)

    def save(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str):
        with open(path) as f:
            return cls.from_json(f.read())

    def summary(self) -> Dict:
        return self.to_ir().summary()


@dataclass
class PhasePlanBundle(_IRBundleIO):
    """Prefill plan + decode plans keyed by active-slot-count bucket."""

    chip_name: str
    prefill: PhasePlan
    decode: Dict[int, PhasePlan]          # bucket -> plan
    meta: Dict = field(default_factory=dict)

    @property
    def buckets(self) -> List[int]:
        return sorted(self.decode)

    def decode_bucket(self, n_active: int) -> int:
        """Smallest bucket >= n_active (largest bucket if none)."""
        return pick_decode_bucket(self.buckets, n_active)

    def decode_for(self, n_active: int) -> PhasePlan:
        return self.decode[self.decode_bucket(n_active)]

    def phases(self) -> Dict[str, PhasePlan]:
        out = {"prefill": self.prefill}
        out.update({f"decode@{b}": self.decode[b] for b in self.buckets})
        return out

    # -- serialization: single-sourced in the IR (see _IRBundleIO) -------
    def to_ir(self):
        from ..dvfs.plan_ir import DvfsPlan
        return DvfsPlan.from_phase_bundle(self)

    @classmethod
    def _from_ir(cls, ir) -> "PhasePlanBundle":
        return ir.to_phase_bundle()

    @classmethod
    def _from_legacy_dict(cls, d: Dict) -> "PhasePlanBundle":
        return cls(chip_name=d["chip"],
                   prefill=PhasePlan.from_dict(d["prefill"]),
                   decode={int(b): PhasePlan.from_dict(p)
                           for b, p in d["decode"].items()},
                   meta=d.get("meta", {}))


def compile_phase(table: MeasurementTable, name: str, chip: Chip,
                  policy: Optional[WastePolicy] = None,
                  planner: Optional[Callable[..., Plan]] = None
                  ) -> PhasePlan:
    """Compile one phase's measurement table into a deployable PhasePlan.

    By default the phase is planned with
    :func:`~repro.core.coalesce.coalesced_global_plan`, which charges clock
    switches against the time budget directly.  Pass a ``planner`` (e.g.
    :func:`~repro.core.planner.global_plan`) to use a switch-oblivious
    kernel-level plan instead; its budget is then shrunk by the realized
    switch overhead and re-planned so the *executed* phase still meets the
    policy.
    """
    policy = policy if policy is not None else WastePolicy()
    if planner is None:
        cp = coalesced_global_plan(
            table, policy, switch_latency_s=chip.switch_latency_s)
        sched = schedule_from_coalesced(cp, meta={"phase": name})
        return PhasePlan(name=name, schedule=sched, kernels=table.kernels)
    plan = planner(table, policy)
    sched = schedule_from_plan(plan, meta={"phase": name})
    # switch-oblivious planner: shrink the budget by the realized switch
    # overhead and re-plan (two rounds converge — switch counts only move
    # when the plan does)
    t_base, _ = table.baseline_totals()
    for _ in range(2):
        overhead = sched.n_switches * chip.switch_latency_s
        eff_tau = policy.tau - overhead / t_base
        plan = planner(table, WastePolicy(eff_tau))
        sched = schedule_from_plan(plan, meta={"phase": name})
    return PhasePlan(name=name, schedule=sched, kernels=table.kernels)


def plan_phase_bundle(cfg: ModelConfig, chip: Chip, *,
                      n_slots: int,
                      prefill_shape: ShapeConfig,
                      decode_shape: ShapeConfig,
                      policy: Optional[WastePolicy] = None,
                      planner: Optional[Callable[..., Plan]] = None,
                      seed: int = 0, n_reps: int = 5,
                      tp: int = 1, dp: int = 1,
                      kv_dtype: Optional[str] = None,
                      meta: Optional[Dict] = None) -> PhasePlanBundle:
    """Measure + plan every serving phase of (cfg, shapes) on ``chip``.

    Runs one simulated measurement campaign per phase (prefill at the
    prefill shape's batch, decode once per slot bucket with the bucket as
    the batch) and compiles each plan into a coalesced schedule.
    ``kv_dtype`` (e.g. ``"int8"``) plans the decode buckets against the
    quantized page pool's workload model — the cache-read stream at its
    stored width — so the plan tracks the shifted decode roofline.

    By default phases are planned with
    :func:`~repro.core.coalesce.coalesced_global_plan`, which charges clock
    switches against the time budget directly — decode steps are short
    (ms), so even µs-scale switches are budget-relevant there.  Pass a
    ``planner`` (e.g. :func:`~repro.core.planner.global_plan`) to use a
    switch-oblivious kernel-level plan instead; its budget is then shrunk
    by the realized switch overhead and re-planned so the *executed* phase
    still meets the policy.
    """
    policy = policy if policy is not None else WastePolicy()
    camp = Campaign(chip, seed=seed, n_reps=n_reps)

    def plan_one(name: str, kernels: List[KernelSpec]) -> PhasePlan:
        return compile_phase(camp.run(kernels), name, chip, policy, planner)

    pre_kernels = WorkloadBuilder(cfg, prefill_shape, tp=tp, dp=dp,
                                  kv_dtype=kv_dtype).build()
    prefill = plan_one("prefill", pre_kernels)
    decode: Dict[int, PhasePlan] = {}
    for b in decode_slot_buckets(n_slots):
        kernels = WorkloadBuilder(cfg, decode_shape, tp=tp, dp=dp,
                                  batch_override=b,
                                  kv_dtype=kv_dtype).build()
        decode[b] = plan_one(f"decode@{b}", kernels)
    md = dict(meta or {})
    md.update({"model": cfg.name, "tau": policy.tau, "n_slots": n_slots,
               "prefill_shape": prefill_shape.name,
               "decode_shape": decode_shape.name,
               "kv_dtype": kv_dtype or "none"})
    return PhasePlanBundle(chip_name=chip.name, prefill=prefill,
                           decode=decode, meta=md)


# ---------------------------------------------------------------------------
# Training path
# ---------------------------------------------------------------------------

TRAIN_PHASES = ("fwd", "bwd", "opt")

# workload-builder kernel phase tag -> train phase.  The ``loss`` pass
# (lm-head fwd + softmax + lm-head grads) runs contiguously at the fwd/bwd
# boundary; folding it into ``fwd`` keeps the boundary switch count
# unchanged while leaving ``bwd`` the pure backward pass.
_KERNEL_PHASE_TO_TRAIN = {"embed": "fwd", "fwd": "fwd", "loss": "fwd",
                          "bwd": "bwd", "opt": "opt"}


def train_phase_of(kernel: KernelSpec) -> str:
    """Map a workload-builder kernel to its train phase (fwd|bwd|opt)."""
    return _KERNEL_PHASE_TO_TRAIN.get(kernel.phase, "fwd")


@dataclass
class TrainPlanBundle(_IRBundleIO):
    """Per-train-phase plans: one switch-aware schedule per fwd/bwd/opt.

    The training analogue of :class:`PhasePlanBundle`: the offline planner
    emits it once per (model, shape, chip, mesh) and the
    :class:`~repro.runtime.dvfs_exec.TrainPhaseExecutor` replays every
    phase's clocks around each optimizer step.
    """

    chip_name: str
    phases: Dict[str, PhasePlan]      # "fwd" | "bwd" | "opt" -> plan
    meta: Dict = field(default_factory=dict)

    def phase_names(self) -> List[str]:
        return [p for p in TRAIN_PHASES if p in self.phases]

    @property
    def step_time_s(self) -> float:
        return sum(p.time_s for p in self.phases.values())

    @property
    def step_energy_j(self) -> float:
        return sum(p.energy_j for p in self.phases.values())

    # -- serialization: single-sourced in the IR (see _IRBundleIO) -------
    def to_ir(self):
        from ..dvfs.plan_ir import DvfsPlan
        return DvfsPlan.from_train_bundle(self)

    @classmethod
    def _from_ir(cls, ir) -> "TrainPlanBundle":
        return ir.to_train_bundle()

    @classmethod
    def _from_legacy_dict(cls, d: Dict) -> "TrainPlanBundle":
        return cls(chip_name=d["chip"],
                   phases={n: PhasePlan.from_dict(p)
                           for n, p in d["phases"].items()},
                   meta=d.get("meta", {}))


def calibrate_workload_against_hlo(kernels: List[KernelSpec],
                                   hlo_text: str) -> Dict:
    """The reference cross-checks the analytic workload against the
    compiled step's HLO here; the port compiles no HLO, so this raises.
    Its counterpart, a count of the port's step with
    ``torch.utils.flop_counter``, is queued in ROADMAP.md (queue 1, the
    follow-ups of item 4c)."""
    raise NotImplementedError(
        "hlo_text: the port has no HLO to calibrate against; the "
        "FLOP-counter calibration is queued in ROADMAP.md (queue 1, the "
        "follow-ups of item 4c)")


def plan_train_bundle(cfg: ModelConfig, chip: Chip, *,
                      shape: ShapeConfig,
                      policy: Optional[WastePolicy] = None,
                      planner: Optional[Callable[..., Plan]] = None,
                      seed: int = 0, n_reps: int = 5,
                      tp: int = 1, dp: int = 1,
                      include_optimizer: bool = True,
                      hlo_text: Optional[str] = None,
                      table: Optional[MeasurementTable] = None,
                      meta: Optional[Dict] = None) -> TrainPlanBundle:
    """Measure + plan the fwd/bwd/opt phases of one train step on ``chip``.

    Runs a single measurement campaign over the full train-step workload
    (so kernel-level and pass-level comparisons share one table), then
    plans each train phase on its subset of the table.  ``dp``/``tp`` give
    the per-device shard: the per-device batch is
    ``shape.global_batch // dp`` and tensor-parallel kernels are sharded
    ``tp`` ways, exactly as
    :class:`~repro.core.workload.WorkloadBuilder` does.  Pass the jitted
    step's optimized HLO as ``hlo_text`` to record an analytic-vs-compiled
    calibration in the bundle meta.  Pass a precomputed ``table`` (whose
    kernels must be this same workload) to plan several bundles — e.g.
    kernel- vs pass-level, or transferred vs replanned — against one
    measurement campaign instead of re-measuring.
    """
    policy = policy if policy is not None else WastePolicy()
    if shape.kind != "train":
        raise ValueError(f"train shape required, got kind={shape.kind!r}")
    if table is None:
        kernels = WorkloadBuilder(
            cfg, shape, tp=tp, dp=dp,
            include_optimizer=include_optimizer).build()
        table = Campaign(chip, seed=seed, n_reps=n_reps).run(kernels)
    else:
        kernels = table.kernels
    phases: Dict[str, PhasePlan] = {}
    for ph in TRAIN_PHASES:
        mask = [train_phase_of(k) == ph for k in kernels]
        if not any(mask):
            continue
        phases[ph] = compile_phase(table.subset(mask), ph, chip, policy,
                                   planner)
    md = dict(meta or {})
    md.update({"model": cfg.name, "tau": policy.tau, "shape": shape.name,
               "seq_len": shape.seq_len, "global_batch": shape.global_batch,
               "tp": tp, "dp": dp,
               "include_optimizer": include_optimizer})
    if hlo_text is not None:
        md["hlo_calibration"] = calibrate_workload_against_hlo(
            kernels, hlo_text)
    return TrainPlanBundle(chip_name=chip.name, phases=phases, meta=md)
