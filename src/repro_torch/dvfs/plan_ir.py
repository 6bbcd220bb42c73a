"""The unified DVFS plan IR: one serializable artifact for every
granularity the paper compares.

The paper chooses frequency *policies* at different granularities (kernel
vs pass vs iteration, §5–6) and the repo historically grew one ad-hoc
type per granularity: :class:`~repro.core.planner.Plan` (one iteration,
per-kernel choices), :class:`~repro.core.phase_plan.PhasePlanBundle`
(serving: prefill + decode-by-bucket) and
:class:`~repro.core.phase_plan.TrainPlanBundle` (training: fwd/bwd/opt).
``DvfsPlan`` subsumes all of them: a flat list of *segments*, each a
deployable :class:`~repro.core.schedule.DVFSSchedule` plus the kernels it
covers, tagged with

* ``granularity`` — how clocks vary inside the segment
  (``kernel`` | ``phase`` | ``pass`` | ``iteration``), and
* ``scope`` — when the runtime replays it (``serve-prefill``,
  ``serve-decode`` with a slot-count ``bucket``, ``train-fwd`` /
  ``train-bwd`` / ``train-opt``, or ``iteration`` for whole-step plans).

The JSON wire format is versioned (``schema_version``); loaders reject
plans written by a *newer* schema instead of misreading them.  Converters
to/from the legacy types are lossless — the legacy bundles now implement
their own ``to_json`` / ``from_json`` / ``save`` / ``load`` / ``summary``
by round-tripping through this IR, so there is exactly one serialization
and one reporting implementation.

The port's copy of the JAX package's ``dvfs/plan_ir.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.power_model import KernelSpec
from ..core.schedule import DVFSSchedule, schedule_from_plan

SCHEMA_VERSION = 1

GRANULARITIES = ("kernel", "phase", "pass", "iteration")
SCOPES = ("serve-prefill", "serve-decode", "train-fwd", "train-bwd",
          "train-opt", "iteration")
KINDS = ("serve", "train", "iteration")

# phase roles a serve plan (and the replica running it) can specialize to
PHASE_ROLES = ("unified", "prefill", "decode")


def _granularity_from_meta(meta: Dict) -> str:
    """Classify a schedule by the planner name recorded in its meta."""
    plan = str(meta.get("plan", ""))
    if plan.startswith("pass") or plan == "edp-pass":
        return "pass"
    return "kernel"


@dataclass
class PlanSegment:
    """One replayable unit: schedule + kernels + granularity/scope tags."""

    name: str                       # "prefill" | "decode@4" | "fwd" | ...
    schedule: DVFSSchedule
    kernels: List[KernelSpec]
    granularity: str = "kernel"     # GRANULARITIES
    scope: str = "iteration"        # SCOPES
    bucket: Optional[int] = None    # serve-decode: active-slot bucket

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"unknown granularity {self.granularity!r}; "
                             f"expected one of {GRANULARITIES}")
        if self.scope not in SCOPES:
            raise ValueError(f"unknown scope {self.scope!r}; "
                             f"expected one of {SCOPES}")

    @property
    def time_s(self) -> float:
        return float(self.schedule.meta.get("time_s", 0.0))

    @property
    def energy_j(self) -> float:
        return float(self.schedule.meta.get("energy_j", 0.0))

    def to_dict(self) -> Dict:
        return {"name": self.name,
                "granularity": self.granularity,
                "scope": self.scope,
                "bucket": self.bucket,
                "schedule": json.loads(self.schedule.to_json()),
                "kernels": [dataclasses.asdict(k) for k in self.kernels]}

    @classmethod
    def from_dict(cls, d: Dict) -> "PlanSegment":
        return cls(name=d["name"],
                   granularity=d.get("granularity", "kernel"),
                   scope=d.get("scope", "iteration"),
                   bucket=d.get("bucket"),
                   schedule=DVFSSchedule.from_json(
                       json.dumps(d["schedule"])),
                   kernels=[KernelSpec(**k) for k in d["kernels"]])

    # -- legacy bridge ---------------------------------------------------
    def to_phase_plan(self):
        from ..core.phase_plan import PhasePlan
        return PhasePlan(name=self.name, schedule=self.schedule,
                         kernels=self.kernels)

    @classmethod
    def from_phase_plan(cls, plan, *, scope: str, granularity: str = None,
                        bucket: Optional[int] = None) -> "PlanSegment":
        gran = granularity or _granularity_from_meta(plan.schedule.meta)
        return cls(name=plan.name, schedule=plan.schedule,
                   kernels=plan.kernels, granularity=gran, scope=scope,
                   bucket=bucket)


@dataclass
class DvfsPlan:
    """Versioned, JSON-serializable plan: the governor's unit of work."""

    chip_name: str
    kind: str                        # "serve" | "train" | "iteration"
    segments: List[PlanSegment]
    meta: Dict = field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown plan kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    # -- lookup ----------------------------------------------------------
    def segment(self, name: str) -> PlanSegment:
        for s in self.segments:
            if s.name == name:
                return s
        raise KeyError(f"no segment {name!r} in plan "
                       f"(have {[s.name for s in self.segments]})")

    def segment_names(self) -> List[str]:
        return [s.name for s in self.segments]

    def replace_segment(self, seg: PlanSegment) -> None:
        """Swap in a re-planned segment by name (online re-planning)."""
        for i, s in enumerate(self.segments):
            if s.name == seg.name:
                self.segments[i] = seg
                return
        self.segments.append(seg)

    @property
    def decode_buckets(self) -> List[int]:
        return sorted(s.bucket for s in self.segments
                      if s.scope == "serve-decode" and s.bucket is not None)

    def decode_bucket(self, n_active: int) -> int:
        """Smallest decode bucket >= n_active (largest if none)."""
        from ..core.workload import pick_decode_bucket
        bs = self.decode_buckets
        if not bs:
            raise KeyError("plan has no serve-decode segments")
        return pick_decode_bucket(bs, n_active)

    def decode_segment(self, n_active: int) -> PlanSegment:
        """Route by the structured scope+bucket tags, not by name."""
        b = self.decode_bucket(n_active)
        for s in self.segments:
            if s.scope == "serve-decode" and s.bucket == b:
                return s
        raise KeyError(f"no serve-decode segment for bucket {b}")

    @property
    def time_s(self) -> float:
        return sum(s.time_s for s in self.segments)

    @property
    def energy_j(self) -> float:
        return sum(s.energy_j for s in self.segments)

    # -- serialization: THE single implementation ------------------------
    def to_dict(self) -> Dict:
        return {"schema_version": self.schema_version,
                "kind": self.kind,
                "chip": self.chip_name,
                "meta": self.meta,
                "segments": [s.to_dict() for s in self.segments]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_dict(cls, d: Dict) -> "DvfsPlan":
        version = int(d.get("schema_version", 1))
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"plan written by schema v{version}, this build reads "
                f"<= v{SCHEMA_VERSION}; upgrade before loading")
        return cls(chip_name=d["chip"], kind=d.get("kind", "iteration"),
                   segments=[PlanSegment.from_dict(s)
                             for s in d["segments"]],
                   meta=d.get("meta", {}), schema_version=version)

    @classmethod
    def from_json(cls, s: str) -> "DvfsPlan":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "DvfsPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def summary(self) -> Dict:
        """Per-segment expected time/energy vs auto + switch counts; the
        single reporting implementation both legacy bundles delegate to."""
        rows = {}
        for s in self.segments:
            m = s.schedule.meta
            rows[s.name] = {
                "time_pct": m.get("time_pct"),
                "energy_pct": m.get("energy_pct"),
                "n_switches": s.schedule.n_switches,
                "n_kernels": len(s.kernels),
            }
        return {"chip": self.chip_name, "phases": rows, "meta": self.meta}

    # -- lossless converters from/to the legacy plan types ---------------
    @classmethod
    def from_kernel_plan(cls, plan, *, meta: Optional[Dict] = None,
                         granularity: Optional[str] = None) -> "DvfsPlan":
        """Wrap a legacy per-iteration :class:`~repro.core.planner.Plan`."""
        sched = schedule_from_plan(plan)
        seg = PlanSegment(name="iteration", schedule=sched,
                          kernels=plan.table.kernels,
                          granularity=granularity
                          or _granularity_from_meta(sched.meta),
                          scope="iteration")
        return cls(chip_name=plan.table.chip_name, kind="iteration",
                   segments=[seg], meta=dict(meta or {}))

    @classmethod
    def from_phase_bundle(cls, bundle) -> "DvfsPlan":
        segs = [PlanSegment.from_phase_plan(bundle.prefill,
                                            scope="serve-prefill")]
        for b in bundle.buckets:
            segs.append(PlanSegment.from_phase_plan(
                bundle.decode[b], scope="serve-decode", bucket=b))
        return cls(chip_name=bundle.chip_name, kind="serve", segments=segs,
                   meta=dict(bundle.meta))

    def prefill_segment(self) -> PlanSegment:
        """The serve-prefill segment, found by scope (names are free)."""
        for s in self.segments:
            if s.scope == "serve-prefill":
                return s
        raise KeyError("plan has no serve-prefill segment")

    def to_phase_bundle(self):
        from ..core.phase_plan import PhasePlanBundle
        if self.kind != "serve":
            raise ValueError(f"kind={self.kind!r} plan is not a serve "
                             f"bundle")
        prefill = self.prefill_segment().to_phase_plan()
        decode = {s.bucket: s.to_phase_plan() for s in self.segments
                  if s.scope == "serve-decode"}
        return PhasePlanBundle(chip_name=self.chip_name, prefill=prefill,
                               decode=decode, meta=dict(self.meta))

    @classmethod
    def from_train_bundle(cls, bundle) -> "DvfsPlan":
        segs = [PlanSegment.from_phase_plan(bundle.phases[ph],
                                            scope=f"train-{ph}")
                for ph in bundle.phase_names()]
        return cls(chip_name=bundle.chip_name, kind="train", segments=segs,
                   meta=dict(bundle.meta))

    def to_train_bundle(self):
        from ..core.phase_plan import TrainPlanBundle
        if self.kind != "train":
            raise ValueError(f"kind={self.kind!r} plan is not a train "
                             f"bundle")
        phases = {s.name: s.to_phase_plan() for s in self.segments}
        return TrainPlanBundle(chip_name=self.chip_name, phases=phases,
                               meta=dict(self.meta))


def derive_role_plan(plan: DvfsPlan, role: str) -> DvfsPlan:
    """Phase-specialize a unified serve plan for a disaggregated pool.

    ``role="prefill"`` keeps only the ``serve-prefill`` segments — the
    replica never decodes, so its plan is purely compute-tilted and the
    dropped decode segments can't dilute the governor's frontier.
    ``role="decode"`` keeps every segment (a decode replica still prices
    admission via the prefill segment's timing) but stamps the role so
    governors treat its frontier as memory-tilted.  ``role="unified"``
    returns the plan unchanged.  Derived plans record ``meta["role"]``
    and pin ``meta["n_slots"]`` (prefill-only plans lose the decode
    buckets that other layers read the slot count from).
    """
    if role not in PHASE_ROLES:
        raise ValueError(f"unknown phase role {role!r}; expected one of "
                         f"{PHASE_ROLES}")
    if plan.kind != "serve":
        raise ValueError(f"kind={plan.kind!r} plan has no phase roles")
    if role == "unified":
        return plan
    n_slots = int(plan.meta.get("n_slots", 0)) \
        or (max(plan.decode_buckets) if plan.decode_buckets else 0)
    segments = list(plan.segments)
    meta = {**plan.meta, "role": role}
    if role == "prefill":
        segments = [s for s in segments if s.scope == "serve-prefill"]
        if not segments:
            raise ValueError("plan has no serve-prefill segment to keep")
        # a decode mix is meaningless on (and would confuse governors of)
        # a pool that never decodes
        meta.pop("decode_mix", None)
    if n_slots:
        meta["n_slots"] = n_slots
    return DvfsPlan(chip_name=plan.chip_name, kind="serve",
                    segments=segments, meta=meta,
                    schema_version=plan.schema_version)


def validate_plan_dict(d: Dict) -> List[str]:
    """Schema check for an embedded/shipped DvfsPlan JSON object.

    Returns a list of human-readable problems (empty = valid).  Used by
    ``tools/docs_check.py`` to validate the plan JSON examples embedded in
    the docs, without needing an external jsonschema dependency.
    """
    errs: List[str] = []
    if not isinstance(d, dict):
        return [f"plan must be a JSON object, got {type(d).__name__}"]
    version = d.get("schema_version")
    if not isinstance(version, int) or version < 1:
        errs.append("schema_version must be a positive integer")
    elif version > SCHEMA_VERSION:
        errs.append(f"schema_version {version} is newer than the current "
                    f"schema v{SCHEMA_VERSION}")
    if d.get("kind") not in KINDS:
        errs.append(f"kind must be one of {KINDS}, got {d.get('kind')!r}")
    if not isinstance(d.get("chip"), str):
        errs.append("chip must be a string")
    if not isinstance(d.get("meta", {}), dict):
        errs.append("meta must be an object")
    segs = d.get("segments")
    if not isinstance(segs, list) or not segs:
        errs.append("segments must be a non-empty array")
        segs = []
    for i, s in enumerate(segs):
        where = f"segments[{i}]"
        if not isinstance(s, dict):
            errs.append(f"{where} must be an object")
            continue
        if not isinstance(s.get("name"), str):
            errs.append(f"{where}.name must be a string")
        if s.get("granularity") not in GRANULARITIES:
            errs.append(f"{where}.granularity must be one of "
                        f"{GRANULARITIES}")
        if s.get("scope") not in SCOPES:
            errs.append(f"{where}.scope must be one of {SCOPES}")
        if s.get("scope") == "serve-decode" \
                and not isinstance(s.get("bucket"), int):
            errs.append(f"{where}.bucket must be an int for serve-decode")
        sched = s.get("schedule")
        if not isinstance(sched, dict) or "entries" not in sched:
            errs.append(f"{where}.schedule must be an object with entries")
        else:
            for j, e in enumerate(sched["entries"]):
                need = {"kernel", "mem", "core", "expected_time_s"}
                if not isinstance(e, dict) or not need <= set(e):
                    errs.append(f"{where}.schedule.entries[{j}] missing "
                                f"one of {sorted(need)}")
                    break
        kernels = s.get("kernels")
        if not isinstance(kernels, list):
            errs.append(f"{where}.kernels must be an array")
        else:
            for j, k in enumerate(kernels):
                need = {"name", "kind", "flops", "hbm_bytes"}
                if not isinstance(k, dict) or not need <= set(k):
                    errs.append(f"{where}.kernels[{j}] missing one of "
                                f"{sorted(need)}")
                    break
    return errs
