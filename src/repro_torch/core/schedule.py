"""DVFS schedules: the deployable artifact a plan compiles into.

A schedule is the ordered list of (kernel, clock pair, expected dwell)
entries the runtime's :class:`~repro.runtime.energy.FrequencyController`
replays around kernel launches, with adjacent same-clock entries coalesced
into runs.  JSON round-trip so plans can be shipped to training jobs.

The port's copy of the JAX package's ``core/schedule.py``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .freq import AUTO, ClockPair
from .measure import MeasurementTable
from .planner import Plan


@dataclass
class ScheduleEntry:
    kernel: str
    mem: object
    core: object
    expected_time_s: float
    count: int = 1     # consecutive instances sharing this clock
    # exact integration handle: [[kernel_index, n_invocations], ...] into
    # the plan's kernel list.  Kernel *names* are display-only (they can
    # collide or contain the "+" coalescing separator); the indices make
    # EnergyMeter integration exact.
    kernel_idx: Optional[List[List[int]]] = None


@dataclass
class DVFSSchedule:
    chip_name: str
    entries: List[ScheduleEntry]
    meta: Dict = field(default_factory=dict)

    @property
    def n_switches(self) -> int:
        n = 0
        prev = None
        for e in self.entries:
            cur = (e.mem, e.core)
            if prev is not None and cur != prev:
                n += 1
            prev = cur
        return n

    def total_expected_time(self) -> float:
        return sum(e.expected_time_s * 1 for e in self.entries)

    # -- serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "chip": self.chip_name,
            "meta": self.meta,
            "entries": [dataclasses.asdict(e) for e in self.entries],
        }, indent=1)

    @classmethod
    def from_json(cls, s: str) -> "DVFSSchedule":
        d = json.loads(s)
        return cls(chip_name=d["chip"],
                   entries=[ScheduleEntry(**e) for e in d["entries"]],
                   meta=d.get("meta", {}))

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "DVFSSchedule":
        with open(path) as f:
            return cls.from_json(f.read())


def schedule_from_plan(plan: Plan, meta: Optional[Dict] = None
                       ) -> DVFSSchedule:
    """Compile a per-kernel Plan into a coalesced schedule (instances in
    kernel order; per-kernel plans apply one clock per kernel id)."""
    t = plan.table
    entries: List[ScheduleEntry] = []
    for i, k in enumerate(t.kernels):
        c = t.pairs[int(plan.choice[i])]
        e = ScheduleEntry(kernel=k.name, mem=c.mem, core=c.core,
                          expected_time_s=float(t.time[i, plan.choice[i]])
                          * k.invocations,
                          count=k.invocations,
                          kernel_idx=[[i, k.invocations]])
        if entries and (entries[-1].mem, entries[-1].core) == (c.mem, c.core):
            entries[-1] = dataclasses.replace(
                entries[-1],
                kernel=entries[-1].kernel + f"+{k.name}",
                expected_time_s=entries[-1].expected_time_s
                + e.expected_time_s,
                count=entries[-1].count + e.count,
                kernel_idx=entries[-1].kernel_idx + e.kernel_idx)
        else:
            entries.append(e)
    md = dict(meta or {})
    md.update(plan.summary())
    return DVFSSchedule(chip_name=t.chip_name, entries=entries, meta=md)


def schedule_from_coalesced(cp, meta: Optional[Dict] = None
                            ) -> DVFSSchedule:
    """Compile a CoalescedPlan (per-instance choices) into run-length
    coalesced entries."""
    t = cp.table
    entries: List[ScheduleEntry] = []
    for pos, (ki, ci) in enumerate(zip(cp.sequence, cp.choice_seq)):
        pair = t.pairs[int(ci)]
        k = t.kernels[int(ki)]
        dt = float(t.time[ki, ci])
        if entries and (entries[-1].mem, entries[-1].core) == (pair.mem,
                                                               pair.core):
            last = entries[-1]
            idx = list(last.kernel_idx)
            if idx and idx[-1][0] == int(ki):
                idx[-1] = [int(ki), idx[-1][1] + 1]
            else:
                idx.append([int(ki), 1])
            entries[-1] = dataclasses.replace(
                last, expected_time_s=last.expected_time_s + dt,
                count=last.count + 1, kernel_idx=idx)
        else:
            entries.append(ScheduleEntry(kernel=k.name, mem=pair.mem,
                                         core=pair.core,
                                         expected_time_s=dt,
                                         kernel_idx=[[int(ki), 1]]))
    md = dict(meta or {})
    md.update(cp.summary())
    return DVFSSchedule(chip_name=t.chip_name, entries=entries, meta=md)
