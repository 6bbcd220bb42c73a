"""Cross-layer energy-conservation ledger.

Every joule the system charges lives at one of three tiers:

* **kernel** — per-segment :class:`~repro.runtime.energy.EnergyMeter`
  integrals (plus the carry accumulator re-plans flush into, plus the
  phase-boundary switch surcharge ``summary()`` adds);
* **replica** — executor busy totals + integrated idle/parked dwell
  (:meth:`~repro.fleet.replica.Replica.energy_book`);
* **fleet** — the sum over replica books + migration costs + link-retry
  energy (:func:`~repro.fleet.metering.fleet_report`).

:class:`EnergyLedger` attributes joules to (layer, scope, segment)
triples; the ``check_*`` functions re-derive each tier from the tier
below and report every mismatch beyond a 1e-6 relative tolerance — an
empty list means the books conserve.  The checks duck-type their
inputs (executors expose ``ledger_rows``/``summary``, replicas expose
``energy_book``), so this module depends only on :mod:`repro.core`.

:func:`segment_breakdown` is the waste-attribution primitive: the
per-kernel planned-vs-auto integral behind ``trace_view --waste``.

The port's copy of the JAX package's ``obs/ledger.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.coalesce import SWITCH_POWER_W
from ..core.freq import AUTO, ClockPair

#: reconciliation tolerance (relative, floored at 1.0 absolute scale)
TOL = 1e-6


def close(a: float, b: float, tol: float = TOL) -> bool:
    """Relative closeness with an absolute floor: tiny books (idle-only
    replicas) compare absolutely, big ones relatively."""
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


# ---------------------------------------------------------------------------
# waste attribution: per-kernel planned vs auto
# ---------------------------------------------------------------------------

def segment_breakdown(chip, seg) -> Dict:
    """Per-kernel planned-vs-auto time/energy for one plan segment.

    Walks the segment's clock schedule exactly as
    :meth:`EnergyMeter._integrate` does (index-exact entries, legacy
    name fallback over the "+"-coalesced display string) but keeps the
    per-kernel terms instead of summing, and evaluates each kernel at
    the auto clocks too — ``e_auto - e_plan`` is that kernel's stranded
    energy recovered by the plan.  The schedule's internal clock
    switches ride as a ``(clock-switch)`` row so the rows sum to the
    meter's per-iteration integral.
    """
    auto = ClockPair(AUTO, AUTO)
    rows: Dict[str, Dict[str, float]] = {}

    def add(k, pair, cnt):
        row = rows.setdefault(k.name, {"t_plan": 0.0, "e_plan": 0.0,
                                       "t_auto": 0.0, "e_auto": 0.0,
                                       "n": 0})
        kt, ke = chip.evaluate(k, pair)
        at, ae = chip.evaluate(k, auto)
        row["t_plan"] += kt * cnt
        row["e_plan"] += ke * cnt
        row["t_auto"] += at * cnt
        row["e_auto"] += ae * cnt
        row["n"] += int(cnt)

    sched = seg.schedule
    by_name = {}
    if any(e.kernel_idx is None for e in sched.entries):
        for k in seg.kernels:
            by_name.setdefault(k.name, k)
    for entry in sched.entries:
        pair = ClockPair(entry.mem, entry.core)
        if entry.kernel_idx is not None:
            for ki, cnt in entry.kernel_idx:
                add(seg.kernels[int(ki)], pair, cnt)
            continue
        for nm in entry.kernel.split("+"):
            k = by_name.get(nm)
            if k is not None:
                add(k, pair, k.invocations)
    if sched.n_switches:
        sw_t = sched.n_switches * chip.switch_latency_s
        rows["(clock-switch)"] = {"t_plan": sw_t,
                                  "e_plan": sw_t * SWITCH_POWER_W,
                                  "t_auto": 0.0, "e_auto": 0.0,
                                  "n": int(sched.n_switches)}
    return {"scope": seg.scope, "bucket": seg.bucket,
            "planned_time_s": seg.time_s,
            "planned_energy_j": seg.energy_j,
            "kernels": rows}


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

class EnergyLedger:
    """Joules attributed to (layer, scope, segment) triples."""

    def __init__(self):
        self.entries: List[Tuple[str, str, str, float]] = []

    def add(self, layer: str, scope: str, segment: str,
            energy_j: float) -> None:
        self.entries.append((layer, scope, segment, float(energy_j)))

    def total(self, layer: Optional[str] = None) -> float:
        return sum(e for (ly, _, _, e) in self.entries
                   if layer is None or ly == layer)

    def by_layer(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for ly, _, _, e in self.entries:
            out[ly] = out.get(ly, 0.0) + e
        return out

    def to_dict(self) -> Dict:
        return {"entries": [{"layer": ly, "scope": sc, "segment": sg,
                             "energy_j": e}
                            for ly, sc, sg, e in self.entries],
                "by_layer": self.by_layer(),
                "total_j": self.total()}


def _segment_scopes(ex) -> Dict[str, str]:
    plan = ex.governor.plan
    return {s.name: s.scope for s in plan.segments} if plan else {}


def executor_ledger(ex, ledger: Optional[EnergyLedger] = None,
                    prefix: str = "") -> EnergyLedger:
    """Kernel-tier entries: one per (segment, source) where source is
    the live meter, the re-plan carry, or the boundary-switch charge."""
    led = ledger if ledger is not None else EnergyLedger()
    scopes = _segment_scopes(ex)
    for name, row in ex.ledger_rows().items():
        scope = scopes.get(name, "unknown")
        seg = prefix + name
        led.add("kernel", scope, seg, row["metered_j"])
        if row["carry_j"]:
            led.add("kernel", scope, seg + "(carry)", row["carry_j"])
        if row["boundary_switch_j"]:
            led.add("kernel", scope, seg + "(boundary-switch)",
                    row["boundary_switch_j"])
    return led


def replica_ledger(r, ledger: Optional[EnergyLedger] = None
                   ) -> EnergyLedger:
    """Replica-tier entries: executor segments + idle/parked dwell."""
    led = ledger if ledger is not None else EnergyLedger()
    executor_ledger(r.executor, led, prefix=f"{r.name}/")
    book = r.energy_book()
    led.add("replica", "dwell", f"{r.name}/idle", book["idle_energy_j"])
    led.add("replica", "dwell", f"{r.name}/parked",
            book["parked_energy_j"])
    return led


def fleet_ledger(replicas: Sequence, report: Dict,
                 ledger: Optional[EnergyLedger] = None) -> EnergyLedger:
    """Fleet-tier entries: every replica's ledger + the cluster-level
    charges (migration transfers, link-retry burn)."""
    led = ledger if ledger is not None else EnergyLedger()
    for r in replicas:
        replica_ledger(r, led)
    led.add("fleet", "migration", "transfers",
            report.get("migration_energy_j", 0.0))
    rec = report.get("recovery") or {}
    led.add("fleet", "recovery", "link-retries",
            rec.get("link_retry_energy_j", 0.0))
    return led


# ---------------------------------------------------------------------------
# conservation checks: each tier re-derived from the tier below
# ---------------------------------------------------------------------------

def check_executor(ex, tol: float = TOL) -> List[str]:
    """Kernel tier: meter + carry + boundary-switch charge must equal
    each ``summary()`` phase row, and the rows must sum to the total."""
    problems: List[str] = []
    summ = ex.summary()
    rows = ex.ledger_rows()
    tot_e = tot_t = 0.0
    for name, srow in summ["phases"].items():
        lr = rows.get(name)
        if lr is None:
            problems.append(f"executor: segment {name!r} in summary "
                            f"but not in ledger_rows")
            continue
        want_e = lr["metered_j"] + lr["carry_j"] + lr["boundary_switch_j"]
        want_t = (lr["metered_time_s"] + lr["carry_time_s"]
                  + lr["boundary_switch_s"])
        if not close(want_e, srow["energy_j"], tol):
            problems.append(
                f"executor: segment {name!r} energy {srow['energy_j']!r}"
                f" != metered+carry+boundary {want_e!r}")
        if not close(want_t, srow["time_s"], tol):
            problems.append(
                f"executor: segment {name!r} time {srow['time_s']!r}"
                f" != metered+carry+boundary {want_t!r}")
        tot_e += want_e
        tot_t += want_t
    if not close(tot_e, summ["totals"]["energy_j"], tol):
        problems.append(f"executor: totals energy "
                        f"{summ['totals']['energy_j']!r} != "
                        f"sum of ledger rows {tot_e!r}")
    if not close(tot_t, summ["totals"]["time_s"], tol):
        problems.append(f"executor: totals time "
                        f"{summ['totals']['time_s']!r} != "
                        f"sum of ledger rows {tot_t!r}")
    return problems


def check_replica(r, tol: float = TOL) -> List[str]:
    """Replica tier: the book's busy energy must be the executor's
    total, and busy + idle + parked must be the book's whole-horizon
    energy.  Runs the kernel-tier check on the replica's executor."""
    problems = [f"{r.name}: {p}" for p in check_executor(r.executor, tol)]
    book = r.energy_book()
    busy = r.executor.summary()["totals"]["energy_j"]
    if not close(busy, book["busy_energy_j"], tol):
        problems.append(f"{r.name}: busy_energy_j "
                        f"{book['busy_energy_j']!r} != executor total "
                        f"{busy!r}")
    want = (book["busy_energy_j"] + book["idle_energy_j"]
            + book["parked_energy_j"])
    if not close(want, book["energy_j"], tol):
        problems.append(f"{r.name}: energy_j {book['energy_j']!r} != "
                        f"busy+idle+parked {want!r}")
    return problems


def check_fleet(replicas: Sequence, report: Dict,
                tol: float = TOL) -> List[str]:
    """Fleet tier: the report's cluster energy must equal the sum of
    its replica books plus migration and link-retry charges, each book
    must match the live replica it came from, and every replica must
    pass the two lower-tier checks.  Empty list = joules conserve at
    all three tiers."""
    problems: List[str] = []
    books = {b["name"]: b for b in report.get("replicas", [])}
    want = sum(b["energy_j"] for b in books.values())
    want += report.get("migration_energy_j", 0.0)
    rec = report.get("recovery")
    if rec is not None:
        want += rec.get("link_retry_energy_j", 0.0)
    if not close(want, report["energy_j"], tol):
        problems.append(f"fleet: energy_j {report['energy_j']!r} != "
                        f"books+migration+link-retries {want!r}")
    for r in replicas:
        problems += check_replica(r, tol)
        b = books.get(r.name)
        if b is None:
            problems.append(f"fleet: replica {r.name!r} missing from "
                            f"report books")
            continue
        live = r.energy_book()
        for key in ("busy_energy_j", "idle_energy_j",
                    "parked_energy_j", "energy_j"):
            if not close(live[key], b[key], tol):
                problems.append(f"fleet: {r.name} report {key} "
                                f"{b[key]!r} != live book {live[key]!r}")
    return problems
