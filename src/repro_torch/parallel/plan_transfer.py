"""DP/TP plan transfer: one discovered plan, every shard of the fleet.

The paper's §7–8 claim — "frequencies translate": a clock plan discovered
once on a single device keeps (almost all of) its savings when the same
model runs data-parallel (smaller per-device batch) or tensor-parallel
(sharded kernels).  This module makes that claim executable for the
training path: given a single-device
:class:`~repro_torch.core.phase_plan.TrainPlanBundle` and a
:class:`~repro_torch.launch.mesh.MeshSpec`, it derives the per-device
bundle — rebuilding the per-shard workload (per-device batch
``global_batch / dp``, kernels sharded ``tp`` ways, invocation counts and
collective phases rescaled by the
:class:`~repro_torch.core.workload.WorkloadBuilder`), then replaying the
source plan's per-kernel clock choices onto the resharded kernel-instance
sequence and re-coalescing.

Transfer is a three-stage, measurement-free mapping:

1. **Name match** — the workload builder emits the same ordered kernel
   list for every DP/TP degree (sizes change, identities do not), so each
   sharded kernel starts from its own single-device clocks.
2. **Roofline remap** — sharding moves kernels along the roofline (a
   TP=4 GEMM has ~4x less arithmetic intensity than its TP=1 self, and
   can cross from compute- to memory-bound).  When a kernel's analytic
   intensity shifted beyond ``name_pref`` (log-space), it instead adopts
   the clocks of the *nearest-intensity* source kernel of the same kind —
   the source plan read as a (kind, intensity) → clocks map.  Intensity
   is analytic (FLOPs / HBM bytes of the :class:`KernelSpec`), so this
   needs no target measurement.
3. **Budget repair** — any kernel whose transferred clocks still regress
   its per-kernel time beyond ``(1 + tau) * repair_margin`` is re-picked
   from the source plan's *frequency vocabulary* (the handful of pairs
   the plan actually uses, plus auto) under the strict local budget.  In
   deployment this check is one quick re-timing of the transferred plan —
   the same validation run the paper performs — not a new campaign.

Kernels present only in the sharded workload (e.g. TP collectives when
communication is modeled) fall back to auto clocks — the conservative
choice, since the source campaign never measured them.

The port's copy of the JAX package's ``parallel/plan_transfer.py``, on the
port's ``configs``, ``core``, ``dvfs`` and ``launch.mesh``; its chip
registry (``core.CHIPS``) adds ``h100_like``, so a serve plan transfers
to and from the H100 model too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig
from ..core.coalesce import SWITCH_POWER_W, CoalescedPlan, expand_sequence
from ..core.freq import ClockPair
from ..core.measure import Campaign, MeasurementTable
from ..core.objectives import WastePolicy, pct
from ..core.phase_plan import (PhasePlan, TrainPlanBundle, compile_phase,
                               plan_train_bundle, train_phase_of)
from ..core.power_model import Chip, KernelSpec
from ..core.schedule import schedule_from_coalesced
from ..core.workload import WorkloadBuilder
from ..launch.mesh import MeshSpec

# keep the name-matched clocks while |log AI_target - log AI_source| stays
# below this (~exp(0.25) = 28% intensity shift); beyond it, remap along
# the roofline
NAME_PREF_LOG_AI = 0.25
# per-kernel time regressions beyond (1+tau)*margin trigger budget repair
REPAIR_MARGIN = 1.10


def _match_pair(k: KernelSpec, src_kernels: Sequence[KernelSpec],
                src_pairs: Sequence[Tuple[object, object]],
                name_pref: float = NAME_PREF_LOG_AI
                ) -> Optional[Tuple[object, object]]:
    """Stage 1+2: name match with roofline (nearest-log-intensity) remap."""
    lai = math.log(max(k.arithmetic_intensity, 1e-9))
    best, bestd, named, named_d = None, None, None, None
    for sk, p in zip(src_kernels, src_pairs):
        d = abs(math.log(max(sk.arithmetic_intensity, 1e-9)) - lai)
        if sk.kind == k.kind and (bestd is None or d < bestd):
            best, bestd = p, d
        if sk.name == k.name:
            named, named_d = p, d
    if named is not None and (best is None or named_d <= name_pref
                              or named_d <= bestd + 1e-9):
        return named
    return best if best is not None else named


def transfer_train_bundle(src: TrainPlanBundle, cfg: ModelConfig,
                          chip: Chip, shape: ShapeConfig, spec: MeshSpec,
                          *, seed: int = 0, n_reps: int = 5,
                          include_optimizer: Optional[bool] = None,
                          include_comm: bool = False,
                          name_pref: float = NAME_PREF_LOG_AI,
                          repair_margin: float = REPAIR_MARGIN,
                          table: Optional[MeasurementTable] = None
                          ) -> TrainPlanBundle:
    """Derive the per-device bundle for ``spec`` from a source bundle.

    The returned bundle's schedules carry exact per-shard accounting
    (time/energy/switches of the *transferred* choices on the resharded
    measurement table), so it can be executed through
    :class:`~repro_torch.runtime.dvfs_exec.TrainPhaseExecutor` and compared
    against a freshly-planned per-mesh bundle.  Per-phase meta records
    how many kernels were name-matched, roofline-remapped, and
    budget-repaired.  Pass a precomputed per-shard ``table`` to share one
    measurement campaign with a per-mesh replanning run.
    """
    if src.chip_name != chip.name:
        raise ValueError(f"bundle planned for {src.chip_name!r}, "
                         f"transferring onto {chip.name!r} — the source "
                         f"clock pairs would not exist in the target grid")
    tau = float(src.meta.get("tau", 0.0))
    if include_optimizer is None:
        include_optimizer = bool(src.meta.get("include_optimizer", True))
    dp, tp = spec.data_extent, spec.tp
    if table is None:
        kernels = WorkloadBuilder(
            cfg, shape, tp=tp, dp=dp, include_comm=include_comm,
            include_optimizer=include_optimizer).build()
        table = Campaign(chip, seed=seed, n_reps=n_reps).run(kernels)
    else:
        kernels = table.kernels
    phases: Dict[str, PhasePlan] = {}
    for ph in src.phase_names():
        mask = [train_phase_of(k) == ph for k in kernels]
        if not any(mask):
            continue
        sub = table.subset(mask)
        src_phase = src.phases[ph]
        src_pairs = src_phase.kernel_clock_pairs()
        name_pair = {k.name: p for k, p in zip(src_phase.kernels,
                                               src_pairs)}
        pair_idx = {(p.mem, p.core): i for i, p in enumerate(sub.pairs)}
        vocab = sorted({pair_idx[p] for p in src_pairs if p in pair_idx}
                       | {sub.auto_idx})
        n_remapped = n_repaired = n_unmatched = 0
        kchoice: List[int] = []
        for i, k in enumerate(sub.kernels):
            pair = _match_pair(k, src_phase.kernels, src_pairs, name_pref)
            if pair is None:
                n_unmatched += 1
            elif pair != name_pair.get(k.name):
                n_remapped += 1
            ci = pair_idx.get(pair, sub.auto_idx)
            # stage 3: local budget repair within the frequency vocabulary
            auto_t = sub.time[i, sub.auto_idx]
            if sub.time[i, ci] > (1.0 + tau) * repair_margin * auto_t:
                n_repaired += 1
                feas = [c for c in vocab
                        if sub.time[i, c] <= (1.0 + tau) * auto_t]
                ci = min(feas, key=lambda c: sub.energy[i, c]) if feas \
                    else sub.auto_idx
            kchoice.append(ci)
        seq = expand_sequence(sub)
        choice_seq = np.array([kchoice[ki] for ki in seq], dtype=np.int32)
        cp = CoalescedPlan(choice_seq=choice_seq, sequence=seq, table=sub,
                           switch_latency_s=chip.switch_latency_s,
                           switch_energy_j=chip.switch_latency_s
                           * SWITCH_POWER_W)
        sched = schedule_from_coalesced(
            cp, meta={"phase": ph, "transferred_from": src.meta,
                      "n_kernels": len(sub.kernels),
                      "n_remapped": n_remapped,
                      "n_repaired": n_repaired,
                      "n_unmatched": n_unmatched})
        phases[ph] = PhasePlan(name=ph, schedule=sched, kernels=sub.kernels)
    md = dict(src.meta)
    md.update({"mesh": spec.describe(), "dp": dp, "tp": tp,
               "transferred": True})
    return TrainPlanBundle(chip_name=chip.name, phases=phases, meta=md)


@dataclass
class TransferRow:
    """Transferred vs freshly-replanned outcome on one mesh."""

    mesh: str
    transfer_time_pct: float       # vs the per-shard auto baseline
    transfer_energy_pct: float
    replan_time_pct: float
    replan_energy_pct: float
    transfer_energy_j: float
    replan_energy_j: float
    base_energy_j: float
    n_remapped: int = 0
    n_repaired: int = 0

    @property
    def energy_vs_replan_pct(self) -> float:
        """How far the transferred plan's energy is from replanning."""
        return pct(self.transfer_energy_j, self.replan_energy_j)

    def to_dict(self) -> Dict:
        d = dict(self.__dict__)
        d["energy_vs_replan_pct"] = self.energy_vs_replan_pct
        return d


def compare_transfer(src: TrainPlanBundle, cfg: ModelConfig, chip: Chip,
                     shape: ShapeConfig, specs: Sequence[MeshSpec],
                     policy: WastePolicy, *, seed: int = 0,
                     n_reps: int = 5) -> List[TransferRow]:
    """Replay ``src`` on each mesh and compare to per-mesh replanning.

    Both bundles are evaluated on literally the same per-mesh measurement
    table, so the comparison isolates the plan, not the noise draw.
    """
    include_optimizer = bool(src.meta.get("include_optimizer", True))
    rows = []
    for spec in specs:
        mesh_seed = seed + spec.n_devices + 31 * spec.tp
        # one campaign per mesh; transfer and replanning share its table
        kernels = WorkloadBuilder(
            cfg, shape, tp=spec.tp, dp=spec.data_extent,
            include_optimizer=include_optimizer).build()
        table = Campaign(chip, seed=mesh_seed, n_reps=n_reps).run(kernels)
        xfer = transfer_train_bundle(src, cfg, chip, shape, spec,
                                     table=table)
        fresh = plan_train_bundle(
            cfg, chip, shape=shape, policy=policy, table=table,
            tp=spec.tp, dp=spec.data_extent,
            include_optimizer=include_optimizer)
        xt = xe = ft = fe = bt = be = 0.0
        n_remapped = n_repaired = 0
        for ph in xfer.phase_names():
            xm = xfer.phases[ph].schedule.meta
            fm = fresh.phases[ph].schedule.meta
            xt += xm["time_s"]
            xe += xm["energy_j"]
            ft += fm["time_s"]
            fe += fm["energy_j"]
            bt += xm["base_time_s"]
            be += xm["base_energy_j"]
            n_remapped += xm.get("n_remapped", 0)
            n_repaired += xm.get("n_repaired", 0)
        rows.append(TransferRow(
            mesh=spec.describe(),
            transfer_time_pct=pct(xt, bt), transfer_energy_pct=pct(xe, be),
            replan_time_pct=pct(ft, bt), replan_energy_pct=pct(fe, be),
            transfer_energy_j=xe, replan_energy_j=fe, base_energy_j=be,
            n_remapped=n_remapped, n_repaired=n_repaired))
    return rows


# ---------------------------------------------------------------------------
# Cross-chip serve-plan transfer (the heterogeneous-fleet path)
# ---------------------------------------------------------------------------

def _chip_by_model_name(name: str) -> Chip:
    """Resolve a ``Chip.name`` (as recorded in plan artifacts) back to a
    chip model — registry keys are short ids, plans store full names."""
    from ..core.power_model import CHIPS
    for factory in CHIPS.values():
        c = factory()
        if c.name == name:
            return c
    raise KeyError(f"no registered chip model named {name!r}")


def _snap_clock(value, src_chip: Chip, dst_chip: Chip,
                domain: str) -> object:
    """Map one domain's clock by *relative* frequency: AUTO passes
    through; a MHz value keeps its fraction of fmax and snaps to the
    nearest point of the target grid (grids differ across chip models —
    absolute MHz do not transfer, operating points do)."""
    from ..core.freq import AUTO
    if value == AUTO:
        return AUTO
    rel = src_chip.rel_clock(value, domain)
    clocks = (dst_chip.grid.mem_clocks_mhz if domain == "mem"
              else dst_chip.grid.core_clocks_mhz)
    arr = np.asarray(clocks, dtype=float)
    target = rel * arr[-1]
    return float(arr[int(np.argmin(np.abs(arr - target)))])


def transfer_serve_plan(src, cfg: ModelConfig, chip: Chip, *,
                        prefill_shape: ShapeConfig,
                        decode_shape: ShapeConfig,
                        tp: int = 1, dp: int = 1, seed: int = 0,
                        n_reps: int = 5,
                        repair_margin: float = REPAIR_MARGIN,
                        tables: Optional[Dict] = None):
    """Derive a serve :class:`~repro_torch.dvfs.DvfsPlan` for a *different
    chip model* from a plan discovered on another — §7–8's "frequencies
    translate" claim promoted from meshes to heterogeneous fleets.

    Per segment (prefill + each decode bucket), a three-stage
    measurement-free mapping mirroring :func:`transfer_train_bundle`:

    1. **Relative-frequency snap** — each kernel's source clock pair is
       read as a *fraction of fmax* per domain and snapped onto the
       target chip's grid (the operating point transfers; the MHz value
       is grid-specific).
    2. **Budget repair** — kernels whose snapped clocks regress their
       per-kernel time beyond ``(1+tau)*repair_margin`` on the target
       table are re-picked from the transferred frequency vocabulary
       under the strict local budget (one re-timing, not a campaign).
    3. **Re-coalesce** — the per-kernel choices are re-compiled into a
       switch-aware schedule with the *target* chip's switch latency,
       so the transferred plan carries exact target-side accounting.

    ``tables`` (decode-bucket -> :class:`MeasurementTable` on the target
    chip) lets the caller share one campaign with the replica's online
    re-planning cache; missing phases are measured here.
    """
    from ..dvfs.plan_ir import DvfsPlan, PlanSegment

    if src.kind != "serve":
        raise ValueError(f"kind={src.kind!r} plan is not a serve plan")
    if src.chip_name == chip.name:
        raise ValueError(f"source and target are both {chip.name!r}; "
                         f"cross-chip transfer needs distinct chip "
                         f"models (clone the plan instead)")
    src_chip = _chip_by_model_name(src.chip_name)
    tau = float(src.meta.get("tau", 0.0))
    # role-derived plans (e.g. a disaggregated prefill pool's) may carry
    # no decode segments; their slot count rides the pinned meta
    buckets = src.decode_buckets
    n_slots = int(src.meta.get("n_slots", 0)) \
        or (max(buckets) if buckets else 1)
    camp = Campaign(chip, seed=seed, n_reps=n_reps)
    tables = dict(tables or {})

    def target_table(seg):
        if seg.scope == "serve-decode" and seg.bucket in tables:
            return tables[seg.bucket]
        builder = WorkloadBuilder(
            cfg, prefill_shape if seg.scope == "serve-prefill"
            else decode_shape, tp=tp, dp=dp,
            batch_override=None if seg.scope == "serve-prefill"
            else int(seg.bucket))
        return camp.run(builder.build())

    segments = []
    for seg in src.segments:
        table = target_table(seg)
        src_pairs = seg.to_phase_plan().kernel_clock_pairs()
        by_name = {k.name: p for k, p in zip(seg.kernels, src_pairs)}
        pair_idx = {(p.mem, p.core): i for i, p in enumerate(table.pairs)}
        mapped: List[int] = []
        n_repaired = n_unmatched = 0
        for i, k in enumerate(table.kernels):
            pair = by_name.get(k.name)
            if pair is None and i < len(src_pairs):
                pair = src_pairs[i]          # same builder, same order
            if pair is None:
                n_unmatched += 1
                mapped.append(table.auto_idx)
                continue
            snapped = (_snap_clock(pair[0], src_chip, chip, "mem"),
                       _snap_clock(pair[1], src_chip, chip, "core"))
            mapped.append(pair_idx.get(snapped, table.auto_idx))
        vocab = sorted(set(mapped) | {table.auto_idx})
        kchoice: List[int] = []
        for i, ci in enumerate(mapped):
            auto_t = table.time[i, table.auto_idx]
            if table.time[i, ci] > (1.0 + tau) * repair_margin * auto_t:
                n_repaired += 1
                feas = [c for c in vocab
                        if table.time[i, c] <= (1.0 + tau) * auto_t]
                ci = min(feas, key=lambda c: table.energy[i, c]) if feas \
                    else table.auto_idx
            kchoice.append(ci)
        seq = expand_sequence(table)
        choice_seq = np.array([kchoice[ki] for ki in seq], dtype=np.int32)
        cp = CoalescedPlan(choice_seq=choice_seq, sequence=seq,
                           table=table,
                           switch_latency_s=chip.switch_latency_s,
                           switch_energy_j=chip.switch_latency_s
                           * SWITCH_POWER_W)
        sched = schedule_from_coalesced(
            cp, meta={"phase": seg.name,
                      "transferred_from_chip": src.chip_name,
                      "n_kernels": len(table.kernels),
                      "n_repaired": n_repaired,
                      "n_unmatched": n_unmatched})
        segments.append(PlanSegment(
            name=seg.name, schedule=sched, kernels=table.kernels,
            granularity="kernel", scope=seg.scope, bucket=seg.bucket))
    md = dict(src.meta)
    md.update({"transferred": True, "transfer_src_chip": src.chip_name,
               "n_slots": n_slots})
    return DvfsPlan(chip_name=chip.name, kind="serve", segments=segments,
                    meta=md)
