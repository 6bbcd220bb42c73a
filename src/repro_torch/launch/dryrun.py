"""Dry run of every (arch x shape x mesh) cell on fake ranks.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  Where
the reference lowers and compiles each cell's step on the 16x16 and
2x16x16 production meshes and reads the compiled artifact's memory and
cost analyses, the port runs one rank's step once on fake CPU tensors
(``hw.step_count``) under a ``fake`` process group of the mesh's size,
on ``launch.mesh.make_production_mesh``'s mesh: the rank's sharded train
step (``pick_accum``'s micro-batches, remat), its sharded prefill or its
sharded decode step (``parallel.serve_step.ShardedServe``).  It touches
no device and imports no JAX.  Rank 0 stands for every rank: the rules
split a dim only where it divides, so every rank's blocks have rank 0's
shapes.

Each cell's record goes to ``artifacts/dryrun_torch/`` (never beside the
reference's ``artifacts/dryrun/``), with the reference's keys where their
meaning carries over: ``arch``, ``shape``, ``mesh``, ``n_devices``,
``kind``, ``accum_steps``, ``bytes_per_device`` and ``gib_per_device``
(the rank's resident bytes, exact from the specs, plus the plain path's
peak transient, see ``hw.step_count``), ``collectives`` (wire bytes by
kind and ``total_bytes``) and ``status``; the count under ``count``
(``flops_per_device``: the matrix products' FLOPs; ``hbm_bytes_per_device``:
the eager path's operand and result bytes), and ``fits`` against one
H100's 80 GB (``hw.h100.HBM_BYTES``).  Every figure is counted on the
host's CPU, none measured on a card.

Statuses: ``ok``; ``skipped`` with ``cell_is_runnable``'s reason;
``not_ported`` for the SSM, hybrid and encoder-decoder cells, whose
sharded step, prefill and decode are ROADMAP queue 1's next item;
``error`` with the exception.  ``--all`` exits non-zero while any cell is
``error`` or ``not_ported``, so nothing is hidden.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional

from ..configs import all_cells, cell_is_runnable, get_config, get_shape
from ..hw import h100
from ..hw.step_count import (count_decode, count_prefill, count_train_step,
                             fake_world)
from ..models import build_model
from ..parallel.collectives import KINDS
from ..parallel.sharding import data_axes, mesh_axes
from ..parallel.train_step import FAMILIES
from .mesh import MeshSpec, make_production_mesh

#: where a family not in ``FAMILIES`` stands
NOT_PORTED = ("the {family} family's sharded step, prefill and decode are "
              "ROADMAP queue 1's next item")


def production_spec(multi_pod: bool) -> MeshSpec:
    """The extents of ``make_production_mesh(multi_pod=...)``."""
    return MeshSpec(dp=16, tp=16, pod=2 if multi_pod else 1)


def production_world(multi_pod: bool):
    """A fake world of the production mesh's size holding
    ``make_production_mesh``'s mesh (a context manager)."""
    return fake_world(production_spec(multi_pod),
                      make=lambda: make_production_mesh(multi_pod=multi_pod,
                                                        device_type="cpu"))


def pick_accum(cfg, shape, mesh) -> int:
    """Grad-accumulation depth: bound per-device live microbatch.

    With the sequence-parallel residual stream the saved activations are
    model-sharded, so even the largest archs afford microbatch 2/device --
    halving the per-step FSDP all-gather + grad reduce-scatter rounds."""
    sizes = mesh_axes(mesh)
    dp = math.prod(sizes[a] for a in data_axes(mesh))
    per_dev = max(shape.global_batch // dp, 1)
    micro_per_dev = min(2, per_dev) if cfg.d_model >= 4096 \
        else min(4, per_dev)
    return max(per_dev // micro_per_dev, 1)


def _tag(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def count_cell(arch: str, shape_name: str, multi_pod: bool = False,
               mesh=None) -> Dict[str, Any]:
    """The record of one cell: one rank's step counted on fake tensors on
    the production mesh (``mesh``, a ``DeviceMesh`` of a fake world the
    caller holds open, or a fake world of its own)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": _tag(multi_pod),
                "status": "skipped", "reason": why}
    spec = production_spec(multi_pod)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": spec.n_devices, "kind": shape.kind,
    }
    if cfg.family not in FAMILIES:
        rec.update(status="not_ported",
                   reason=NOT_PORTED.format(family=cfg.family))
        return rec
    t0 = time.time()
    inputs = build_model(cfg, device="cpu").input_specs(shape)
    world = production_world(multi_pod) if mesh is None else None
    dmesh = world.__enter__() if world is not None else mesh
    try:
        if shape.kind == "train":
            accum = pick_accum(cfg, shape, spec)
            rec["accum_steps"] = accum
            count = count_train_step(cfg, inputs=inputs, accum_steps=accum,
                                     mesh=dmesh)
        elif shape.kind == "prefill":
            count = count_prefill(cfg, inputs, dmesh)
        else:
            count = count_decode(cfg, inputs, dmesh)
    finally:
        if world is not None:
            world.__exit__(None, None, None)
    live = count.resident_bytes + count.peak_bytes
    rec["resident_bytes"] = int(count.resident_bytes)
    rec["peak_transient_bytes"] = int(count.peak_bytes)
    rec["bytes_per_device"] = int(live)
    rec["gib_per_device"] = round(live / 2 ** 30, 3)
    rec["fits"] = bool(live <= h100.HBM_BYTES)
    rec["count"] = {"flops_per_device": count.flops,
                    "hbm_bytes_per_device": count.hbm_bytes}
    wire = {k: float(count.collective_bytes.get(k, 0.0)) for k in KINDS}
    wire["total_bytes"] = float(sum(wire.values()))
    rec["collectives"] = wire
    rec["status"] = "ok"
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _out_path(outdir: str, arch: str, shape_name: str,
              multi_pod: bool) -> str:
    safe = arch.replace(".", "_")
    return os.path.join(outdir, f"{safe}__{shape_name}__{_tag(multi_pod)}"
                                f".json")


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             mesh=None) -> Dict[str, Any]:
    """:func:`count_cell`, its record written to ``outdir``; an exception
    becomes an ``error`` record (a failure here is a bug in the port)."""
    try:
        rec = count_cell(arch, shape_name, multi_pod=multi_pod, mesh=mesh)
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": _tag(multi_pod),
               "status": "error", "error": repr(e),
               "traceback": traceback.format_exc()[-2000:]}
    os.makedirs(outdir, exist_ok=True)
    with open(_out_path(outdir, arch, shape_name, multi_pod), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _line(rec: Dict[str, Any]) -> str:
    head = f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s}"
    st = rec["status"]
    if st == "ok":
        return (f"[dryrun] OK    {head} {rec['gib_per_device']:8.2f} GiB/dev"
                f"{'' if rec['fits'] else ' (does not fit)'}  "
                f"flops={rec['count']['flops_per_device']:.3e}  "
                f"coll={rec['collectives']['total_bytes']:.3e}B  "
                f"({rec['total_s']}s)")
    if st == "error":
        return f"[dryrun] ERROR {head} {rec['error']}"
    return f"[dryrun] {st.upper():5s} {head} {rec['reason']}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--include-paper", action="store_true",
                    help="also run gpt3-xl at the paper shape")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, sname) for arch, sname, _, _ in
                 all_cells(include_skipped=True)]
        if args.include_paper:
            cells.append(("gpt3-xl", "paper_gpt3xl"))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if args.all and not args.single_pod_only or args.multi_pod \
            or args.multi_pod_only:
        meshes.append(True)
    if args.multi_pod and not args.all:
        meshes = [True]

    counts = {"ok": 0, "skipped": 0, "not_ported": 0, "error": 0}
    for mp in meshes:
        todo = [(a, s) for a, s in cells if not (
            args.skip_existing and os.path.exists(
                _out_path(args.out, a, s, mp)))]
        for a, s in cells:
            if (a, s) not in todo:
                print(f"[dryrun] SKIP(existing) {a} {s} {_tag(mp)}",
                      flush=True)
        if not todo:
            continue
        # one fake world a mesh, every cell of it counted inside
        with production_world(mp) as dmesh:
            for arch, sname in todo:
                rec = run_cell(arch, sname, mp, args.out, mesh=dmesh)
                counts[rec["status"]] += 1
                print(_line(rec), flush=True)
    print(f"[dryrun] done: {counts['ok']} ok, {counts['skipped']} skipped, "
          f"{counts['not_ported']} not ported, {counts['error']} errors",
          flush=True)
    return 1 if counts["error"] or counts["not_ported"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
