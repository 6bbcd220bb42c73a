"""Serving example: continuous batching + executed phase-aware DVFS +
online re-planning, all through the ``repro_torch.dvfs`` facade.

Decode workloads are HBM-bound (weight + KV-cache streaming), so the
waste planner finds much deeper core-clock reductions than in training —
the paper's §11 inference outlook, made concrete.  One
:class:`~repro_torch.dvfs.DvfsSession` plans every serving phase (prefill
plan + decode plans keyed by active-slot bucket) of the full llama3.2-1b
on ``--chip``'s model (``h100`` by default; the JAX package's example uses
``tpu-v5e``) and the engine *executes* the plan through the session's
governor executor at every phase transition.

The model the engine serves depends on ``--device``.  On ``cpu``, the JAX
package example's: llama3.2-1b's smoke config in float32 behind a dense
cache, on the kernels' plain versions.  On the card (``cuda``, the
default; it raises without one), the config the session planned: the full
llama3.2-1b in bf16 behind bf16 pages (as ``launch/serve.py`` serves it),
where the port's kernels run: ``paged_flash_decode``,
``flash_attention_fwd`` and ``rmsnorm_rows``.  They are built for the full
widths only, and a dense cache would decode in plain PyTorch.  Both serve
the same 4 slots, ``max_seq`` 96 (6 pages of 16) and 10 seeded requests;
weights are random from a seeded ``torch.Generator``.

The second half shows the :class:`~repro_torch.dvfs.OnlineGovernor`: the
same plan under a drifted traffic mix strands time budget; the governor
detects the bucket-mix drift from runtime feedback, re-plans the decode
segments jointly over the observed mix (off the hot path), and recovers
the stranded energy.  It is host only.

Every time and energy in the plan and executed lines is modeled on the
chip model; the one line marked "on this host" is a wall-clock reading.

Run:  python -m repro_torch.examples.serve_dvfs [--chip h100]
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import REGISTRY, smoke_config
from ..configs.base import ShapeConfig
from ..core import (Campaign, WastePolicy, WorkloadBuilder, compile_phase,
                    decode_slot_buckets)
from ..dvfs import (DvfsPlan, DvfsSession, OnlineGovernor, PlanSegment,
                    ServeGovernorExecutor, StaticPlanGovernor,
                    plan_decode_joint)
from ..models import build_model
from ..serve import Request, ServeEngine
from ._common import HOST_MARK, Printer, add_chip_flag

SLOTS = 4
TAU = 0.005
MAX_SEQ = 96


def main(argv: Optional[List[str]] = None) -> Dict:
    """Plan, serve, re-plan; returns the printed ``lines``, the plan's rows
    by phase (``plan``) and its ``path``, the served ``requests``, the
    engine's prefill calls and decode steps, the session's serve
    ``executor`` and its executed totals (``executed``), the served
    ``tokens`` and their host ``seconds``, and the online and stale
    executors' totals (``online``, ``stale``)."""
    ap = argparse.ArgumentParser()
    add_chip_flag(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cpu: the reference's "
                         "smoke model on the kernels' plain versions)")
    ap.add_argument("--plan-out",
                    default="artifacts/torch_serve_phase_bundle.json")
    args = ap.parse_args(argv)
    out = Printer()
    out.chip(args.chip)

    full = REGISTRY["llama3.2-1b"]
    on_card = torch.device(args.device).type != "cpu"
    if on_card:
        cfg = full
        model = build_model(cfg, block_k=64, device=args.device)
    else:
        cfg = dataclasses.replace(smoke_config(full), compute_dtype="float32")
        model = build_model(cfg, block_k=16, device=args.device)

    # --- offline: one session plans every serving phase -----------------
    prefill = ShapeConfig(name="serve_prefill", seq_len=512,
                          global_batch=1, kind="prefill")
    decode = ShapeConfig(name="serve_decode", seq_len=512,
                         global_batch=SLOTS, kind="decode")
    sess = DvfsSession(chip=args.chip, tau=TAU, n_reps=10)
    plan = sess.plan_serve(full, n_slots=SLOTS, prefill_shape=prefill,
                           decode_shape=decode)
    plan.save(args.plan_out)
    rows = plan.summary()["phases"]
    out("planned phases (governor=kernel-static):")
    for name, row in rows.items():
        out(f"  {name:10s} time {row['time_pct']:+7.3f}%  "
            f"energy {row['energy_pct']:+8.3f}%  "
            f"switches/step {row['n_switches']}")

    # --- online: continuous-batching engine executes the plan -----------
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init(gen)
    executor = sess.serve_executor()
    engine = ServeEngine(model, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                         executor=executor, paged=on_card)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               rng.integers(4, 12)),
                    max_new_tokens=int(rng.integers(4, 24)))
            for i in range(10)]
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(reqs)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for r in reqs[:3]:
        out(f"req {r.uid}: prompt[{len(r.prompt)}] -> "
            f"{len(r.generated)} tokens, done at step {r.finished_step}")
    n_tok = sum(len(r.generated) for r in reqs)
    out(f"served {n_tok} tokens in {seconds:.3f} s "
        f"({n_tok / seconds:.1f} tokens/s {HOST_MARK}, the first call of "
        f"each shape included)")

    tot = engine.energy_summary()["totals"]
    out(f"executed: {tot['steps']} phase steps, "
        f"{tot['n_switches']} clock switches, "
        f"time {tot['time_pct']:+.4f}% vs auto, "
        f"energy {tot['energy_pct']:+.3f}% vs auto")
    sess.close()

    # --- the online governor on a drifted traffic mix -------------------
    chip = sess.chip
    policy = WastePolicy(0.01)
    camp = Campaign(chip, seed=0, n_reps=5)
    tables = {b: camp.run(WorkloadBuilder(full, decode,
                                          batch_override=b).build())
              for b in decode_slot_buckets(SLOTS)}
    planned_mix = {1: 0.30, 2: 0.30, 4: 0.40}
    drift = [1] * 2 + [2] * 13 + [4]       # observed mix ~ {.12,.81,.06}

    def serve_plan(mix):
        segs = plan_decode_joint(tables, mix, chip, policy)
        pre = PlanSegment.from_phase_plan(
            compile_phase(tables[1], "prefill", chip, policy),
            scope="serve-prefill")
        return DvfsPlan(chip_name=chip.name, kind="serve",
                        segments=[pre] + segs,
                        meta={"decode_mix": dict(mix)})

    gov = OnlineGovernor(serve_plan(planned_mix), policy=policy,
                         chip=chip, tables=tables, window=32)
    online = ServeGovernorExecutor(gov, chip)
    stale = ServeGovernorExecutor(
        StaticPlanGovernor(serve_plan(planned_mix)), chip)
    for i in range(320):
        online.on_decode(drift[i % len(drift)])
        stale.on_decode(drift[i % len(drift)])
    online.finish(), stale.finish()
    ev = gov.events[-1]
    out(f"\nonline governor: re-planned at revision {gov.revision} "
        f"({ev['reason']})")
    on, st = online.summary()["totals"], stale.summary()["totals"]
    out(f"  stale plan : time {st['time_pct']:+.4f}%  "
        f"energy {st['energy_pct']:+.4f}%")
    out(f"  online     : time {on['time_pct']:+.4f}%  "
        f"energy {on['energy_pct']:+.4f}%  "
        f"(recovered {st['energy_j'] - on['energy_j']:.3f} J of "
        f"stranded budget on the drifted mix)")
    return {"lines": out.lines, "plan": rows, "path": args.plan_out,
            "requests": reqs, "n_prefill_calls": engine.n_prefill_calls,
            "n_decode_steps": engine.n_decode_steps, "executor": executor,
            "executed": tot, "tokens": n_tok, "seconds": seconds,
            "online": on, "stale": st}


if __name__ == "__main__":
    main()
