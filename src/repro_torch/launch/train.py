"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> ...``

The counterpart of the JAX package's ``launch/train.py``, with its flags
and printed lines: builds the model from the registry, plans the
per-phase DVFS schedule through a :class:`~repro_torch.dvfs.DvfsSession`
with the chosen governor (on the ``h100`` chip model unless ``--chip``
names another), and drives the fault-tolerant :class:`Trainer` with the
session's executor replaying (and metering) the plan around every step.
The model trains on ``--device`` (the card by default; ``cpu`` runs the
kernels' plain versions); ``--smoke`` runs the reduced shape and the
reference's reduced config on the CPU, on the card, whose kernels are not
built for those widths, :func:`~repro_torch.configs.card_smoke_config`.
:func:`main` returns what it printed.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import torch

from ..ckpt import CheckpointManager
from ..configs import (card_smoke_config, get_config, get_shape,
                       smoke_config, smoke_shape)
from ..data import DataPipeline
from ..dvfs import DvfsSession
from ..models import build_model
from ..obs import Tracer
from ..train import OptimizerConfig, make_train_step
from ..train.loop import Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> Dict:
    """Plan, train and report; returns the plan rows by phase (``plan``,
    None with ``--dvfs off``), the trainer's result (``done``), its
    per-step history and the session's train executor (``executor``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config and shape (on the card: at its "
                         "kernels' widths)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cpu: plain kernels)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--chip", default="h100")
    ap.add_argument("--dvfs", choices=("off", "strict", "relaxed"),
                    default="strict")
    ap.add_argument("--governor", default="kernel-static",
                    help="repro_torch.dvfs governor registry name "
                         "(kernel-static | pass-level | edp | online)")
    ap.add_argument("--controller", default=None,
                    help="frequency-controller backend "
                         "(simulated | rate-limited)")
    ap.add_argument("--tau", type=float, default=0.01)
    ap.add_argument("--plan-out", "--schedule-out", dest="plan_out",
                    default=None,
                    help="save the planned DvfsPlan JSON here")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--trace-out", default=None,
                    help="record a Chrome/Perfetto-loadable telemetry "
                         "trace (repro_torch.obs schema) of the run here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = get_shape(args.shape)
    if args.smoke:
        cfg = (smoke_config if torch.device(args.device).type == "cpu"
               else card_smoke_config)(cfg)
        shape = smoke_shape(shape)
    # the port raises here, before planning, when the device is missing
    model = build_model(cfg, block_k=64, device=args.device)
    print(f"[train] {cfg.name} x {shape.name} "
          f"({cfg.param_count()[0]/1e6:.1f}M params)")

    # --- DVFS plan for this workload (campaign -> plan -> govern) ---
    session = None
    executor = None
    rows = None
    tracer = Tracer(meta={"launcher": "train", "arch": cfg.name,
                          "shape": shape.name, "chip": args.chip,
                          "governor": args.governor}) \
        if args.trace_out else None
    if args.dvfs != "off":
        tau = 0.0 if args.dvfs == "strict" else args.tau
        session = DvfsSession(chip=args.chip, tau=tau,
                              governor=args.governor,
                              controller=args.controller,
                              tracer=tracer)
        plan = session.plan_train(get_config(args.arch),
                                  shape=get_shape(args.shape))
        rows = plan.summary()["phases"]
        print(f"[train] DVFS plan ({args.dvfs}, {args.governor}): " +
              "  ".join(f"{ph}: {row['energy_pct']:+.2f}%e/"
                        f"{row['time_pct']:+.2f}%t"
                        for ph, row in rows.items()))
        if args.plan_out:
            plan.save(args.plan_out)
            print(f"[train] plan -> {args.plan_out}")
        executor = session.train_executor()

    step = make_train_step(
        model, OptimizerConfig(lr=args.lr, decay_steps=args.steps),
        accum_steps=args.accum, remat=True,
        compress=args.compress_grads)
    pipeline = DataPipeline(vocab_size=cfg.vocab_size,
                            batch_per_host=shape.global_batch,
                            seq_len=shape.seq_len)
    ckpt_dir = args.ckpt_dir or f"artifacts/train_{cfg.name}"
    trainer = Trainer(model, step, pipeline,
                      CheckpointManager(ckpt_dir, keep=3),
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every),
                      executor=executor)
    try:
        out = trainer.run()
    finally:
        # always hand the chip back to the auto governor, even when the
        # run dies mid-step — a real driver must not stay pinned low
        if session is not None:
            session.close()
    if tracer is not None:
        print(f"[train] telemetry trace ({len(tracer.events)} events) "
              f"-> {tracer.save(args.trace_out)}")
    print(f"[train] done: {json.dumps(out, default=float)}")
    return {"plan": rows, "done": out, "history": trainer.history,
            "executor": executor}


if __name__ == "__main__":
    main()
