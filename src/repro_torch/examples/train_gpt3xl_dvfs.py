"""End-to-end training example: GPT-3-xl-family model + executed
kernel-level DVFS.

Trains a GPT-3 on the synthetic corpus with the fault-tolerant Trainer
(checkpoint/restart, straggler watchdog) while a
:class:`~repro_torch.dvfs.DvfsSession` executor *executes* the planned
fwd/bwd/opt clock schedules around every step — per-phase frequency
actuation plus exact per-phase energy accounting vs the auto governor,
both modeled on ``--chip``'s model (``h100`` by default; the JAX package's
example uses ``tpu-v5e``).  An injected failure exercises the restart path,
including mid-plan resume of the executor's books; the unified ``DvfsPlan``
IR is saved to ``artifacts/torch_train_plan_bundle.json``.

The model trains on ``--device``: the card by default (it raises without
one), where the step runs the port's flash forward (with its log-sum-exp)
and flash backward (gpt3-xl's LayerNorm launches no kernel); ``cpu`` runs
the kernels' plain versions.  ``--full`` is the true gpt3-xl (1.42B
parameters, 24 layers, vocab 50257), sized for the card: ``--full --seq
1024 --batch 16`` takes two micro-batches of 8 x 1024 a step.  Without it,
a reduced GPT-3 as the reference trains it.

Run:  python -m repro_torch.examples.train_gpt3xl_dvfs \\
          [--steps 60] [--d-model 256] [--layers 4] [--full] [--chip h100]
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
from typing import Dict, List, Optional

from ..ckpt import CheckpointManager
from ..configs import get_config, get_shape
from ..data import DataPipeline
from ..dvfs import DvfsSession
from ..models import build_model
from ..runtime import FailureInjector
from ..train import OptimizerConfig, make_train_step
from ..train.loop import Trainer, TrainerConfig
from ._common import Printer, add_chip_flag


def main(argv: Optional[List[str]] = None) -> Dict:
    """Plan, train through a failure, report; returns the printed
    ``lines``, the plan's rows by phase (``plan``) and its ``path``, the
    trainer's result (``done``), its per-step ``history``, the session's
    train ``executor`` and the parameter count (``params``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/torch_train_gpt3xl")
    ap.add_argument("--fail-at", type=int, default=25,
                    help="inject a failure at this step (FT drill)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from existing checkpoints (default: fresh)")
    add_chip_flag(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cpu: plain kernels)")
    ap.add_argument("--plan-out",
                    default="artifacts/torch_train_plan_bundle.json")
    args = ap.parse_args(argv)
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    out = Printer()
    out.chip(args.chip)

    cfg = get_config("gpt3-xl")
    if not args.full:
        cfg = dataclasses.replace(
            cfg, n_layers=args.layers, d_model=args.d_model,
            d_ff=4 * args.d_model, n_heads=8, n_kv_heads=8, head_dim=0,
            vocab_size=args.vocab, max_train_seq=args.seq)
    # the port raises here, before planning, when the device is missing
    model = build_model(cfg, block_k=64, device=args.device)
    total, _ = cfg.param_count()
    out(f"model: {total/1e6:.1f}M params")

    # --- DVFS plan for this training iteration (repro_torch.dvfs facade) ---
    shape = dataclasses.replace(get_shape("paper_gpt3xl"),
                                seq_len=args.seq,
                                global_batch=args.batch)
    session = DvfsSession(chip=args.chip, tau=0.006, n_reps=5)
    plan = session.plan_train(cfg, shape=shape)
    plan.save(args.plan_out)
    rows = plan.summary()["phases"]
    for ph, row in rows.items():
        out(f"  {ph:4s} plan: {row['energy_pct']:+7.2f}% energy at "
            f"{row['time_pct']:+6.2f}% time "
            f"({row['n_switches']} switches)")

    # --- fault-tolerant training with executed DVFS ---
    step = make_train_step(model, OptimizerConfig(lr=3e-3, warmup_steps=10,
                                                  decay_steps=args.steps),
                           accum_steps=2, remat=False)
    pipeline = DataPipeline(vocab_size=cfg.vocab_size,
                            batch_per_host=args.batch, seq_len=args.seq)
    executor = session.train_executor()
    trainer = Trainer(
        model, step, pipeline,
        CheckpointManager(args.ckpt_dir, keep=2),
        TrainerConfig(total_steps=args.steps, ckpt_every=10, log_every=10),
        executor=executor,
        failure_injector=FailureInjector(
            [args.fail_at] if args.fail_at >= 0 else []))
    try:
        done = trainer.run()
    finally:
        # hand the chip back to the auto governor even when a step dies
        session.close()

    first = trainer.history[0]["loss"]
    last = trainer.history[-1]["loss"]
    out(f"loss {first:.3f} -> {last:.3f} over {done['final_step']} steps "
        f"({done['restarts']} restart(s) from injected failures)")
    tot = done["dvfs"]["totals"]
    out(f"executed DVFS: {tot['energy_pct']:+.2f}% energy at "
        f"{tot['time_pct']:+.2f}% time vs auto "
        f"({tot['n_switches']} clock switches over "
        f"{tot['steps']} phase executions)")
    return {"lines": out.lines, "plan": rows, "path": args.plan_out,
            "done": done, "history": trainer.history, "executor": executor,
            "params": total}


if __name__ == "__main__":
    main()
