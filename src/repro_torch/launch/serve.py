"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--arch <id> ...``

The counterpart of the JAX package's ``launch/serve.py``, with its flags
and printed lines: one :class:`~repro_torch.dvfs.DvfsSession` runs the
campaign, plans every serving phase of the full-size arch with the chosen
governor (on the ``h100`` chip model unless ``--chip`` names another), and
wires its executor into the port's :class:`ServeEngine`, which serves a
seeded synthetic request batch.  The model is built on ``--device`` (the
card by default; ``cpu`` runs the kernels' plain versions) with random
weights from a seeded ``torch.Generator``, and served from bf16 pages,
where the port's decode kernel runs.  ``--smoke`` reduces the config as the
reference does on the CPU; on the card, whose kernels are not built for
those widths, to :func:`~repro_torch.configs.card_smoke_config`.
:func:`main` returns what it printed.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import card_smoke_config, get_config, smoke_config
from ..configs.base import ShapeConfig
from ..dvfs import DvfsSession
from ..models import build_model
from ..obs import Tracer
from ..serve import Request, ServeEngine


def main(argv: Optional[List[str]] = None) -> Dict:
    """Plan, serve and report; returns the plan rows by phase (``plan``),
    the requests, tokens and seconds served, the executed totals
    (``executed``), the engine's prefill calls and decode steps, and the
    session's serve executor (``executor``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (on the card: at its kernels' "
                         "widths)")
    ap.add_argument("--chip", default="h100")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cpu: plain kernels)")
    ap.add_argument("--governor", default="kernel-static",
                    help="repro_torch.dvfs governor registry name")
    ap.add_argument("--tau", type=float, default=0.005)
    ap.add_argument("--trace-out", default=None,
                    help="record a Chrome/Perfetto-loadable telemetry "
                         "trace (repro_torch.obs schema) of the run here")
    args = ap.parse_args(argv)
    tracer = Tracer(meta={"launcher": "serve", "arch": args.arch,
                          "chip": args.chip,
                          "governor": args.governor}) \
        if args.trace_out else None

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = (smoke_config if torch.device(args.device).type == "cpu"
               else card_smoke_config)(cfg)
    # the port raises here, before planning, when the device is missing
    model = build_model(cfg, block_k=64, device=args.device)

    # offline: plan every serving phase of the full-size arch
    full = get_config(args.arch)
    pre = ShapeConfig(name="serve_prefill", seq_len=512, global_batch=1,
                      kind="prefill")
    dec = ShapeConfig(name="serve_decode", seq_len=512,
                      global_batch=args.slots, kind="decode")
    with DvfsSession(chip=args.chip, tau=args.tau,
                     governor=args.governor, tracer=tracer) as sess:
        plan = sess.plan_serve(full, n_slots=args.slots,
                               prefill_shape=pre, decode_shape=dec)
        rows = plan.summary()["phases"]
        for name, row in rows.items():
            print(f"[serve] {name:10s} plan: {row['energy_pct']:+7.3f}% "
                  f"energy at {row['time_pct']:+6.3f}% time "
                  f"({row['n_switches']} switches)")

        # online: the engine replays the plan through the session executor
        gen = torch.Generator(device=model.device)
        gen.manual_seed(0)
        params = model.init(gen)
        executor = sess.serve_executor()
        engine = ServeEngine(model, params, batch_slots=args.slots,
                             max_seq=128, executor=executor, tracer=tracer,
                             paged=True)
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(4, 16))),
                        max_new_tokens=args.max_new_tokens)
                for i in range(args.requests)]
        t0 = time.perf_counter()
        out = engine.generate(reqs)
        dt = time.perf_counter() - t0
        n_tok = sum(len(r.generated) for r in out)
        print(f"[serve] {len(out)} requests, {n_tok} tokens in {dt:.2f}s "
              f"({n_tok/dt:.1f} tok/s on this host)")
        tot = sess.report()["executed"][0]["totals"]
    if tracer is not None:
        print(f"[serve] telemetry trace ({len(tracer.events)} events) "
              f"-> {tracer.save(args.trace_out)}")
    print(f"[serve] executed ({args.governor}): "
          f"{tot['energy_pct']:+.3f}% energy at {tot['time_pct']:+.4f}% "
          f"time vs auto ({tot['n_switches']} switches)")
    return {"plan": rows, "requests": len(out), "tokens": n_tok,
            "seconds": dt, "executed": tot,
            "n_prefill_calls": engine.n_prefill_calls,
            "n_decode_steps": engine.n_decode_steps, "executor": executor}


if __name__ == "__main__":
    main()
