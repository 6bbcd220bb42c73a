#!/usr/bin/env python3
"""Time one source tree's kernels of the PyTorch port on the card, with
``chip_smoke.py``'s timing helpers and shapes.

    python3 tools/torch_kernel_ab.py [--src DIR] [--label NAME]
                                     [--keys-per-split 64,128,256]
                                     [--rows ssd_scan,mamba_prefill,...]

``DIR`` is a tree's ``src`` directory (default: this checkout's).  Its
``repro_torch`` is imported and its kernels are built into ``DIR/../build``,
so an older commit unpacked with ``git archive`` into a git-ignored
directory times its own kernels beside this tree's.  Run the two in one
call, in turns (old, new, new, old), to compare them on one card.  With
``--keys-per-split`` the paged decode rows are timed once per split size,
through the wrapper's ``launch_split`` (trees that have it).  Prints one
JSON line per row, with the times of ``chip_smoke.both_times`` (host in
the loop and device time): the paged decode kernel at the serving
positions (16..1000) and at the profile run's short contexts (128..160),
bf16 and int8 pools, beside SDPA over the pages in use; RMSNorm at
(4096, 2048), (4096, 1024) and (8, 2048) beside ``F.rms_norm``; the SSD
scan at the serving shape (B 8, S 512, H 32, P 64, G 1, N 128, chunk 256),
through the tree's own ``ssd_scan`` wrapper; the wall ms of one
mamba2-370m prefill call of 8 rows x 512 (random weights from a seed);
and ``chip_smoke.py``'s mamba2-370m serve phase (tokens/s with a dense and
a paged cache, the prefill call again, a profiled run; logged).
``--rows`` picks some of them (default: all).  Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts ROOT/src on the path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--keys-per-split", default="")
    ap.add_argument("--rows", default=",".join(ROWS))
    args = ap.parse_args(argv)
    rows = args.rows.split(",")
    unknown = set(rows) - set(ROWS)
    if unknown:
        raise SystemExit(f"unknown rows {sorted(unknown)}; known: {ROWS}")
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import paged
    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise SystemExit(f"repro_torch imported from {repro_torch.__file__}, "
                         f"not from {src}")
    smi = cs.phase_device()
    info = _build.build_info()
    cs.log(f"[ab] {args.label}: kernels of {src} built at {info['path']} in "
           f"{info['seconds']:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def emit(rec):
        rec.update(label=args.label, card=smi)
        print(json.dumps(rec), flush=True)

    def split_decode(kps):
        """The decode kernel at ``kps`` keys a split (None: the wrapper)."""
        if kps is None:
            return None
        return lambda q, k, v, t, p, k_scales=None, v_scales=None: \
            paged.launch_split(q, k, v, t, p, 0, 0.0, k_scales, v_scales, kps)

    splits = [int(k) for k in args.keys_per_split.split(",") if k]
    for kps in (splits or [None]) if "paged_decode" in rows else []:
        for dtype, pool in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            for name, positions in (("serving", cs.SERVE_POS),
                                    ("short", cs.PROFILE_POS)):
                case = cs._paged_case(gen, dtype, positions)
                t = cs.paged_timings(case, decode=split_decode(kps))
                emit({"kernel": "paged_decode", "pool": pool,
                      "positions": name, "keys_per_split": kps, **t,
                      "bound_ms": cs._paged_bound(case)[0],
                      "bytes": cs._paged_work(case)[0],
                      "library_bytes": cs._paged_library_bytes(case)})
                del case
    for n, d in ((cs.SERVE_SLOTS * 512, 2048), (cs.SERVE_SLOTS * 512, 1024),
                 (cs.SERVE_SLOTS, 2048)) if "rmsnorm" in rows else ():
        t, _ = cs.rmsnorm_timings(gen, n, d)
        emit({"kernel": "rmsnorm", "shape": [n, d], **t,
              "bound_ms": cs.bound(2 * n * d * 2 + d * 4, 4 * n * d,
                                   "f32")[0]})
    if "ssd_scan" in rows:
        _, shape, chunk = cs.SSD_CASES[0]
        t = cs.ssd_timings(gen, shape, chunk)
        emit({"kernel": "ssd_scan", "shape": shape, "chunk": chunk, **t,
              "bound_ms": cs.bound(t["bytes"], t["ops"], "bf16")[0]})
    if {"mamba_prefill", "mamba_serve"} & set(rows):
        cfg, model, params = cs.build_mamba_model()
        if "mamba_prefill" in rows:
            t = cs.mamba_prefill_ms(cfg, model, params,
                                    np.random.default_rng(0), repeats=5)
            emit({"kernel": "mamba_prefill", "rows": cs.SERVE_SLOTS,
                  "bucket": 512, **t})
        if "mamba_serve" in rows:
            cs.phase_serve_ssm(cfg, model, params)
    return 0


ROWS = ("paged_decode", "rmsnorm", "ssd_scan", "mamba_prefill",
        "mamba_serve")


if __name__ == "__main__":
    sys.exit(main())
