#!/usr/bin/env python3
"""Time one source tree's paged-decode and RMSNorm kernels of the PyTorch
port on the card, with ``chip_smoke.py``'s timing helpers and shapes.

    python3 tools/torch_kernel_ab.py [--src DIR] [--label NAME]
                                     [--keys-per-split 64,128,256]

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
bf16 and int8 pools, beside SDPA; RMSNorm at (4096, 2048), (4096, 1024)
and (8, 2048) beside ``F.rms_norm``.  Needs CUDA.
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
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
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
    for kps in splits or [None]:
        for dtype, pool in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            for name, positions, full in (
                    ("serving", cs.SERVE_POS, True),
                    ("short", cs.PROFILE_POS, False)):
                case = cs._paged_case(gen, dtype, positions)
                t = cs.paged_timings(case, full_table=full,
                                     decode=split_decode(kps))
                emit({"kernel": "paged_decode", "pool": pool,
                      "positions": name, "keys_per_split": kps, **t,
                      "bound_ms": cs._paged_bound(case)[0]})
                del case
    for rows, d in ((cs.SERVE_SLOTS * 512, 2048), (cs.SERVE_SLOTS * 512, 1024),
                    (cs.SERVE_SLOTS, 2048)):
        t, _ = cs.rmsnorm_timings(gen, rows, d)
        emit({"kernel": "rmsnorm", "shape": [rows, d], **t,
              "bound_ms": cs.bound(2 * rows * d * 2 + d * 4, 4 * rows * d,
                                   "f32")[0]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
