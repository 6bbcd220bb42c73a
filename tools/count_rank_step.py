"""One rank's training step of a configuration on a (data, model) mesh,
counted on fake tensors on the host's CPU (``hw.step_count.
count_train_step``): its resident bytes (f32 masters, AdamW moments, its
rows of the batch), the peak of the bytes its step allocates beyond them
(the plain path's, which bounds the kernels' from above), FLOPs and
collective bytes.  Nothing runs on a device; no card is needed.

    PYTHONPATH=src python -m tools.count_rank_step --arch nemotron-4-340b \\
        --layers 1 --rows 8 --seq 1024 --mesh 2x2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def count(arch: str, layers: int, rows: int, seq: int, dp: int, tp: int):
    """The counted step as a dict of bytes, GiB, FLOPs and wire bytes."""
    from repro_torch.configs import get_config
    from repro_torch.hw.step_count import count_train_step
    from repro_torch.launch.mesh import MeshSpec
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    c = count_train_step(cfg, global_batch=rows, seq_len=seq,
                         mesh=MeshSpec(dp=dp, tp=tp))
    return {"arch": arch, "layers": layers, "rows": rows, "seq": seq,
            "mesh": [dp, tp], "params": cfg.param_count()[0],
            "resident_bytes": c.resident_bytes,
            "transient_bytes": c.peak_bytes,
            "peak_gib": (c.resident_bytes + c.peak_bytes) / 2**30,
            "flops": c.flops, "wire": c.collective_bytes}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--layers", type=int, required=True)
    p.add_argument("--rows", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--mesh", default="2x2", help="data x model")
    a = p.parse_args(argv)
    dp, tp = (int(x) for x in a.mesh.split("x"))
    print(json.dumps(count(a.arch, a.layers, a.rows, a.seq, dp, tp)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
