#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device      — needs CUDA; prints ``nvidia-smi``'s name and power limit.
2. build       — builds the CUDA kernels from ``src/repro_torch/kernels/csrc``,
                 logs ``ptxas``'s registers and spills, and counts the
                 HMMA/HGMMA instructions in the SASS (``cuobjdump``) of each
                 attention kernel and each SSD pass that runs a product:
                 none there fails the run; then each of zamba2-7b's
                 instantiations on its own line (registers, spills, HMMA),
                 its training backward's at head_dim 224 too.
3. kernels     — every kernel against its plain PyTorch version on the card,
                 in bf16, at the serving path's shapes; times the kernel, the
                 plain version and one PyTorch library call as a yardstick,
                 each cycling over input copies larger than L2, with the
                 host in the loop (CUDA events around the calls: ``ms``),
                 and the kernel and the library call again as device time
                 (the calls queued behind a sleep kernel: ``device_ms``),
                 and computes the kernel's bound from the bytes and
                 operations this run's inputs need (bytes over 3.35 TB/s or
                 operations over the peak rate of their type).
   graphs      — paged decode (bf16 and int8 pools) and the SSD scan (with
                 and without h0), which launch passes under PDL, replayed
                 from a CUDA graph: bitwise equal to an eager call.
   rmsnorm     — (4096, 2048), (4096, 1024) and (4096, 256) against the
                 plain version;
                 timed at both and at the decode shape (8, 2048) beside
                 ``F.rms_norm``, also as calls replayed from one CUDA graph
                 (``graph_ms``); a width it is not built for is refused.
   paged       — each pool (bf16, int8, fp8, f32) at the serving positions,
                 two calls bitwise equal; at split and page edges with a
                 slot parked at pos == max_seq, a window of 256 beginning
                 inside a split, softcap 50 and a single slot; timed beside
                 SDPA over the pages in use (the row records both sides'
                 bytes), also replayed from a CUDA graph (``graph_ms``);
                 bf16 and int8 also timed at the profile run's short
                 contexts.
   prefill     — the serving buckets 8, 32 (shorter than one 64-row tile),
                 128 and 512 with per-row valid lengths, and a local window
                 over padded rows with no valid key.
   flash_bwd   — the training path's kernels at its attention shape (B 4,
                 S 1024, H 32, KV 8, D 64, causal): the forward with its
                 log-sum-exp and the flash backward against their plain
                 versions, timed beside SDPA's forward and backward; two
                 backward calls bitwise equal; both again at S 200 (not a
                 multiple of the tile) and with G 1 (H == KV).  Then the
                 same at zamba2-7b's training attention (B 4, S 1024, H 32,
                 KV 32, D 224: the forward's log-sum-exp and the backward
                 built for it) and at S 200; its backward row
                 (``flash_bwd[D224]``) goes in the JSON.
   ssd_scan    — the Mamba2 SSD scan at the serving shape (B 8, S 512, H 32,
                 P 64, G 1, N 128, chunk 256), with an initial state, at
                 the prefill buckets 32 and 128, with G 2 over a ragged last
                 chunk and an initial state, with 3 heads a group, and with
                 chunk 16, against its plain version, each twice (bitwise
                 equal); no single PyTorch call computes it, so its row has
                 no library time.
   hybrid      — zamba2-7b's instantiations, each against its plain version
                 and twice (bitwise equal), timed with the host in the loop,
                 as device time and replayed from a CUDA graph, beside its
                 bound and yardstick: RMSNorm at (4096, 3584) and
                 (4096, 7168) (and 8 rows, logged) beside ``F.rms_norm``;
                 the prefill at head_dim 224 with one query head per KV
                 head over the buckets 32, 128 and 512 with ragged rows
                 and a window over rows with no valid key, beside SDPA (the
                 kernels SDPA picked are logged); paged decode at head_dim
                 224 on bf16 and int8 pools with the edges above, replayed
                 from a graph bitwise equal to eager; the SSD scan at B 8,
                 S 512, H 112, G 2, N 64 with and without h0 and at the
                 buckets 32 and 128, replayed from a graph likewise.
4. serve       — llama3.2-1b at full width (random weights from a seeded
                 generator) serves 16 requests through ``ServeEngine.generate``
                 with bf16 pages and with int8 pages, each with CUDA graphs
                 on and off in turns (``cuda_graphs``); then a dense cache
                 and a sampled run (temperature 0.8, seed 7), 8 requests,
                 graphs on and off.  Asserts equal tokens on and off, every
                 kernel's launch count (counted through graph replays), that
                 no logit is NaN and ``compile_stats`` within the
                 reference's bound; logs tokens/s, each capture's host ms
                 and the graphs' pool.
   profile     — a short bf16-page run under torch.profiler, graphs on and
                 off: wall and device ms a decode step, launches a step,
                 the device's idle share, the port's kernels' share.
5. consistency — prefill + paged decode steps against a longer prefill.
   serve_ssm   — mamba2-370m at full width and depth (random weights from a
                 seeded generator) serves the same 16 requests with a dense
                 and with a paged ``BatchState``, graphs on and off:
                 identical greedy tokens, exact launch counts (SSD scan per
                 layer and prefill call, RMSNorm twice per layer and once
                 more per forward, no attention kernel), no NaN logit; then
                 the bucket-512 prefill of 8 rows timed as one
                 ``model.prefill`` call and through the engine's memoized
                 prefill entry (graphs on and off: equal first tokens), and
                 a short profiled run in both modes.
   consistency_ssm — prefill of 300 positions (two chunks, the last ragged)
                 + decode steps against one longer prefill.
6. train       — llama3.2-1b at full width and depth trains 4 steps through
                 ``make_train_step`` (f32 masters, bf16 compute, AdamW,
                 remat, seq 1024, global batch 8 as 2 micro-batches of 4)
                 on the port's ``DataPipeline``; asserts finite losses,
                 a finite non-zero gradient for every parameter leaf after
                 the first backward, and exact launch counts per step.
7. trainer     — ``Trainer.run()`` at a small width (2 layers, d_model
                 256, bf16, head_dim 64) with an injected failure: it must
                 restart from its checkpoint and finish.
8. serve_hybrid — zamba2-7b at full width and depth (81 Mamba2 blocks, the
                 shared attention block 14 times; random weights from a
                 seeded generator, built after the other models are freed)
                 serves 8 requests of 24-498 prompt tokens, 32 new tokens
                 each, with bf16 pages (graphs on and off), int8 pages
                 (graphs on) and a dense cache (graphs on and off): equal
                 tokens with graphs on and off, exact launch counts (191
                 RMSNorms a forward, 81 SSD scans and 14 prefill attentions
                 a prefill call, 14 paged decodes a paged step), no NaN
                 logit; tokens/s, peak memory, the graph pool; the dense
                 and int8 runs' agreement with bf16 pages is logged; a
                 short profiled run in both modes, the decode steps alone.
   consistency_hybrid — the prefill of 300 positions and decode steps on a
                 dense cache and on bf16 pages, each against one longer
                 prefill.
9. ssd_grads   — the SSD scan's autograd Function (kernel forward, plain
                 f32 backward): gradients of x, a, B, C and h0 against plain
                 autograd on the same bf16 inputs at N 128, G 1 and N 64,
                 G 2 over a ragged last chunk with an initial state; then
                 the forward kernel and the plain backward timed at each
                 training phase's shape.
   train_ssm   — mamba2-370m at full width and depth (48 layers) trains as
                 the train phase does (same settings and gates; exact
                 RMSNorm and SSD launches a step); step ms, tokens/s, peak
                 memory, a profiled step's idle share and top kernels, and
                 the plain SSD backward's share of a step (computed from
                 its timed calls).
   train_hybrid — zamba2-7b at full width with 15 of its 81 layers (two
                 groups of 6, the 3-block tail, the shared block 3 times:
                 its full-depth f32 training state would not fit the card)
                 trains the same way, with exact RMSNorm, SSD, flash
                 forward and head_dim-224 flash backward launches a step.

Each phase's seconds are logged (``[time]``).

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# peak rates of one H100 SXM (data sheet, dense): memory bytes/s and ops/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_PAGE = 8, 1024, 16
SERVE_REQUESTS, SERVE_NEW_TOKENS = 16, 64
# zamba2-7b, the hybrid: 8 seeded requests of 24-498 prompt tokens, 32 new
# tokens each; its shared attention block's heads, KV heads and head_dim;
# its SSD scan's heads, groups and state
HYBRID_REQUESTS, HYBRID_NEW_TOKENS = 8, 32
HYBRID_ATTN = dict(H=32, KV=32, D=224)
HYBRID_SSD = dict(H=112, G=2, N=64)
# training: seq 1024, global batch 8 as accum 2 micro-batches of 4, 4 steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 1024, 8, 2, 4
TRAIN_H, TRAIN_KV, TRAIN_D = 32, 8, 64
# zamba2-7b trains at full width with its depth cut to 15 of 81 layers (two
# groups of 6, the 3-block tail, the shared block applied 3 times): at 81
# layers its f32 masters, gradients and AdamW moments (16 bytes a
# parameter, 6.917 B parameters) would need ~111 GB, more than the card's
# 80 GB; at 15, 1.74 B parameters, ~28 GB (~35 GB with a micro-batch's f32
# gradients beside the accumulated ones)
HYBRID_TRAIN_LAYERS = 15
LSE_TOL = 1e-3         # forward log-sum-exp, absolute
BWD_TOL = 2e-2         # dq, dk, dv, relative to each one's largest |value|
ATTN_TOL = 2e-2        # bf16 attention, as tests/test_kernels.py uses
RMS_RTOL = 1e-2        # RMSNorm, relative (one bf16 ulp is 2**-8)
CONSISTENCY_TOL = 5e-2  # prefill vs decode logits, relative to max |logit|
# SSD scan: y relative to its largest |value| (a bf16 output, one ulp 2**-8);
# the final state relative to its largest |value| (f32 on both sides, only
# the order of the sums differs)
SSD_Y_TOL, SSD_H_TOL = 2e-2, 1e-3
# SSD gradients through the autograd Function (kernel forward, plain f32
# backward) against plain autograd on the same bf16 inputs, relative to each
# one's largest |value|: the backward is the same f32 recompute either way
SSD_GRAD_TOL = 1e-3
SSD_CHUNK = 256
# a timing loop cycles over copies of its inputs that together hold this many
# bytes, 5x the H100's 50 MB L2, so each call reads device memory as the
# bytes bound assumes
COLD_BYTES = 256 << 20
# a timing loop of tiny calls holds at most this many input copies (the
# decode shape's 8 rows stay in L2, as they do in a decode step) and queues
# at most this many calls behind its sleep kernel, well inside the launch
# queue, which would otherwise block the host until the device drains it
MAX_COPIES, MAX_QUEUED = 256, 512


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` calls, CUDA events around the
    loop: the device's time where it is the longer, else the host's time
    to issue the calls (Python, checks and launch), as a caller sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the sleep kernel that holds the stream while a timing loop is enqueued
# counts cycles; 2e9 a second is above the H100's boost clock, so a sleep
# asked for t seconds lasts at least t
SLEEP_CYCLES_PER_S = 2e9


def time_device_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, host ms) per call of ``fn``, beside ``time_ms``.  At
    most ``MAX_QUEUED`` calls are enqueued behind a sleep kernel that lasts
    longer than their enqueueing, so the events time the device running
    them back to back without the host's share; the host ms is that
    enqueueing time.  If the sleep ran out first (the start event fired
    before the last call was queued), the loop reruns with twice the sleep
    and half the calls (a call of many kernels fills the launch queue,
    which blocks the host until the sleep ends); after six tries it raises
    (``fn`` synchronises)."""
    iters = min(iters, MAX_QUEUED)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    guess = 2.0 * iters * (time.perf_counter() - t0) + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        torch.cuda._sleep(int(min(guess, 2.0) * SLEEP_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        held = not start.query()
        end.record()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters, 1e3 * host / iters
        guess *= 2
        iters = max(1, iters // 2)
    raise RuntimeError(f"time_device_ms: the sleep kernel never held the "
                       f"stream, down to {iters} calls enqueued")


def time_graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Per-call ms of ``calls`` calls of ``fn`` captured in one CUDA graph
    and replayed ``replays`` times, CUDA events around the replays: how the
    serving engine now launches its kernels, with no host in the loop.  The
    capture's launch counts are taken back out."""
    from repro_torch import kernels
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    after = kernels.launch_counts()
    kernels.add_launch_counts({k: before[k] - after[k] for k in after})
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def graph_equal(fn) -> bool:
    """Whether ``fn()`` replayed from a captured CUDA graph gives bitwise
    the output of an eager call (a tensor or a tuple of them)."""
    from repro_torch import kernels

    def tensors(out):
        return out if isinstance(out, tuple) else (out,)
    eager = [t.clone() for t in tensors(fn())]
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = tensors(fn())
    after = kernels.launch_counts()
    kernels.add_launch_counts({k: before[k] - after[k] for k in after})
    for t in static:
        t.fill_(0)                  # nothing left over from the capture
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(eager, static))


def release() -> None:
    """Free what dropped engines held: an engine and its memoized graphs
    reference each other (a graph's body is a bound method of the engine),
    so its graphs' pool and static outputs go only when the cycle is
    collected."""
    gc.collect()
    torch.cuda.empty_cache()


def cycled(fn, cases):
    """A call of ``fn`` on the next argument tuple of ``cases`` each time."""
    it = itertools.cycle(cases)
    return lambda: fn(*next(it))


def n_copies(nbytes: int) -> int:
    """Copies of ``nbytes`` of inputs that fill ``COLD_BYTES``."""
    return max(2, math.ceil(COLD_BYTES / nbytes))


def bound(nbytes: float, ops: float, rate: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[rate]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


# ---------------------------------------------------------------------------
# 1. device, 2. build
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}: "
        f"{torch.cuda.get_device_name(0)}")
    log(f"[device] nvidia-smi: {smi}")
    return smi


# kernels whose products run on the tensor cores: their SASS must hold
# HMMA (mma.sync) or HGMMA (wgmma) instructions
TENSOR_CORE_KERNELS = ("flash_prefill_kernel", "flash_prefill_wide_kernel",
                       "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                       "ssd_scan_states_kernel", "ssd_scan_output_kernel")
# zamba2-7b's instantiations, by the start of their mangled names, and
# whether their products must run on the tensor cores
HYBRID_INSTANTIATIONS = (
    ("_Z14rmsnorm_kernelILi14E", False), ("_Z14rmsnorm_kernelILi28E", False),
    ("_Z22ssd_scan_states_kernelILi64ELi64E", True),
    ("_Z21ssd_scan_carry_kernelILi64ELi64E", False),
    ("_Z22ssd_scan_output_kernelILi64ELi64ELi2E", True),
    ("_Z25flash_prefill_wide_kernelILi224E", True),
    ("_Z19paged_decode_kernelI13__nv_bfloat16Li224ELi1E", False),
    ("_Z19paged_decode_kernelIaLi224ELi1E", False),
    ("_Z27paged_decode_combine_kernelI13__nv_bfloat16Li224ELi1E", False),
    ("_Z21flash_bwd_prep_kernelILi224E", False),
    ("_Z24flash_bwd_dq_wide_kernelILi224E", True),
    ("_Z25flash_bwd_dkv_wide_kernelILi224E", True))


def sass_mma_counts(path: str) -> dict:
    """HMMA/HGMMA instructions in the SASS of each function of the built
    library, by ``cuobjdump -sass`` (the toolkit's, beside ``nvcc``)."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool}): "
                           f"cannot show that the products run on the "
                           f"tensor cores")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def ptxas_resources(compiler_log: str) -> dict:
    """{mangled entry function: (registers, spill store bytes, spill load
    bytes)} from ``ptxas -v``'s report in the build log."""
    found, fn = {}, None
    for line in compiler_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            found[fn] = [0, 0, 0]
        elif fn is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            found[fn][1] = int(words[words.index("spill") - 2])
            found[fn][2] = int(words[words.index("loads") - 3])
        elif fn is not None and "Used" in line and "registers" in line:
            words = line.split()
            found[fn][0] = int(words[words.index("registers,") - 1])
    return {k: tuple(v) for k, v in found.items()}


def phase_build() -> None:
    from repro_torch.kernels import _build
    info = _build.build_info()
    log(f"[build] {info['path']} in {info['seconds']:.2f} s")
    for line in str(info["compiler_log"]).splitlines():
        if "Compiling entry function" in line:
            log(f"[build]   {line.split(chr(39))[1][:72]}")
        elif "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")
    counts = sass_mma_counts(info["path"])
    for name in TENSOR_CORE_KERNELS:
        found = {fn: n for fn, n in counts.items() if name in fn}
        n = sum(found.values())
        log(f"[build] {name}: {n} HMMA/HGMMA instructions in its SASS "
            f"({len(found)} instantiation(s))")
        if not found or n == 0:
            raise AssertionError(f"{name}: no tensor-core instruction in the "
                                 f"SASS of {info['path']}")
    # the hybrid's instantiations: each built, its registers and spills,
    # and HMMA in the SASS of those that run products
    res = ptxas_resources(str(info["compiler_log"]))
    for prefix, products in HYBRID_INSTANTIATIONS:
        fns = [fn for fn in res if fn.startswith(prefix)]
        if not fns:
            raise AssertionError(f"{prefix}: not in the build")
        regs, st, ld = res[fns[0]]
        hmma = sum(n for fn, n in counts.items() if fn.startswith(prefix))
        log(f"[build] zamba2-7b {prefix}: {regs} registers, spill stores "
            f"{st} bytes, spill loads {ld} bytes; {hmma} HMMA/HGMMA "
            f"instructions")
        if products and hmma == 0:
            raise AssertionError(f"{prefix}: no tensor-core instruction in "
                                 f"its SASS")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _library_sdpa(q, k, v, mask):
    """One PyTorch call over (B, H|KV, S, D) views (the yardstick)."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


#: how the rows' times were taken (their "timing" key)
TIMING = ("ms, plain_ms, library_ms with the host in the loop (CUDA events "
          "around the calls); device_ms, library_device_ms with the calls "
          "queued behind a sleep kernel")
#: how the rows with graph times took them
GRAPH_TIMING = ("graph_ms, library_graph_ms: the calls captured in one CUDA "
                "graph and replayed, as the serving engine launches them")


def versus(name, t, lib_name):
    """A log fragment: a kernel's times beside a library call's, both with
    the host in the loop (the rows' ms) and as device time."""
    graph = "" if "graph_ms" not in t else (
        f"; replayed from a CUDA graph {t['graph_ms']:.4f} ms against "
        f"{t['library_graph_ms']:.4f} ms "
        f"({t['graph_ms'] / t['library_graph_ms']:.2f}x)")
    return (f"{name} {t['ms']:.4f} ms, {lib_name} {t['library_ms']:.4f} ms "
            f"({t['ms'] / t['library_ms']:.2f}x) with the host in the loop; "
            f"device time {t['device_ms']:.4f} ms against "
            f"{t['library_device_ms']:.4f} ms "
            f"({t['device_ms'] / t['library_device_ms']:.2f}x){graph}; "
            f"{t['host_ms'] * 1e3:.1f} us of host time a call")


def both_times(kernel, library, iters: int, graph: bool = False) -> dict:
    """The times of a kernel's and a library call's loops: ``ms`` and
    ``library_ms`` with the host in the loop (``time_ms``), ``device_ms``
    and ``library_device_ms`` queued behind a sleep kernel, the kernel's
    ``host_ms`` a call, and with ``graph`` also ``graph_ms`` and
    ``library_graph_ms`` (``time_graph_ms`` over ``iters`` calls)."""
    t = {"ms": time_ms(kernel, iters), "library_ms": time_ms(library, iters)}
    t["device_ms"], t["host_ms"] = time_device_ms(kernel, iters)
    t["library_device_ms"] = time_device_ms(library, iters)[0]
    if graph:
        t["graph_ms"] = time_graph_ms(kernel, iters)
        t["library_graph_ms"] = time_graph_ms(library, iters)
    return t


def rmsnorm_timings(gen, rows: int, d: int):
    """``both_times`` of the RMSNorm wrapper against ``F.rms_norm`` at
    (rows, d) bf16 with an f32 scale, each cycling over input copies larger
    than L2, at most ``MAX_COPIES`` of them (public wrappers only, so that
    another tree's kernels can be timed the same way); and the inputs."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    n = min(n_copies(rows * d * 2), MAX_COPIES)
    xs = [torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
          for _ in range(n)]
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    wb = w.to(torch.bfloat16)
    t = both_times(cycled(lambda x: rmsnorm(x, w), [(x,) for x in xs]),
                   cycled(lambda x: F.rms_norm(x, (d,), wb, 1e-5),
                          [(x,) for x in xs]),
                   min(max(4 * n, 64), MAX_QUEUED), graph=True)
    return t, (xs, w, n)


def _rmsnorm_compare(gen, rows: int, d: int):
    """The kernel against its plain version at (rows, d); logs and returns
    (ok, max_abs_err)."""
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    ref = rmsnorm_ref(x, w).float()
    err = (rmsnorm(x, w).float() - ref).abs()
    ok = bool((err <= RMS_RTOL * ref.abs() + 1e-6).all())
    log(f"[kernels] rmsnorm x ({rows}, {d}) bf16: max_abs_err "
        f"{float(err.max()):.3e} (rtol {RMS_RTOL}) ok={ok}")
    return ok, float(err.max())


def _rmsnorm_row(gen, rows: int, d: int, name: str = "rmsnorm"):
    """The kernel at (rows, d) against its plain version and twice (bitwise
    equal), timed beside ``F.rms_norm`` (``rmsnorm_timings``, graph_ms
    too) and its bound; logs and returns (its JSON row, ok)."""
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    t, (xs, w, n) = rmsnorm_timings(gen, rows, d)
    x = xs[0]
    got, ref = rmsnorm(x, w), rmsnorm_ref(x, w)
    same = torch.equal(got, rmsnorm(x, w))
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= RMS_RTOL * ref.float().abs() + 1e-6).all()) and same
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
           "replaces": "src/repro/kernels/rmsnorm/kernel.py:30",
           "shape": f"x ({rows}, {d}) bf16",
           "timing": f"cold L2: cycles over {n} input copies; {TIMING}; "
                     f"{GRAPH_TIMING}",
           "max_abs_err": float(err.max()), "tol": f"rtol {RMS_RTOL}",
           "ms": t["ms"], "device_ms": t["device_ms"],
           "graph_ms": t["graph_ms"],
           "library_graph_ms": t["library_graph_ms"],
           "plain_ms": time_ms(cycled(lambda x: rmsnorm_ref(x, w),
                                      [(x,) for x in xs]), iters=n),
           "library_ms": t["library_ms"],
           "library_device_ms": t["library_device_ms"]}
    row["bound_ms"], row["bound_by"] = bound(
        2 * rows * d * 2 + d * 4, 4 * rows * d, "f32")
    log(f"[kernels] {name} {row['shape']}: max_abs_err "
        f"{row['max_abs_err']:.3e} (rtol {RMS_RTOL}); two calls bitwise "
        f"equal {same}; ok={ok}; {versus('kernel', t, 'F.rms_norm')}; "
        f"bound {row['bound_ms']:.4f} ms")
    return row, ok


def check_rmsnorm(gen):
    from repro_torch.kernels.rmsnorm import rmsnorm
    row, ok = _rmsnorm_row(gen, SERVE_SLOTS * 512, 2048)  # slots x bucket
    rows = SERVE_SLOTS * 512
    # mamba2-370m's block and final norms run at d_model 1024, the small
    # Trainer run at 256: checked, logged, not in the JSON
    oks = [ok] + [_rmsnorm_compare(gen, rows, dd)[0] for dd in (1024, 256)]
    if not all(oks):
        raise AssertionError("rmsnorm kernel disagrees with its plain version")
    # mamba's width at the prefill shape, and llama's decode shape (33 norms
    # of every decode step; launch-bound): logged beside F.rms_norm
    for r, dd in ((rows, 1024), (SERVE_SLOTS, 2048)):
        tt, (_, _, nc) = rmsnorm_timings(gen, r, dd)
        b_ms, _ = bound(2 * r * dd * 2 + dd * 4, 4 * r * dd, "f32")
        log(f"[kernels] rmsnorm x ({r}, {dd}) bf16 ({nc} input copies): "
            f"{versus('kernel', tt, 'F.rms_norm')}; bound {b_ms:.4f} ms")
    # a width the kernel is not instantiated for is refused on the card
    x = torch.randn(4, 512, device="cuda").bfloat16()
    try:
        rmsnorm(x, torch.ones(512, device="cuda"))
    except ValueError as e:
        log(f"[kernels] rmsnorm at d 512 refused: {e}")
    else:
        raise AssertionError("rmsnorm ran at d 512, which it is not built for")
    return row


def _prefill_row(gen, B, S, H, KV, D, name="flash_prefill", graph=False,
                 backend=False):
    """The prefill kernel at one serving bucket (B rows of S with ragged
    valid lengths, row B // 2 at S // 3) against its plain version, timed
    beside SDPA over the same causal and valid-length mask (``graph``:
    graph_ms too) and its bound; with ``graph`` also twice (bitwise
    equal), and with ``backend`` the kernels SDPA launched are logged.
    Raises on a disagreement; returns the bucket's JSON row."""
    from repro_torch.kernels.flash_attention import (flash_prefill,
                                                     flash_prefill_ref)
    vl = torch.tensor(np.linspace(1, S, B).astype(np.int32), device="cuda")
    vl[B // 2] = S // 3
    n = n_copies(2 * B * S * (H + 2 * KV) * D)
    cases = [tuple(torch.randn(B, S, heads, D, generator=gen,
                               device="cuda").bfloat16()
                   for heads in (H, KV, KV)) for _ in range(n)]
    q, k, v = cases[0]
    got = flash_prefill(q, k, v, vl)
    ref = flash_prefill_ref(q, k, v, vl)
    same = torch.equal(got, flash_prefill(q, k, v, vl))
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= ATTN_TOL + ATTN_TOL * ref.float().abs()).all()) \
        and same
    log(f"[kernels] {name} B={B} S={S} H={H} KV={KV} D={D} "
        f"valid_len={vl.tolist()}: max_abs_err {float(err.max()):.3e} "
        f"(tol {ATTN_TOL}); two calls bitwise equal {same}; ok={ok}")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version")
    kpos = torch.arange(S, device="cuda")
    mask = (kpos[None, :] <= kpos[:, None])[None] \
        & (kpos[None, None, :] < vl[:, None, None])      # (B, S, S)

    def sdpa(q, k, v):
        return _library_sdpa(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), mask[:, None])
    t = both_times(cycled(lambda q, k, v: flash_prefill(q, k, v, vl), cases),
                   cycled(sdpa, cases), max(20, n), graph=graph)
    if backend:
        names = sorted({key.split("(")[0][:60] for _, _, key in
                        profiled_kernels(lambda: sdpa(q, k, v))})
        log(f"[kernels] {name} S={S}: SDPA (boolean mask) launched "
            f"{names}")
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:125",
           "shape": f"q ({B}, {S}, {H}, {D}) kv {KV} heads bf16",
           "timing": f"cold L2: cycles over {n} input copies; {TIMING}"
                     + (f"; {GRAPH_TIMING}" if graph else ""),
           "max_abs_err": float(err.max()), "tol": ATTN_TOL,
           "ms": t["ms"], "device_ms": t["device_ms"],
           "plain_ms": time_ms(cycled(
               lambda q, k, v: flash_prefill_ref(q, k, v, vl), cases),
               iters=5),
           "library_ms": t["library_ms"],
           "library_device_ms": t["library_device_ms"]}
    if graph:
        row.update(graph_ms=t["graph_ms"],
                   library_graph_ms=t["library_graph_ms"])
    # bytes: q read and out written whole; row b reads K and V only at
    # its min(S, valid_len) valid keys.  Operations: 4 D per (query,
    # key) pair left by the causal and valid-length masks.
    keys = int(torch.clamp(vl, max=S).sum())
    i = torch.arange(S, device="cuda")
    pairs = int(torch.minimum(i[None, :] + 1, vl[:, None]).sum()) * H
    row["bound_ms"], row["bound_by"] = bound(
        2 * (2 * B * S * H * D + 2 * keys * KV * D) + B * 4,
        4 * D * pairs, "bf16")
    log(f"[kernels] {name} S={S}: {versus('kernel', t, 'SDPA')}; "
        f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def check_prefill(gen):
    # 8 and 32: the smallest serving buckets, shorter than one 64-row tile
    rows = [_prefill_row(gen, SERVE_SLOTS, S, 32, 8, 64)
            for S in (8, 32, 128, 512)]
    check_prefill_padded_window(gen)
    return rows[-1]              # the longest bucket goes in the JSON


def _check_fwd_lse(label, got, lse, ref, lse_ref):
    """The attention output within ``ATTN_TOL`` (absolute plus relative)
    and the log-sum-exp within ``LSE_TOL`` of the plain version's; logs
    and returns (max_abs_err, lse max_abs_err)."""
    err = float((got.float() - ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    ok = bool(((got.float() - ref.float()).abs()
               <= ATTN_TOL + ATTN_TOL * ref.float().abs()).all()) \
        and lse_err <= LSE_TOL
    log(f"[kernels] flash_prefill {label}: max_abs_err {err:.3e} (tol "
        f"{ATTN_TOL}), lse max_abs_err {lse_err:.3e} (tol {LSE_TOL}) "
        f"ok={ok}")
    if not ok:
        raise AssertionError(f"flash_prefill kernel disagrees with its plain "
                             f"version: {label}")
    return err, lse_err


def check_prefill_padded_window(gen, H=32, KV=8, D=64):
    """A local window over right-padded rows: row 1's padded queries at
    positions >= 40 + 16 - 1 see no valid key and take the kernel's branch
    for that case (the mean of the values their window admits, as the
    reference gives).  Every row is compared, the log-sum-exp too."""
    from repro_torch.kernels.flash_attention import (flash_prefill,
                                                     flash_prefill_ref)
    B, S, window = 2, 128, 16
    vl = torch.tensor([S, 40], dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn(B, S, heads, D, generator=gen,
                           device="cuda").bfloat16()
               for heads in (H, KV, KV))
    _check_fwd_lse(f"D {D}, window {window}, valid_len {vl.tolist()} "
                   f"(rows without a valid key)",
                   *flash_prefill(q, k, v, vl, window=window,
                                  return_lse=True),
                   *flash_prefill_ref(q, k, v, vl, window=window,
                                      return_lse=True))


def _attention_pairs(B, H, S):
    """(query, key) pairs a causal mask admits over B x H heads of S."""
    return B * H * S * (S + 1) // 2


def _check_bwd(shape, got, ref):
    """Each of dq, dk, dv within ``BWD_TOL`` of its largest |value|; logs
    and returns {name: (max_abs_err, max |value|)}."""
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        scale = float(r.float().abs().max())
        errs[name] = (float((g.float() - r.float()).abs().max()), scale)
    ok = all(e <= BWD_TOL * sc for e, sc in errs.values())
    log(f"[kernels] flash_bwd {shape}: " + ", ".join(
        f"{k_} max_abs_err {e:.3e} of max |{k_}| {sc:.3e}"
        for k_, (e, sc) in errs.items()) + f" (tol {BWD_TOL} relative) "
        f"ok={ok}")
    if not ok:
        raise AssertionError(f"flash_bwd kernel disagrees with its plain "
                             f"version at {shape}")
    return errs


def _check_bwd_edge(gen, B, S, H, KV, D=TRAIN_D):
    """The causal forward with its log-sum-exp and the backward at one more
    shape, each against its plain version (logged, not in the JSON)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_prefill,
                                                     flash_prefill_ref)
    shape = f"B {B} S {S} H {H} KV {KV} D {D} causal bf16"
    q, k, v = (torch.randn(B, S, heads, D, generator=gen,
                           device="cuda").bfloat16()
               for heads in (H, KV, KV))
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
    o, lse = flash_prefill(q, k, v, return_lse=True)
    _check_fwd_lse(f"with lse, {shape}", o, lse,
                   *flash_prefill_ref(q, k, v, return_lse=True))
    _check_bwd(shape, flash_attention_bwd(q, k, v, o, do, lse),
               flash_attention_bwd_ref(q, k, v, o, do, lse))


def check_flash_bwd(gen, H=TRAIN_H, KV=TRAIN_KV, D=TRAIN_D,
                    edges=((2, 200, 32, 8), (2, 256, 8, 8)), tag=""):
    """The training path's attention kernels at its shape (a micro-batch of
    ``TRAIN_SEQ``; llama3.2-1b's heads by default, zamba2-7b's shared block
    with ``HYBRID_ATTN``): the forward with its log-sum-exp and the flash
    backward, each against its plain version on the same inputs, and timed
    (cold L2) beside SDPA's forward and its backward through
    ``torch.autograd.grad`` on a saved forward; then both again at the
    ``edges`` shapes (B, S, H, KV).  Returns the forward's and the
    backward's JSON rows, named with ``tag``."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_prefill,
                                                     flash_prefill_ref)
    B, S = TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ
    shape = f"B {B} S {S} H {H} KV {KV} D {D} causal bf16"
    io_bytes = 2 * B * S * (H + 2 * KV) * D          # q, k, v
    n = n_copies(io_bytes * 2 + 2 * 2 * B * S * H * D)

    def case():
        q, k, v = (torch.randn(B, S, heads, D, generator=gen,
                               device="cuda").bfloat16()
                   for heads in (H, KV, KV))
        do = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
        o, lse = flash_prefill(q, k, v, return_lse=True)
        return q, k, v, o, do, lse
    cases = [case() for _ in range(n)]
    q, k, v, o, do, lse = cases[0]

    err, lse_err = _check_fwd_lse(
        f"with lse, {shape}", o, lse,
        *flash_prefill_ref(q, k, v, return_lse=True))

    got = flash_attention_bwd(q, k, v, o, do, lse)
    errs = _check_bwd(shape, got, flash_attention_bwd_ref(q, k, v, o, do,
                                                          lse))
    # no atomics and sums in a fixed order: a second call on the same
    # inputs gives bitwise-equal gradients
    again = flash_attention_bwd(q, k, v, o, do, lse)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[kernels] flash_bwd {shape}: two calls bitwise equal (dq, dk, dv): "
        f"{same}")
    if not same:
        raise AssertionError("flash_bwd kernel is not deterministic")
    del got, again
    # the tile edges: S not a multiple of the 64-row tile, and another G
    for cB, cS, cH, cKV in edges:
        _check_bwd_edge(gen, cB, cS, cH, cKV, D)

    def sdpa_saved(q, k, v, o, do, lse):
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        return out, (qt, kt, vt), do.transpose(1, 2)
    saved = [sdpa_saved(*c) for c in cases]
    timing = f"cold L2: cycles over {n} input copies; {TIMING}"
    pairs = _attention_pairs(B, H, S)
    t_fwd = both_times(
        cycled(lambda q, k, v, *_: flash_prefill(q, k, v, return_lse=True),
               cases),
        cycled(lambda q, k, v, *_: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True), cases), 4 * n)
    t_bwd = both_times(
        cycled(lambda *c: flash_attention_bwd(*c), cases),
        cycled(lambda out, inputs, g: torch.autograd.grad(
            out, inputs, g, retain_graph=True), saved), 2 * n)
    fwd = {"name": "flash_prefill_lse" + tag, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:125",
           "shape": f"q ({B}, {S}, {H}, {D}) kv {KV} heads bf16, causal, "
                    f"with lse", "timing": timing,
           "max_abs_err": max(err, lse_err), "tol": ATTN_TOL,
           "ms": t_fwd["ms"], "device_ms": t_fwd["device_ms"],
           "plain_ms": time_ms(cycled(lambda q, k, v, *_: flash_prefill_ref(
               q, k, v, return_lse=True), cases), iters=3, warmup=1),
           "library_ms": t_fwd["library_ms"],
           "library_device_ms": t_fwd["library_device_ms"]}
    # bytes: q, k, v read, o written, lse written (f32); 2 products of 2 D
    # flops per admitted pair
    fwd["bound_ms"], fwd["bound_by"] = bound(
        io_bytes + 2 * B * S * H * D + 4 * B * H * S, 4 * D * pairs, "bf16")
    bwd = {"name": "flash_bwd" + tag, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_backward.cu",
           "replaces": "src/repro/kernels/flash_attention/backward.py:125",
           "also_replaces": "src/repro/kernels/flash_attention/"
                            "backward.py:144",
           "shape": f"q ({B}, {S}, {H}, {D}) kv {KV} heads bf16, causal",
           "timing": timing,
           "max_abs_err": max(e for e, _ in errs.values()),
           "tol": f"{BWD_TOL} of each output's largest |value|",
           "ms": t_bwd["ms"], "device_ms": t_bwd["device_ms"],
           "plain_ms": time_ms(cycled(lambda *c: flash_attention_bwd_ref(
               *c), cases), iters=3, warmup=1),
           "library_ms": t_bwd["library_ms"],
           "library_device_ms": t_bwd["library_device_ms"]}
    # bytes: q, k, v, o, dO read, lse read (f32), dq, dk, dv written;
    # the function needs 5 products of 2 D flops per admitted pair (QK^T,
    # dO V^T, dS K, P^T dO, dS^T Q; the kernels' recompute of QK^T and
    # dO V^T in the second kernel is the design's, not the function's)
    bwd["bound_ms"], bwd["bound_by"] = bound(
        2 * io_bytes + 2 * 2 * B * S * H * D + 4 * B * H * S,
        5 * 2 * D * pairs, "bf16")
    for row, t in ((fwd, t_fwd), (bwd, t_bwd)):
        log(f"[kernels] {row['name']} {shape}: {versus('kernel', t, 'SDPA')}"
            f"; plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']})")
    return fwd, bwd


# decode positions of the timed paged-decode rows, and of the profile
# run's short contexts (8 prompts of 128 tokens and up to 32 new ones)
SERVE_POS = tuple(int(p) for p in np.linspace(16, 1000, SERVE_SLOTS))
PROFILE_POS = tuple(int(p) for p in np.linspace(128, 160, SERVE_SLOTS))


def _paged_case(gen, pool_dtype, positions=SERVE_POS, L=16, H=32, KV=8,
                D=64):
    """Full-width decode operands: one slot per position, page 16, a table
    of 64 pages whose entries past each slot's last page stay parked at page
    0 (a slot at pos == max_seq holds its whole table), and ``L`` layers of
    pools (16: a timing loop over layers leaves L2 cold).  Heads and
    head_dim default to llama3.2-1b's; ``HYBRID_ATTN`` gives zamba2-7b's."""
    B, page = len(positions), SERVE_PAGE
    nb = SERVE_MAX_SEQ // page
    P = B * nb + 1
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros(B, nb, dtype=torch.int32, device="cuda")
    for b in range(B):                               # the rest stays parked
        n = min(nb, int(pos[b]) // page + 1)
        tables[b, :n] = perm[b * nb:b * nb + n]
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").bfloat16()
    k32 = torch.randn(L, P, page, KV, D, generator=gen, device="cuda")
    v32 = torch.randn(L, P, page, KV, D, generator=gen, device="cuda")
    if pool_dtype == torch.float32:
        return q, k32, v32, tables, pos, None, None
    if pool_dtype == torch.bfloat16:
        return q, k32.bfloat16(), v32.bfloat16(), tables, pos, None, None
    qmax = 127.0 if pool_dtype == torch.int8 else 448.0
    ks = k32.abs().amax(dim=(2, 4)) / qmax                # (L, P, KV)
    vs = v32.abs().amax(dim=(2, 4)) / qmax

    def quant(x, s):
        y = x / s[:, :, None, :, None]
        if pool_dtype == torch.int8:
            y = torch.round(y)
        return torch.clamp(y, -qmax, qmax).to(pool_dtype)
    return q, quant(k32, ks), quant(v32, vs), tables, pos, ks, vs


def _layers(case):
    """(k pool, v pool, k scales, v scales) of each layer of a case."""
    _, kp, vp, _, _, ks, vs = case
    return [(kp[i], vp[i], None if ks is None else ks[i],
             None if vs is None else vs[i]) for i in range(kp.shape[0])]


def _paged_work(case):
    """(bytes, operations) of one decode call on a case.  Bytes: q read and
    out written; slot b's pos + 1 keys and values (the whole table for a
    parked slot); for the pages it walks, their table entries and
    (quantized pools) their K and V scales of every KV head; pos."""
    q, kp, _, tables, pos, ks, _ = case
    B, _, H, D = q.shape
    page, KV = kp.shape[2], kp.shape[3]
    S = tables.shape[1] * page
    last = torch.clamp(pos, max=S - 1)
    keys = int((last + 1).sum())
    pages = int((last // page + 1).sum())
    scale_bytes = 0 if ks is None else pages * KV * 4 * 2
    return (2 * B * H * D * 2 + keys * KV * D * kp.element_size() * 2
            + scale_bytes + pages * 4 + B * 4, 4 * D * H * keys)


def _paged_bound(case):
    """(bound ms, by) of one decode call on a case (``_paged_work``)."""
    return bound(*_paged_work(case), "bf16")


def _paged_library_bytes(case):
    """Bytes the SDPA yardstick of ``paged_timings`` reads and writes: q,
    the output, the boolean mask, and the gathered bf16 K and V of every
    slot over the pages up to the largest position."""
    q, kp, _, tables, pos, _, _ = case
    B, _, H, D = q.shape
    page, KV = kp.shape[2], kp.shape[3]
    keys = min(tables.shape[1], int(pos.max()) // page + 1) * page
    return 2 * B * H * D * 2 + B * keys + 2 * B * KV * keys * D * 2


def paged_timings(case, plain: bool = False, decode=None):
    """``both_times`` of one decode call on ``case`` against SDPA, and
    ``plain_ms`` (None unless ``plain``), each cycling over its layers'
    pools.  ``decode`` (default: the public wrapper) takes the wrapper's
    arguments, so that another tree's kernel or another split size can be
    timed the same way.  The SDPA yardstick reads bf16 caches already
    gathered per slot, one per layer, so that it too reads device memory,
    over the pages in use: every slot's keys up to the largest position
    (the kernel reads each slot's pos + 1), in bf16 even for an int8 or
    fp8 pool (``_paged_library_bytes``)."""
    from repro_torch.kernels.flash_attention import (paged_attention_ref,
                                                     paged_flash_decode)
    from repro_torch.kernels.flash_attention.paged import gather_pages
    q, kp, _, tables, pos, _, _ = case
    layers = _layers(case)

    def run(fn):
        return cycled(lambda *a: fn(q, a[0], a[1], tables, pos, k_scales=a[2],
                                    v_scales=a[3]), layers)

    page = kp.shape[2]
    nb = min(tables.shape[1], int(pos.max()) // page + 1)
    gathered = [tuple(gather_pages(kv, tables[:, :nb], s).bfloat16()
                      .transpose(1, 2) for kv, s in ((kl, ksl), (vl_, vsl)))
                for kl, vl_, ksl, vsl in layers]
    mask = (torch.arange(nb * page, device="cuda")[None, :] <= pos[:, None])
    qt = q.transpose(1, 2)
    t = both_times(run(decode or paged_flash_decode),
                   cycled(lambda gk, gv: _library_sdpa(
                       qt, gk, gv, mask[:, None, None, :]), gathered), 32,
                   graph=True)
    t["plain_ms"] = time_ms(run(paged_attention_ref), iters=8) if plain \
        else None
    return t


def _paged_compare(label, case, window=0, softcap=0.0):
    """The kernel against its plain version on the first layer of a case
    at ``ATTN_TOL``; logs and returns (output, max_abs_err)."""
    from repro_torch.kernels.flash_attention import (paged_attention_ref,
                                                     paged_flash_decode)
    q, _, _, tables, pos, _, _ = case
    k0, v0, ks0, vs0 = _layers(case)[0]
    kw = dict(window=window, softcap=softcap, k_scales=ks0, v_scales=vs0)
    got = paged_flash_decode(q, k0, v0, tables, pos, **kw)
    ref = paged_attention_ref(q, k0, v0, tables, pos, **kw)
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= ATTN_TOL + ATTN_TOL * ref.float().abs()).all()) \
        and bool(torch.isfinite(got).all())
    log(f"[kernels] paged_decode {label}: B={q.shape[0]} page "
        f"{k0.shape[1]} pos={pos.tolist()} window {window} softcap "
        f"{softcap}: max_abs_err {float(err.max()):.3e} (tol {ATTN_TOL}) "
        f"ok={ok}")
    if not ok:
        raise AssertionError(f"paged_decode kernel ({label}) disagrees with "
                             f"its plain version")
    return got, float(err.max())


def check_paged(gen, pool_dtype, label, attn=None, L=16):
    """The paged decode kernel on one pool type: at the serving positions,
    twice (bitwise equal); at split and page edges, a parked slot
    (pos == max_seq), a window of 256 that begins inside a split, softcap
    50 and a single slot; then timed at the serving positions (its JSON
    row) and, for the serving pools, at the profile run's short contexts
    (logged).  ``attn`` (heads, KV heads, head_dim; ``HYBRID_ATTN``)
    replaces llama3.2-1b's, and ``L`` layers of pools cycle in the
    timing."""
    from repro_torch.kernels.flash_attention import paged_flash_decode
    from repro_torch.kernels.flash_attention.paged import split_plan
    attn = attn or {}
    case = _paged_case(gen, pool_dtype, L=L, **attn)
    q, kp, _, tables, pos, _, _ = case
    got, err = _paged_compare(f"{label} pool", case)
    k0, v0, ks0, vs0 = _layers(case)[0]
    again = paged_flash_decode(q, k0, v0, tables, pos, k_scales=ks0,
                               v_scales=vs0)
    if not torch.equal(got, again):
        raise AssertionError(f"paged_decode ({label}): two calls differ")
    kps, n_split = split_plan(tables.shape[1], kp.shape[2])
    edges = (0, 15, 16, kps - 1, kps, SERVE_MAX_SEQ - 1, SERVE_MAX_SEQ, 500)
    for what, positions, window, softcap in (
            ("edges", edges, 0, 0.0),
            ("window", edges, 256, 0.0),
            ("softcap", edges, 0, 50.0),
            ("B 1", (1000,), 0, 0.0)):
        _paged_compare(f"{label} pool, {what} ({kps} keys a split, "
                       f"{n_split} splits)",
                       _paged_case(gen, pool_dtype, positions, L=1, **attn),
                       window, softcap)
    B, _, H, D = q.shape
    t = paged_timings(case, plain=True)
    nbytes = _paged_work(case)[0]
    lib_bytes = _paged_library_bytes(case)
    row = {"name": f"paged_decode[{label}]", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
           "replaces": "src/repro/kernels/flash_attention/paged.py:155",
           "shape": f"q ({B}, 1, {H}, {D}) pool {label} page {kp.shape[2]} "
                    f"pos {int(pos.min())}..{int(pos.max())}",
           "timing": f"cold L2: cycles over {kp.shape[0]} layers' pools; "
                     f"{TIMING}; {GRAPH_TIMING}; SDPA reads a gathered bf16 "
                     f"cache of every slot up to the largest position",
           "bytes": nbytes, "library_bytes": lib_bytes,
           "max_abs_err": err, "tol": ATTN_TOL, "ms": t["ms"],
           "device_ms": t["device_ms"], "graph_ms": t["graph_ms"],
           "library_graph_ms": t["library_graph_ms"],
           "plain_ms": t["plain_ms"],
           "library_ms": t["library_ms"],
           "library_device_ms": t["library_device_ms"]}
    row["bound_ms"], row["bound_by"] = _paged_bound(case)
    log(f"[kernels] paged_decode {label} pool, serving positions: "
        f"{versus('kernel', t, 'SDPA over the pages in use')}; bound "
        f"{row['bound_ms']:.4f} ms; bytes: kernel {nbytes / 1e6:.2f} MB, "
        f"SDPA {lib_bytes / 1e6:.2f} MB ({lib_bytes / nbytes:.2f}x)")
    del case
    if pool_dtype in (torch.bfloat16, torch.int8):
        short = _paged_case(gen, pool_dtype, PROFILE_POS, L=L, **attn)
        st = paged_timings(short)
        log(f"[kernels] paged_decode {label} pool, short contexts pos "
            f"{PROFILE_POS[0]}..{PROFILE_POS[-1]}: "
            f"{versus('kernel', st, 'SDPA over the pages in use')}; bound "
            f"{_paged_bound(short)[0]:.4f} ms")
    return row


def _ssd_case(gen, B, S, H, G, h0=False, N=128, P=64):
    """SSD scan operands: bf16 x, B, C; f32 log decay in (-0.03, 0], the
    served model's scale (dt * A with dt = softplus(N(0, 1) - 4.6), A = -1),
    so the state carried across a 256-position chunk keeps a visible share
    of y; optionally an f32 state."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    return (rnd(B, S, H, P).bfloat16(),
            -0.03 * torch.rand(B, S, H, generator=gen, device="cuda"),
            rnd(B, S, G, N).bfloat16(), rnd(B, S, G, N).bfloat16(),
            rnd(B, H, N, P) if h0 else None)


def _ssd_work(x, Bm, chunk, h0):
    """(bytes, operations) the SSD scan needs on these operands: x, a, B, C
    (and h0) read once, y and the final state written once; per chunk of n
    positions, C Bᵀ once per group over the n (n + 1) / 2 causal pairs, the
    dual form's product with x over those pairs per head, the chunk's state
    update per head and, where a state enters the chunk (not the first one
    when there is no h0), its term in y."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nbytes = 2 * B * S * H * P * 2 + 4 * B * S * H + 2 * 2 * B * S * G * N \
        + 4 * B * H * N * P * (1 if h0 is None else 2)
    ops = 0
    for c, t0 in enumerate(range(0, S, Q)):
        n = min(Q, S - t0)
        pairs = n * (n + 1) // 2
        carried = 1 if (c or h0 is not None) else 0
        ops += 2 * B * (G * pairs * N + H * pairs * P
                        + (1 + carried) * H * n * N * P)
    return nbytes, ops


# (label, shape, chunk) of the SSD scan's checks: the serving shape, with
# an initial state, the prefill buckets shorter than a 64-row tile (32) and
# than a chunk (128), 2 groups over a ragged last chunk (256 + 44) with an
# initial state, 3 heads a group (a block of the output pass then takes one
# head), and chunks of 16
SSD_CASES = (
    ("serve", dict(B=SERVE_SLOTS, S=512, H=32, G=1), SSD_CHUNK),
    ("serve_h0", dict(B=SERVE_SLOTS, S=512, H=32, G=1, h0=True), SSD_CHUNK),
    ("bucket32", dict(B=SERVE_SLOTS, S=32, H=32, G=1), SSD_CHUNK),
    ("bucket128", dict(B=SERVE_SLOTS, S=128, H=32, G=1), SSD_CHUNK),
    ("groups", dict(B=2, S=300, H=32, G=2, h0=True), SSD_CHUNK),
    ("groups_odd", dict(B=2, S=300, H=24, G=8, h0=True), SSD_CHUNK),
    ("chunk16", dict(B=2, S=200, H=32, G=1), 16))


def _ssd_compare(gen, label, shape, chunk):
    """The kernel against its plain version on one case, y within
    ``SSD_Y_TOL`` and the final state within ``SSD_H_TOL`` of their largest
    |value|, and twice (bitwise equal); logs and returns max_abs_err."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    x, a, Bm, Cm, h0 = _ssd_case(gen, **shape)
    y, hf = ssd_scan(x, a, Bm, Cm, chunk, h0=h0)
    y2, hf2 = ssd_scan(x, a, Bm, Cm, chunk, h0=h0)
    yr, hr = ssd_ref(x, a, Bm, Cm, chunk, h0=h0)
    torch.cuda.synchronize()
    err = _ssd_agree("kernels", f"ssd_scan {label} {shape} chunk {chunk}",
                     y, hf, yr, hr)
    same = torch.equal(y, y2) and torch.equal(hf, hf2)
    log(f"[kernels] ssd_scan {label}: two calls bitwise equal {same}")
    if not same:
        raise AssertionError(f"ssd_scan ({label}): two calls differ")
    return err


def _ssd_agree(tag, label, y, hf, yr, hr):
    """The kernel's y within ``SSD_Y_TOL`` and final state within
    ``SSD_H_TOL`` of the plain version's largest |value|, both finite;
    logs, raises on a mismatch, and returns the larger max_abs_err."""
    ey = float((y.float() - yr.float()).abs().max())
    sy = float(yr.float().abs().max())
    eh = float((hf - hr).abs().max())
    sh = float(hr.abs().max())
    ok = ey <= SSD_Y_TOL * sy and eh <= SSD_H_TOL * sh \
        and bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all())
    log(f"[{tag}] {label}: y max_abs_err {ey:.3e} of max |y| {sy:.3e} (tol "
        f"{SSD_Y_TOL} relative), state max_abs_err {eh:.3e} of max |h| "
        f"{sh:.3e} (tol {SSD_H_TOL} relative) ok={ok}")
    if not ok:
        raise AssertionError(f"ssd_scan kernel disagrees with its plain "
                             f"version ({label})")
    return max(ey, eh)


def ssd_timings(gen, shape, chunk, plain: bool = False, graph: bool = False):
    """Times of the SSD scan at ``shape`` and ``chunk``, cycling over input
    copies larger than L2: ``ms`` with the host in the loop, ``device_ms``
    and ``host_ms`` from ``time_device_ms``, ``passes`` (device ms a call
    of each kernel it launches, under ``torch.profiler``), ``plain_ms``
    (None unless ``plain``) and ``graph_ms`` (with ``graph``: the calls
    replayed from one CUDA graph); and the ``bytes`` and ``ops`` of one
    call (``_ssd_work``)."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    first = _ssd_case(gen, **shape)
    nbytes, ops = _ssd_work(first[0], first[2], chunk, first[4])
    n = n_copies(nbytes)
    copies = [first[:4]] + [_ssd_case(gen, **shape)[:4] for _ in range(n - 1)]
    run = cycled(lambda *c: ssd_scan(*c, chunk), copies)
    t = {"ms": time_ms(run, iters=2 * n)}
    t["device_ms"], t["host_ms"] = time_device_ms(run, iters=2 * n)

    def loop():
        for _ in range(2 * n):
            run()
        torch.cuda.synchronize()
    t["passes"] = {key.split("(")[0].split("<")[0].removeprefix("void "):
                   us / 1e3 / (2 * n)
                   for us, _, key in profiled_kernels(loop)
                   if "ssd_scan" in key}
    t["plain_ms"] = time_ms(cycled(lambda *c: ssd_ref(*c, chunk), copies),
                            iters=3, warmup=1) if plain else None
    if graph:
        t["graph_ms"] = time_graph_ms(run, calls=2 * n)
    t.update(copies=n, bytes=nbytes, ops=ops)
    return t


def check_ssd(gen):
    """The SSD scan kernel against its plain version on ``SSD_CASES``,
    each twice (bitwise equal); times the serving shape (cold L2).  Returns
    its JSON row."""
    errs = {label: _ssd_compare(gen, label, shape, chunk)
            for label, shape, chunk in SSD_CASES}
    _, shape, chunk = SSD_CASES[0]
    t = ssd_timings(gen, shape, chunk, plain=True)
    nbytes, ops = t["bytes"], t["ops"]
    row = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:82",
           "shape": f"x ({shape['B']}, {shape['S']}, {shape['H']}, 64) "
                    f"bf16, B/C G {shape['G']} N 128, chunk {chunk}",
           "timing": f"cold L2: cycles over {t['copies']} input copies; "
                     f"{TIMING}",
           "max_abs_err": errs["serve"],
           "tol": f"y {SSD_Y_TOL} of max |y|, state {SSD_H_TOL} of "
                  f"max |h|",
           "ms": t["ms"], "device_ms": t["device_ms"],
           "passes_ms": t["passes"], "plain_ms": t["plain_ms"],
           "library_ms": None, "library_device_ms": None,
           "library_note": "no single PyTorch call computes the SSD scan"}
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, "bf16")
    log(f"[kernels] ssd_scan serve: kernel {row['ms']:.4f} ms "
        f"(device time {row['device_ms']:.4f} ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in t["passes"].items())
        + f" ms under the profiler; "
        f"{t['host_ms'] * 1e3:.1f} us of host time a call), plain "
        f"{row['plain_ms']:.4f} ms, library none, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {nbytes / 1e6:.1f} "
        f"MB, {ops / 1e9:.2f} GFLOP)")
    return row


# the SSD gradient checks on the card, (label, shape, chunk): both
# instantiations (N 128, G 1 and N 64, G 2) over a ragged last chunk (256 +
# 44) with an initial state
SSD_GRAD_CASES = (
    ("N128 G1", dict(B=2, S=300, H=32, G=1, h0=True), SSD_CHUNK),
    ("N64 G2", dict(B=2, S=300, h0=True, **HYBRID_SSD), SSD_CHUNK))
# the training phases' SSD scans: a micro-batch of TRAIN_SEQ positions
SSD_TRAIN_SHAPES = {
    "mamba2-370m": dict(B=TRAIN_BATCH // TRAIN_ACCUM, S=TRAIN_SEQ, H=32, G=1),
    "zamba2-7b": dict(B=TRAIN_BATCH // TRAIN_ACCUM, S=TRAIN_SEQ,
                      **HYBRID_SSD)}


def phase_ssd_grads():
    """The SSD scan's autograd ``Function`` on the card (kernel forward,
    plain f32 backward), on ``SSD_GRAD_CASES``: its y and final state
    against ``ssd_ref`` (``_ssd_agree``), and the gradients of x, a, B, C
    and h0 through both against plain autograd of ``ssd_ref`` on the same
    bf16 inputs, each within ``SSD_GRAD_TOL`` of its largest |value| and
    finite; the ``Function`` launches the kernel once and its backward
    none.  The backward recomputes ``ssd_ref`` from the saved inputs, so
    the gradient check covers the dispatch and the dtypes; the forward
    check covers the kernel.  Then, at each training phase's shape, the
    kernel's y and final state, through the ``Function`` and the serving
    call, against ``ssd_ref``, and the forward kernel's time beside the
    plain backward's (y's gradient only, as the models take it).  Returns
    {model: plain backward ms}."""
    from repro_torch import kernels
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    for label, shape, chunk in SSD_GRAD_CASES:
        ops = _ssd_case(gen, **shape)
        wy = torch.randn(ops[0].shape, generator=gen, device="cuda")
        wh = torch.randn(ops[4].shape, generator=gen, device="cuda")

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in ops]
            y, h = fn(*leaves[:4], chunk, h0=leaves[4])
            ((y.float() * wy).sum() + (h * wh).sum()).backward()
            return [t.grad for t in leaves], y.detach(), h.detach()
        kernels.reset_launch_counts()
        got, y, h = grads(ssd_scan)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["ssd_scan"]
        ref, yr, hr = grads(ssd_ref)
        _ssd_agree("ssd_grads", f"{label} {shape} chunk {chunk}, the "
                   f"Function's forward", y, h, yr, hr)
        errs = {name: (float((g.float() - r.float()).abs().max()),
                       float(r.float().abs().max()))
                for name, g, r in zip(("x", "a", "B", "C", "h0"), got, ref)}
        ok = launches == 1 and all(
            e <= SSD_GRAD_TOL * sc for e, sc in errs.values()) and all(
            bool(torch.isfinite(g.float()).all()) for g in got) and all(
            g.dtype == t.dtype for g, t in zip(got, ops))
        log(f"[ssd_grads] {label} {shape} chunk {chunk}: kernel launches "
            f"{launches} (forward); " + ", ".join(
                f"d{k} max_abs_err {e:.3e} of max {sc:.3e}"
                for k, (e, sc) in errs.items())
            + f" (tol {SSD_GRAD_TOL} relative) ok={ok}")
        if not ok:
            raise AssertionError(f"ssd_scan Function gradients disagree with "
                                 f"plain autograd ({label})")
    out = {}
    for name, shape in SSD_TRAIN_SHAPES.items():
        x, a, Bm, Cm, _ = _ssd_case(gen, **shape)
        leaves = [t.clone().requires_grad_() for t in (x, a, Bm, Cm)]
        y, hf = ssd_scan(*leaves, SSD_CHUNK)
        ys, hs = ssd_scan(x, a, Bm, Cm, SSD_CHUNK)
        yr, hr = ssd_ref(x, a, Bm, Cm, SSD_CHUNK)
        label = f"{name} training shape {shape} chunk {SSD_CHUNK}"
        _ssd_agree("ssd_grads", f"{label}, the Function", y.detach(),
                   hf.detach(), yr, hr)
        _ssd_agree("ssd_grads", f"{label}, the serving call", ys, hs, yr, hr)
        del ys, hs, yr, hr
        fwd_ms = time_ms(lambda: ssd_scan(x, a, Bm, Cm, SSD_CHUNK), iters=10)
        dy = torch.randn(y.shape, generator=gen, device="cuda").bfloat16()
        torch.cuda.reset_peak_memory_stats()
        bwd_ms = time_ms(lambda: torch.autograd.grad(y, leaves, dy,
                                                     retain_graph=True),
                         iters=3, warmup=1)
        out[name] = bwd_ms
        log(f"[ssd_grads] {name} training shape {shape} chunk {SSD_CHUNK}: "
            f"forward kernel {fwd_ms:.4f} ms, plain f32 backward "
            f"{bwd_ms:.3f} ms ({bwd_ms / fwd_ms:.0f}x; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
        del x, a, Bm, Cm, leaves, y, hf, dy
    release()
    return out


def check_graph_replays(gen):
    """The kernels that launch a pass under programmatic dependent launch
    (PDL), inside a CUDA graph as the serving engine now runs them: paged
    decode (its combine pass) on bf16 and int8 pools at the serving
    positions, and the SSD scan (its carry and output passes) at the
    serving shape without and with an initial state.  Each replay must be
    bitwise equal to an eager call."""
    from repro_torch.kernels.flash_attention import paged_flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
        q, kp, vp, tables, pos, ks, vs = _paged_case(gen, dtype, L=1)
        kw = {} if ks is None else dict(k_scales=ks[0], v_scales=vs[0])
        same = graph_equal(lambda: paged_flash_decode(q, kp[0], vp[0], tables,
                                                      pos, **kw))
        log(f"[kernels] paged_decode {label} pool replayed from a CUDA "
            f"graph: bitwise equal to an eager call {same}")
        if not same:
            raise AssertionError(f"paged_decode ({label}): a graph replay "
                                 f"differs from an eager call")
    for label, shape, chunk in SSD_CASES[:2]:
        x, a, Bm, Cm, h0 = _ssd_case(gen, **shape)
        same = graph_equal(lambda: ssd_scan(x, a, Bm, Cm, chunk, h0=h0))
        log(f"[kernels] ssd_scan {label} replayed from a CUDA graph: bitwise "
            f"equal to an eager call {same}")
        if not same:
            raise AssertionError(f"ssd_scan ({label}): a graph replay "
                                 f"differs from an eager call")


# zamba2-7b's SSD scan: its serving bucket (B 8, S 512, H 112, G 2, N 64,
# chunk 256), with an initial state, and the buckets 32 and 128
HYBRID_SSD_CASES = (
    ("serve", dict(B=SERVE_SLOTS, S=512, **HYBRID_SSD), SSD_CHUNK),
    ("serve_h0", dict(B=SERVE_SLOTS, S=512, h0=True, **HYBRID_SSD),
     SSD_CHUNK),
    ("bucket32", dict(B=SERVE_SLOTS, S=32, **HYBRID_SSD), SSD_CHUNK),
    ("bucket128", dict(B=SERVE_SLOTS, S=128, **HYBRID_SSD), SSD_CHUNK))

#: the kernel rows of zamba2-7b's instantiations: the serving run whose
#: launches each reports (``phase_serve_hybrid``'s runs by page type)
HYBRID_ROW_RUNS = {"rmsnorm[d3584]": "bf16", "rmsnorm[d7168]": "bf16",
                   "flash_prefill[D224]": "bf16",
                   "paged_decode[bf16 D224]": "bf16",
                   "paged_decode[int8 D224]": "int8",
                   "ssd_scan[N64]": "bf16"}


def check_hybrid_kernels(gen):
    """zamba2-7b's instantiations of the four serving kernels, each against
    its plain version and twice (bitwise equal), timed (``ms``,
    ``device_ms``, ``graph_ms``) beside its bound and library yardstick:
    RMSNorm at d 3584 and 7168 (4096 rows; 8 rows logged); the prefill at
    head_dim 224 with one query head per KV head over the buckets 32, 128
    and 512 and a window over rows with no valid key; paged decode at head
    224 on bf16 and int8 pools (with ``check_paged``'s edges), replayed
    from a graph bitwise equal to eager; the SSD scan at state 64 with 2
    groups on ``HYBRID_SSD_CASES``, replayed from a graph likewise.
    Returns their JSON rows, each marked with the model."""
    from repro_torch.kernels.flash_attention import paged_flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    rows = []
    for d in (3584, 7168):
        row, ok = _rmsnorm_row(gen, SERVE_SLOTS * 512, d, f"rmsnorm[d{d}]")
        if not ok:
            raise AssertionError(f"rmsnorm kernel at d {d} disagrees with "
                                 f"its plain version")
        rows.append(row)
        t, (_, _, nc) = rmsnorm_timings(gen, SERVE_SLOTS, d)
        b_ms, _ = bound(2 * SERVE_SLOTS * d * 2 + d * 4,
                        4 * SERVE_SLOTS * d, "f32")
        log(f"[kernels] rmsnorm[d{d}] x ({SERVE_SLOTS}, {d}) bf16 ({nc} "
            f"input copies): {versus('kernel', t, 'F.rms_norm')}; bound "
            f"{b_ms:.4f} ms")
    H, KV, D = HYBRID_ATTN["H"], HYBRID_ATTN["KV"], HYBRID_ATTN["D"]
    for S in (32, 128, 512):
        row = _prefill_row(gen, SERVE_SLOTS, S, H, KV, D,
                           "flash_prefill[D224]", graph=True,
                           backend=S == 512)
    rows.append(row)                   # the longest bucket
    check_prefill_padded_window(gen, H, KV, D)
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
        q, kp, vp, tables, pos, ks, vs = _paged_case(gen, dtype, L=1,
                                                     **HYBRID_ATTN)
        kw = {} if ks is None else dict(k_scales=ks[0], v_scales=vs[0])
        same = graph_equal(lambda: paged_flash_decode(q, kp[0], vp[0], tables,
                                                      pos, **kw))
        log(f"[kernels] paged_decode {label} D224 pool replayed from a CUDA "
            f"graph: bitwise equal to an eager call {same}")
        if not same:
            raise AssertionError(f"paged_decode ({label} D224): a graph "
                                 f"replay differs from an eager call")
        rows.append(check_paged(gen, dtype, f"{label} D224", HYBRID_ATTN,
                                L=4))
    errs = {label: _ssd_compare(gen, f"N64 {label}", shape, chunk)
            for label, shape, chunk in HYBRID_SSD_CASES}
    for label, shape, chunk in HYBRID_SSD_CASES[:2]:
        x, a, Bm, Cm, h0 = _ssd_case(gen, **shape)
        same = graph_equal(lambda: ssd_scan(x, a, Bm, Cm, chunk, h0=h0))
        log(f"[kernels] ssd_scan N64 {label} replayed from a CUDA graph: "
            f"bitwise equal to an eager call {same}")
        if not same:
            raise AssertionError(f"ssd_scan (N64 {label}): a graph replay "
                                 f"differs from an eager call")
    _, shape, chunk = HYBRID_SSD_CASES[0]
    t = ssd_timings(gen, shape, chunk, plain=True, graph=True)
    row = {"name": "ssd_scan[N64]", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:82",
           "shape": f"x ({shape['B']}, {shape['S']}, {shape['H']}, 64) "
                    f"bf16, B/C G {shape['G']} N {shape['N']}, chunk {chunk}",
           "timing": f"cold L2: cycles over {t['copies']} input copies; "
                     f"{TIMING}; {GRAPH_TIMING}",
           "max_abs_err": errs["serve"],
           "tol": f"y {SSD_Y_TOL} of max |y|, state {SSD_H_TOL} of "
                  f"max |h|",
           "ms": t["ms"], "device_ms": t["device_ms"],
           "graph_ms": t["graph_ms"], "passes_ms": t["passes"],
           "plain_ms": t["plain_ms"], "library_ms": None,
           "library_device_ms": None,
           "library_note": "no single PyTorch call computes the SSD scan"}
    row["bound_ms"], row["bound_by"] = bound(t["bytes"], t["ops"], "bf16")
    log(f"[kernels] ssd_scan[N64] serve: kernel {row['ms']:.4f} ms (device "
        f"time {row['device_ms']:.4f} ms, replayed from a graph "
        f"{row['graph_ms']:.4f} ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in t["passes"].items())
        + f" ms under the profiler), plain {row['plain_ms']:.4f} ms, "
        f"library none, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
        f"{t['bytes'] / 1e6:.1f} MB, {t['ops'] / 1e9:.2f} GFLOP)")
    rows.append(row)
    for r in rows:
        r["model"] = "zamba2-7b"
    return rows


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    check_graph_replays(gen)
    rows = [check_rmsnorm(gen), check_prefill(gen),
            check_paged(gen, torch.bfloat16, "bf16"),
            check_paged(gen, torch.int8, "int8"), *check_flash_bwd(gen),
            check_ssd(gen), *check_hybrid_kernels(gen)]
    # zamba2-7b's training attention: head_dim 224, one query head per KV
    # head; its forward with lse is checked and logged, its backward row
    # goes in the JSON
    rows.append(check_flash_bwd(gen, **HYBRID_ATTN,
                                edges=((2, 200, 32, 32),), tag="[D224]")[1])
    rows[-1]["model"] = "zamba2-7b"
    # pools the serving path does not use: checked, logged, not in the JSON
    for dtype, label in ((torch.float8_e4m3fn, "fp8"), (torch.float32, "f32")):
        r = check_paged(gen, dtype, label)
        log(f"[kernels] {r['name']} (not on the serving path): "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{_ms(r['library_ms'])}, bound {r['bound_ms']:.4f} ms")
    for r in rows:
        log(f"[kernels] {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {_ms(r['library_ms'])}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def _ms(t) -> str:
    """A time for a log line; None where no library call exists."""
    return "none" if t is None else f"{t:.4f} ms"


# ---------------------------------------------------------------------------
# 4. serve at full width
# ---------------------------------------------------------------------------

class NanWatch:
    """Delegates to the model and ORs a device flag whenever prefill or
    decode logits hold a NaN (no host sync on the hot path)."""

    def __init__(self, model):
        self.model = model
        self.nan = torch.zeros((), dtype=torch.bool, device=model.device)

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kwargs):
        logits, cache = self.model.prefill(*args, **kwargs)
        self.nan |= torch.isnan(logits).any()
        return logits, cache

    def decode_step(self, *args, **kwargs):
        logits, cache = self.model.decode_step(*args, **kwargs)
        self.nan |= torch.isnan(logits).any()
        return logits, cache


def build_full_model():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} D={cfg.resolved_head_dim} "
        f"ff={cfg.d_ff} V={cfg.vocab_size} {cfg.compute_dtype}; "
        f"{n / 1e9:.3f}B params drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _n_buckets(prompts) -> int:
    """Prompt buckets a workload admits (the engine's own rule)."""
    from repro_torch.serve.engine import _bucket
    return len({min(_bucket(len(p)), SERVE_MAX_SEQ) for p in prompts})


def llama_launches(steps: int, calls: int, paged: bool = True) -> dict:
    """llama3.2-1b's exact launch counts: 33 RMSNorms a forward (two a
    layer and the final one), 16 prefill attentions a prefill call, 16
    paged decodes a decode step with paged KV."""
    return {"rmsnorm": 33 * (steps + calls), "flash_prefill": 16 * calls,
            "flash_bwd": 0, "paged_decode": 16 * steps if paged else 0,
            "ssd_scan": 0}


def serve_run(tag, model, params, prompts, new_tokens, graphs, want, **kw):
    """One ``ServeEngine`` (``cuda_graphs=graphs``, ``kw`` on top of the
    serving geometry) over ``prompts`` with ``new_tokens`` each, timed
    after a warm-up and ``reset()``.  With graphs the warm-up is the same
    workload, so that every variant is captured before the timed run;
    without, one short request.  Gates, each raising: the exact launch
    counts ``want(steps, prefill calls)`` of the timed run (and of the
    capturing run), every request finished, no NaN logit, and
    ``compile_stats`` within the reference's bound (at most log2(max_chunk)
    + 1 decode chunk variants, at most one prefill variant a bucket the
    engine served, warm-up included).
    Returns the runs' tokens, times, counts and graph statistics."""
    from repro_torch import kernels
    from repro_torch.serve import Request, ServeEngine
    mode = "graphs on" if graphs else "graphs off"
    torch.cuda.reset_peak_memory_stats()
    watch = NanWatch(model)
    eng = ServeEngine(watch, params, batch_slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ, page_size=SERVE_PAGE,
                      cuda_graphs=graphs, **kw)

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=new_tokens)
                for i, p in enumerate(prompts)]

    def run(reqs):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        expect = want(eng.n_decode_steps, eng.n_prefill_calls)
        if got != expect:
            raise AssertionError(f"{tag} ({mode}): launch counts {got} != "
                                 f"{expect}")
        if not all(r.done and len(r.generated) == new_tokens for r in reqs):
            raise AssertionError(f"{tag} ({mode}): not every request "
                                 f"finished")
        return wall, got, [r.generated for r in reqs]

    out, served = {}, list(prompts)
    if graphs:
        out["first_wall_s"], _, out["first_tokens"] = run(requests())
    else:
        served.append(prompts[0][:16])
        eng.generate([Request(uid=-1, prompt=served[-1], max_new_tokens=4)])
    eng.reset()
    out["wall_s"], out["launches"], out["tokens"] = run(requests())
    if bool(watch.nan):
        raise AssertionError(f"{tag} ({mode}): NaN in the logits")
    stats = eng.compile_stats
    limit = int(math.log2(eng.max_chunk)) + 1
    if stats["decode_chunk_variants"] > limit or \
            stats["prefill_bucket_variants"] > _n_buckets(served):
        raise AssertionError(f"{tag} ({mode}): compile_stats {stats} over "
                             f"the bound ({limit} decode chunk variants, "
                             f"{_n_buckets(served)} buckets served)")
    n_tok = sum(len(t) for t in out["tokens"])
    out.update(steps=eng.n_decode_steps, calls=eng.n_prefill_calls,
               tokens_per_s=n_tok / out["wall_s"], compile_stats=stats,
               graphs=eng.graph_stats(),
               peak_bytes=torch.cuda.max_memory_allocated())
    first = "" if not graphs else (
        f" (the capturing run before it: {out['first_wall_s']:.3f} s)")
    log(f"[{tag}] {mode}: {n_tok} tokens in {out['wall_s']:.3f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s{first}; {out['calls']} prefill "
        f"calls, {out['steps']} decode steps "
        f"({1e3 * out['wall_s'] / out['steps']:.2f} ms of wall per step, "
        f"prefill included); launches {out['launches']} (exact); "
        f"compile_stats {stats}; peak memory "
        f"{out['peak_bytes'] / 2**30:.2f} GiB")
    if out["graphs"]:
        g = out["graphs"]
        log(f"[{tag}] {mode}: {len(g)} graphs, pool "
            f"{sum(x['pool_bytes'] for x in g) / 2**20:.1f} MiB; capture "
            f"host ms " + ", ".join(
                f"{x['kind']}[{x['key']}] {x['capture_ms']:.1f} "
                f"(x{x['replays']})" for x in g))
    del eng, watch
    release()
    return out


def _same_tokens(tag, what, runs):
    """Raise unless every run of ``runs`` (graphs on: the capturing run
    and the timed one; graphs off: the timed one) gave the same tokens."""
    streams = []
    for r in runs:
        streams += [r["tokens"]] + ([r["first_tokens"]]
                                    if "first_tokens" in r else [])
    if any(s != streams[0] for s in streams):
        raise AssertionError(f"{tag} {what}: graphs on and off gave "
                             f"different tokens")
    log(f"[{tag}] {what}: graphs on and off gave identical tokens "
        f"({len(streams)} runs)")


def phase_serve(cfg, model, params):
    """llama3.2-1b with bf16 and int8 pages, each with CUDA graphs on and
    off in turns (on, off, off, on), the full workload; then a dense cache
    and a sampled run (temperature 0.8, seed 7), 8 requests of 16 new
    tokens, graphs on and off.  Every run's exact launch gates; equal
    tokens on and off.  Returns the graphs-on runs' launches by page
    type."""
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 513, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in plens]
    log(f"[serve] {SERVE_REQUESTS} requests, prompt lengths "
        f"{sorted(int(n) for n in plens)}, {SERVE_NEW_TOKENS} new tokens each")
    runs = {}
    for kv, graphs in ((None, True), (None, False), ("int8", False),
                       ("int8", True)):
        label = kv or "bf16"
        runs[label, graphs] = serve_run(
            f"serve {label} pages", model, params, prompts, SERVE_NEW_TOKENS,
            graphs, llama_launches, paged=True, kv_dtype=kv)
    for label in ("bf16", "int8"):
        on, off = runs[label, True], runs[label, False]
        _same_tokens("serve", f"{label} pages", (on, off))
        log(f"[serve] {label} pages: graphs on {on['tokens_per_s']:.1f} "
            f"tokens/s against off {off['tokens_per_s']:.1f} "
            f"({on['tokens_per_s'] / off['tokens_per_s']:.2f}x)")
    short = prompts[:SERVE_SLOTS]
    for what, kw in (("dense cache", dict(paged=False)),
                     ("sampled, bf16 pages", dict(paged=True,
                                                  temperature=0.8, seed=7))):
        want = (lambda s, c: llama_launches(s, c, paged=False)) \
            if not kw["paged"] else llama_launches
        pair = [serve_run(f"serve {what}", model, params, short, 16, g, want,
                          **kw) for g in (True, False)]
        _same_tokens("serve", what, pair)
    return {label: runs[label, True]["launches"] for label in ("bf16", "int8")}


def profiled_kernels(fn):
    """Run ``fn`` under ``torch.profiler``; (device us, count, name) of
    every device kernel it launched (kernel rows only: an operator's row
    would count its kernels twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    return [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def log_top(tag, rows, busy_ms, top=10):
    for us, count, key in sorted(rows, reverse=True)[:top]:
        log(f"[{tag}]   {us / 1e3:9.3f} ms  {100 * us / 1e3 / busy_ms:5.1f}%"
            f"  x{count:<6d} {key[:90]}")


# the port's serving kernels as the profiler names them; paged decode is
# its split kernel and the combine pass after it, the SSD scan its three
# passes
PROFILE_KERNELS = {"paged_decode": "paged_decode_",
                   "flash_prefill": "flash_prefill_",
                   "rmsnorm": "rmsnorm_kernel", "ssd_scan": "ssd_scan_"}


def phase_profile(cfg, model, params, top: int = 10, tag: str = "profile",
                  paged: bool = True, graphs: bool = True,
                  detail: bool = False, new_tokens: int = 32):
    """Where the time goes in a short serve run (8 prompts of 128 tokens,
    ``new_tokens`` each; bf16 pages, or the dense cache with
    ``paged=False``; CUDA graphs on or off): its wall time unprofiled, then
    its device kernels under ``torch.profiler`` (kernels replayed from a
    graph included).  With ``detail`` each instantiation of the port's
    kernels on its own line, and the decode steps alone: the same run's
    wall and device time less those of a run of the same prompts with one
    new token (its prefill and nothing else)."""
    from repro_torch.serve import Request, ServeEngine
    rng = np.random.default_rng(1)
    tag = f"{tag}, graphs {'on' if graphs else 'off'}"
    eng = ServeEngine(model, params, batch_slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ, paged=paged, page_size=SERVE_PAGE,
                      cuda_graphs=graphs)
    prompts = [rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
               for _ in range(SERVE_SLOTS)]

    def run(new=new_tokens):
        eng.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate([Request(uid=i, prompt=p, max_new_tokens=new)
                      for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run()                                            # warm-up, captures
    wall_ms = run()
    steps = eng.n_decode_steps
    rows = profiled_kernels(run)
    if not rows:
        log(f"[{tag}] device time: not measured (the profiler recorded no "
            f"device kernels); wall {wall_ms / steps:.2f} ms per step")
        del eng
        release()
        return
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    log(f"[{tag}] {cfg.name}: {SERVE_SLOTS} requests x 128 prompt x "
        f"{new_tokens} new tokens, {'bf16 pages' if paged else 'dense cache'}"
        f", 1 prefill "
        f"call + {steps} decode steps: wall "
        f"{wall_ms:.1f} ms unprofiled ({wall_ms / steps:.2f} ms per step), "
        f"device kernels {busy_ms:.1f} ms ({busy_ms / steps:.2f} ms per "
        f"step, {launches} launches = {launches / steps:.0f} per step), "
        f"device idle share {1 - busy_ms / wall_ms:.3f}")
    share = {k: (sum(r[0] for r in rows if name in r[2]) / 1e3,
                 sum(r[1] for r in rows if name in r[2]))
             for k, name in PROFILE_KERNELS.items()}
    log(f"[{tag}] the port's kernels: " + ", ".join(
        f"{k} {ms:.3f} ms ({100 * ms / busy_ms:.1f}%, x{n})"
        for k, (ms, n) in share.items()))
    if detail:
        log_top(f"{tag}, the port's kernels by instantiation",
                [r for r in rows
                 if any(n in r[2] for n in PROFILE_KERNELS.values())],
                busy_ms, top=len(rows))
        pre_wall = run(1)
        pre_rows = profiled_kernels(lambda: run(1))
        pre_busy = sum(r[0] for r in pre_rows) / 1e3
        dec_wall, dec_busy = wall_ms - pre_wall, busy_ms - pre_busy
        log(f"[{tag}] decode steps alone (less a prefill-only run: wall "
            f"{pre_wall:.1f} ms, device {pre_busy:.1f} ms): wall "
            f"{dec_wall / steps:.2f} ms a step, device "
            f"{dec_busy / steps:.2f} ms a step "
            f"({(launches - sum(r[1] for r in pre_rows)) / steps:.0f} "
            f"launches), device idle share {1 - dec_busy / dec_wall:.3f}")
    log_top(tag, rows, busy_ms, top)
    del eng
    release()


# ---------------------------------------------------------------------------
# 5. prefill / decode consistency
# ---------------------------------------------------------------------------

def phase_consistency(model, params, steps: int = 4):
    """Prefill P, then ``steps`` paged decode steps fed the greedy tokens,
    against the last-position logits of one prefill of P + those tokens."""
    from repro_torch.serve.kv_pages import PagedBatchState, write_prefill_pages
    rng = np.random.default_rng(5)
    plens = np.array([100, 37], np.int32)
    B, bucket = len(plens), 128
    dev = model.device
    prompts = np.zeros((B, bucket + steps), np.int32)
    for b, n in enumerate(plens):
        prompts[b, :n] = rng.integers(0, model.cfg.vocab_size, n)
    st = PagedBatchState(model, B, SERVE_MAX_SEQ, page_size=SERVE_PAGE)
    for b, n in enumerate(plens):
        st.pool.allocate(b, int(n) + steps)
    st.sync_tables()
    logits, sub = model.prefill(params, torch.tensor(prompts[:, :bucket],
                                                     device=dev),
                                prompt_lens=torch.tensor(plens, device=dev),
                                max_seq=SERVE_MAX_SEQ)
    tables_sub = st.pool.tables.copy()
    for b in range(B):
        tables_sub[b, st.pool.n_blocks[b]:] = st.pool.n_pages
    for key in ("k", "v"):
        write_prefill_pages(st.cache[key], sub[key], tables_sub)
    tokens = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.tensor(plens, device=dev)
    worst = 0.0
    for i in range(steps):
        for b in range(B):
            prompts[b, plens[b] + i] = int(tokens[b])
        logits, _ = model.decode_step(params, st.cache, tokens, pos,
                                      block_tables=st.tables_dev)
        ref, _ = model.prefill(params, torch.tensor(prompts, device=dev),
                               prompt_lens=torch.tensor(plens + i + 1,
                                                        device=dev),
                               max_seq=SERVE_MAX_SEQ)
        V = model.cfg.vocab_size
        gap = float((logits[:, :V].float() - ref[:, :V].float()).abs().max())
        scale = float(ref[:, :V].float().abs().max())
        worst = max(worst, gap / scale)
        log(f"[consistency] step {i}: max |decode - prefill| logits {gap:.4f}"
            f" (max |logit| {scale:.3f}, relative {gap / scale:.4f}); greedy "
            f"equal {torch.equal(logits.argmax(-1), ref.argmax(-1))}")
        tokens = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1
    if worst > CONSISTENCY_TOL:
        raise AssertionError(f"prefill/decode logits differ by {worst:.4f} of "
                             f"max |logit| > {CONSISTENCY_TOL}")
    log(f"[consistency] ok: worst relative gap {worst:.4f} <= "
        f"{CONSISTENCY_TOL}")
    return worst


# ---------------------------------------------------------------------------
# 5b. serve mamba2-370m at full width, and its prefill / decode consistency
# ---------------------------------------------------------------------------

def build_mamba_model():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("mamba2-370m")
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    s = cfg.ssm
    log(f"[serve_ssm] {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
        f"d_inner={model.d_inner} heads={model.nh}x{s.head_dim} "
        f"state={s.state_dim} groups={s.n_groups} conv={s.conv_width} "
        f"chunk={s.chunk_size} V={cfg.vocab_size} {cfg.compute_dtype}; "
        f"{n / 1e9:.3f}B params drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def mamba_launches(L: int):
    """mamba2-370m's exact launch counts, per forward: one RMSNorm before
    each block, one gate norm inside it, one final norm; one SSD scan per
    block and prefill call."""
    def want(steps, calls):
        return {"rmsnorm": (2 * L + 1) * (steps + calls), "flash_prefill": 0,
                "flash_bwd": 0, "paged_decode": 0, "ssd_scan": L * calls}
    return want


def phase_serve_ssm(cfg, model, params):
    """The llama serve phase's 16 requests through mamba2-370m, with the
    dense ``BatchState`` and with ``paged=True`` (an SSM pools nothing; the
    block tables only account), each with CUDA graphs on and off in turns:
    the same greedy tokens from all four, exact launch counts, no NaN
    logit.  Then the bucket-512 prefill of 8 rows timed as a direct
    ``model.prefill`` call and through the engine's memoized prefill entry
    (graphs on and off), and a short profiled run in both modes.  Returns
    the dense graphs-on run's launches."""
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 513, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in plens]
    log(f"[serve_ssm] {SERVE_REQUESTS} requests, prompt lengths "
        f"{sorted(int(n) for n in plens)}, {SERVE_NEW_TOKENS} new tokens each")
    want = mamba_launches(cfg.n_layers)
    runs = {}
    for label, graphs in (("dense", True), ("dense", False), ("paged", False),
                          ("paged", True)):
        runs[label, graphs] = serve_run(
            f"serve_ssm {label}", model, params, prompts, SERVE_NEW_TOKENS,
            graphs, want, paged=label == "paged")
    _same_tokens("serve_ssm", "dense and paged", list(runs.values()))
    for label in ("dense", "paged"):
        on, off = runs[label, True], runs[label, False]
        log(f"[serve_ssm] {label}: graphs on {on['tokens_per_s']:.1f} "
            f"tokens/s against off {off['tokens_per_s']:.1f} "
            f"({on['tokens_per_s'] / off['tokens_per_s']:.2f}x)")
    mamba_prefill_ms(cfg, model, params, rng)
    firsts = [engine_prefill_ms(cfg, model, params, g)["first"]
              for g in (True, False)]
    if firsts[0] != firsts[1]:
        raise AssertionError("mamba prefill entry: graphs on and off gave "
                             "different first tokens")
    for graphs in (True, False):
        phase_profile(cfg, model, params, tag="profile_ssm", paged=False,
                      graphs=graphs)
    return runs["dense", True]["launches"]


def engine_prefill_ms(cfg, model, params, graphs: bool, repeats: int = 3):
    """The bucket-512 prefill of ``mamba_prefill_ms``'s 8 ragged rows
    through the engine's memoized prefill entry (``_prefill_fn(512)``: the
    static buffers' uploads, then the graph's replay, or the eager body
    with ``graphs`` False), after a first call that captures: ``wall_ms``,
    ``host_ms`` and ``device_ms`` as ``mamba_prefill_ms`` takes them, and
    the rows' greedy first tokens."""
    from repro_torch.serve import ServeEngine
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 512)) \
        .astype(np.int32)
    meta = np.stack([np.linspace(16, 512, SERVE_SLOTS),
                     np.arange(SERVE_SLOTS),
                     np.full(SERVE_SLOTS, 2)]).astype(np.int32)
    eng = ServeEngine(model, params, batch_slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ, cuda_graphs=graphs)
    fn = eng._prefill_fn(512)

    def call():
        return fn(prompts, meta)[0]
    call()                                             # eager run, capture
    wall, host = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act = call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
    first = act[0].tolist()
    rows = profiled_kernels(lambda: (call(), torch.cuda.synchronize()))
    t = {"wall_ms": wall, "host_ms": host, "first": first,
         "device_ms": sum(r[0] for r in rows) / 1e3 if rows else None}
    dev = "not measured (no kernel rows)" if not rows \
        else f"{t['device_ms']:.2f} ms"
    log(f"[serve_ssm] prefill entry, bucket 512, graphs "
        f"{'on' if graphs else 'off'}: wall "
        f"{', '.join(f'{x:.2f}' for x in wall)} ms; host until the call "
        f"returns {', '.join(f'{x:.2f}' for x in host)} ms; device kernels "
        f"{dev} a call; compile_stats {eng.compile_stats}")
    del eng
    release()
    return t


def mamba_prefill_ms(cfg, model, params, rng, repeats: int = 3):
    """One prefill call of the largest bucket, 8 rows of 512 with ragged
    lengths, after a warm-up call, ``repeats`` times: ``wall_ms`` (host
    clock around a synchronised call) and ``host_ms`` (until the call
    returns, the host's share while the device runs behind it); then one
    call under ``torch.profiler``: ``device_ms`` (its device kernels' busy
    time) and ``ssd_ms`` (the SSD scan's share).  Raises on a non-finite
    logit."""
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 512)),
                        dtype=torch.int32, device="cuda")
    lens = torch.tensor(np.linspace(16, 512, SERVE_SLOTS).astype(np.int32),
                        device="cuda")

    def call():
        return model.prefill(params, toks, prompt_lens=lens)[0]
    call()                                                     # warm-up
    wall, host = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
    rows = profiled_kernels(lambda: (call(), torch.cuda.synchronize()))
    t = {"wall_ms": wall, "host_ms": host,
         "device_ms": sum(r[0] for r in rows) / 1e3,
         "ssd_ms": sum(r[0] for r in rows if "ssd_scan" in r[2]) / 1e3}
    finite = bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
    log(f"[serve_ssm] prefill of {SERVE_SLOTS} rows x 512 (lengths "
        f"{lens.tolist()}): wall {', '.join(f'{x:.2f}' for x in wall)} ms; "
        f"host until the call returns {', '.join(f'{x:.2f}' for x in host)}"
        f" ms; device kernels {t['device_ms']:.2f} ms a call, the SSD scan "
        f"{t['ssd_ms']:.2f} ms of it; logits finite {finite}")
    if not finite:
        raise AssertionError("mamba prefill: non-finite logits")
    return t


def _install_pages(model, sub, plens, steps):
    """A prefill's sub-cache (rows of ``plens`` valid positions) in a fresh
    bf16 page pool with room for ``steps`` more tokens a row, installed as
    the engine installs it: paged leaves through ``write_prefill_pages``,
    the rest as dense slot rows.  Returns (cache, device block tables)."""
    from repro_torch.serve.kv_pages import PagedBatchState, write_prefill_pages
    st = PagedBatchState(model, len(plens), SERVE_MAX_SEQ,
                         page_size=SERVE_PAGE)
    for b, n in enumerate(plens):
        st.pool.allocate(b, int(n) + steps)
    st.sync_tables()
    tables_sub = st.pool.tables.copy()
    for b in range(len(plens)):
        tables_sub[b, st.pool.n_blocks[b]:] = st.pool.n_pages
    for key in st.cache:
        if key in model.paged_cache_keys():
            write_prefill_pages(st.cache[key], sub[key], tables_sub)
        else:
            st.cache[key].copy_(sub[key])
    return st.cache, st.tables_dev


def phase_consistency_ssm(model, params, steps: int = 4,
                          tag: str = "consistency_ssm", max_seq=None,
                          paged: bool = False):
    """Prefill 300 positions (chunks of 256 and a ragged 44; rows of 300
    and 137 valid positions), then ``steps`` decode steps fed the greedy
    tokens, against the last-position logits of one prefill of the prompt
    and those tokens: the kernel's final state and the conv tail carry the
    decode (and, for the hybrid, its KV cache of ``max_seq`` positions:
    dense, or with ``paged`` installed into bf16 pages, as the engine
    installs it, and read by the paged decode kernel)."""
    rng = np.random.default_rng(5)
    plens = np.array([300, 137], np.int32)
    B, S0 = len(plens), int(plens.max())
    dev = model.device
    prompts = np.zeros((B, S0 + steps), np.int32)
    for b, n in enumerate(plens):
        prompts[b, :n] = rng.integers(0, model.cfg.vocab_size, n)
    logits, cache = model.prefill(params, torch.tensor(prompts[:, :S0],
                                                       device=dev),
                                  prompt_lens=torch.tensor(plens, device=dev),
                                  max_seq=max_seq)
    tables = None
    if paged:
        cache, tables = _install_pages(model, cache, plens, steps)
    tokens = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.tensor(plens, device=dev)
    V = model.cfg.vocab_size
    worst = 0.0
    for i in range(steps):
        for b in range(B):
            prompts[b, plens[b] + i] = int(tokens[b])
        logits, cache = model.decode_step(params, cache, tokens, pos,
                                          block_tables=tables)
        ref, _ = model.prefill(params,
                               torch.tensor(prompts[:, :S0 + i + 1],
                                            device=dev),
                               prompt_lens=torch.tensor(plens + i + 1,
                                                        device=dev))
        gap = float((logits[:, :V].float() - ref[:, :V].float()).abs().max())
        scale = float(ref[:, :V].float().abs().max())
        worst = max(worst, gap / scale)
        log(f"[{tag}] step {i}: max |decode - prefill| logits "
            f"{gap:.4f} (max |logit| {scale:.3f}, relative {gap / scale:.4f});"
            f" greedy equal {torch.equal(logits.argmax(-1), ref.argmax(-1))}")
        tokens = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1
    if not worst <= CONSISTENCY_TOL:
        raise AssertionError(f"prefill/decode logits differ by {worst:.4f} of "
                             f"max |logit| > {CONSISTENCY_TOL}")
    log(f"[{tag}] ok: worst relative gap {worst:.4f} <= {CONSISTENCY_TOL}")
    return worst


# ---------------------------------------------------------------------------
# 5c. serve zamba2-7b (the hybrid) at full width, and its consistency
# ---------------------------------------------------------------------------

def build_hybrid_model():
    """zamba2-7b at full width and depth with random weights from a seeded
    generator (built after the earlier models are freed)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("zamba2-7b")
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    s = cfg.ssm
    log(f"[serve_hybrid] {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
        f"d_inner={model.d_inner} heads={model.nh}x{s.head_dim} "
        f"state={s.state_dim} groups={s.n_groups} chunk={s.chunk_size}; "
        f"shared block every {cfg.attn_every} ({model.n_attn} applications)"
        f" H={cfg.n_heads}/{cfg.n_kv_heads} D={model.attn_head_dim} "
        f"ff={cfg.d_ff} V={cfg.vocab_size} {cfg.compute_dtype}; "
        f"{n / 1e9:.3f}B params ({nbytes / 1e9:.2f} GB) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def hybrid_launches(cfg, model, paged: bool):
    """zamba2-7b's exact launch counts: per forward 2 L + 2 n_attn + 1
    RMSNorms (191: a norm before each Mamba2 block and its gate norm, two
    in each application of the shared block, the final norm); per prefill
    call L SSD scans and n_attn prefill attentions; per decode step n_attn
    paged decodes on pages, none on a dense cache."""
    L, A = cfg.n_layers, model.n_attn

    def want(steps, calls):
        return {"rmsnorm": (2 * L + 2 * A + 1) * (steps + calls),
                "flash_prefill": A * calls, "flash_bwd": 0,
                "paged_decode": A * steps if paged else 0,
                "ssd_scan": L * calls}
    return want


def phase_serve_hybrid(cfg, model, params):
    """zamba2-7b serves 8 seeded requests (24-498 prompt tokens, 32 new
    tokens each) with bf16 pages (CUDA graphs on and off), int8 pages
    (graphs on) and a dense cache (graphs on and off): the same greedy
    tokens with graphs on and off and from the dense cache and bf16 pages,
    exact launch counts, no NaN logit; logs tokens/s, peak memory and the
    graph pool.  Then a short profiled run with bf16 pages in both modes.
    Returns the graphs-on runs' launches by page type."""
    rng = np.random.default_rng(0)
    plens = rng.integers(24, 499, HYBRID_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in plens]
    log(f"[serve_hybrid] {HYBRID_REQUESTS} requests, prompt lengths "
        f"{sorted(int(n) for n in plens)}, {HYBRID_NEW_TOKENS} new tokens "
        f"each")
    runs = {}
    for label, graphs, kw in (
            ("bf16", True, dict(paged=True)),
            ("bf16", False, dict(paged=True)),
            ("int8", True, dict(paged=True, kv_dtype="int8")),
            ("dense", True, dict(paged=False)),
            ("dense", False, dict(paged=False))):
        runs[label, graphs] = serve_run(
            f"serve_hybrid {label}", model, params, prompts,
            HYBRID_NEW_TOKENS, graphs,
            hybrid_launches(cfg, model, kw["paged"]), **kw)
    for label in ("bf16", "dense"):
        _same_tokens("serve_hybrid", f"{label}",
                     [runs[label, True], runs[label, False]])
    _same_tokens("serve_hybrid", "int8 pages (its capturing and timed "
                 "runs)", [runs["int8", True]])
    # the dense and paged paths scale q as the reference's do, in bf16 by
    # a factor rounded to bf16 and in f32: at head_dim 224 they differ by
    # an ulp, so their greedy tokens may part (consistency_hybrid holds
    # both paths against one longer prefill); logged, as int8 is
    for other, why in (("dense", "q scaled in bf16 against f32 on pages"),
                       ("int8", "quantized KV")):
        a, b = runs[other, True]["tokens"], runs["bf16", True]["tokens"]
        same = [sum(x == y for x, y in zip(ra, rb)) for ra, rb in zip(a, b)]
        first = [next((i for i, (x, y) in enumerate(zip(ra, rb)) if x != y),
                      None) for ra, rb in zip(a, b)]
        log(f"[serve_hybrid] {other} against bf16 pages ({why}): "
            f"{sum(same)} of {sum(len(r) for r in b)} greedy tokens equal; "
            f"first difference by request {first}")
    for label in ("bf16", "dense"):
        on, off = runs[label, True], runs[label, False]
        log(f"[serve_hybrid] {label}: graphs on {on['tokens_per_s']:.1f} "
            f"tokens/s against off {off['tokens_per_s']:.1f} "
            f"({on['tokens_per_s'] / off['tokens_per_s']:.2f}x)")
    # 8 new tokens (7 decode steps): the profiler's cost grows with the
    # ~5000 kernels of each step
    for graphs in (True, False):
        phase_profile(cfg, model, params, tag="profile_hybrid", paged=True,
                      graphs=graphs, detail=True, new_tokens=8)
    return {label: runs[label, True]["launches"] for label in ("bf16", "int8")}


def phase_consistency_hybrid(model, params, steps: int = 4):
    """``phase_consistency_ssm``'s prefill of 300 positions (two SSD
    chunks, the last ragged) and decode steps through zamba2-7b, on a
    dense cache of ``SERVE_MAX_SEQ`` positions and on bf16 pages, each
    within ``CONSISTENCY_TOL`` of the longer prefill."""
    return [phase_consistency_ssm(model, params, steps,
                                  tag=f"consistency_hybrid, {what}",
                                  max_seq=SERVE_MAX_SEQ, paged=paged)
            for what, paged in (("dense cache", False),
                                ("bf16 pages", True))]


# ---------------------------------------------------------------------------
# 6. train at full width, 7. Trainer restart at a small width
# ---------------------------------------------------------------------------

def train_model(tag, cfg, describe, per_step, ours):
    """Train ``cfg`` on the card for ``TRAIN_STEPS`` steps through
    ``make_train_step`` (f32 masters, bf16 compute, AdamW, remat; seq
    ``TRAIN_SEQ``, global batch ``TRAIN_BATCH`` as ``TRAIN_ACCUM``
    micro-batches)
    on the port's ``DataPipeline``: a finite non-zero gradient on every
    parameter leaf after the first backward, finite losses, exactly
    ``per_step`` launches a step; logs step ms, tokens/s and peak memory,
    then profiles one more step (device idle share, the time of the port's
    kernels by the name fragments in ``ours``, the top kernels).  The model
    is freed before it returns.  Returns {"counts": the launches of the
    timed steps, "step_ms": the last timed step's ms, "tokens_per_s",
    "peak_gib", "idle"}."""
    from repro_torch import kernels
    from repro_torch.data import DataPipeline
    from repro_torch.models import build_model
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   loss_and_grads, make_train_step)
    from repro_torch.tree import flatten
    model = build_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, seed=0)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in flatten(state.params))
    log(f"[{tag}] {cfg.name}: {describe(model)} V={cfg.vocab_size}; "
        f"{n / 1e9:.3f}B params in {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}; state drawn in "
        f"{time.perf_counter() - t0:.1f} s; seq {TRAIN_SEQ}, global batch "
        f"{TRAIN_BATCH} = {TRAIN_ACCUM} x {TRAIN_BATCH // TRAIN_ACCUM}, AdamW, "
        f"remat")
    pipeline = DataPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [pipeline.next_batch() for _ in range(TRAIN_STEPS)]

    # every leaf gets a finite, non-zero gradient from the first backward
    micro = {k: v[:TRAIN_BATCH // TRAIN_ACCUM] for k, v in batches[0].items()}
    _, _, grads = loss_and_grads(model, state.params, micro, remat=True)
    named = flatten(grads)
    norms = torch.stack([g.float().norm() for _, g in named]).tolist()
    bad = [(p, nrm) for (p, _), nrm in zip(named, norms)
           if not (math.isfinite(nrm) and nrm > 0)]
    log(f"[{tag}] first backward: {len(named)} parameter leaves, gradient "
        f"norms {min(norms):.3e}..{max(norms):.3e}; leaves without a finite "
        f"non-zero gradient: {bad}")
    if bad:
        raise AssertionError(f"parameters without a gradient: {bad}")
    del grads, named

    step_fn = make_train_step(model, OptimizerConfig(lr=3e-4, warmup_steps=2),
                              accum_steps=TRAIN_ACCUM, remat=True)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    before = kernels.launch_counts()
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        now = kernels.launch_counts()
        step_counts = {k: now[k] - before[k] for k in now}
        before = now
        log(f"[{tag}] step {i}: loss {loss:.4f}, grad_norm "
            f"{float(metrics['grad_norm']):.3f}, {dt * 1e3:.1f} ms, "
            f"{tokens / dt:.1f} tokens/s; launches {step_counts}")
        if not math.isfinite(loss):
            raise AssertionError(f"step {i}: loss {loss} is not finite")
        if step_counts != per_step:
            raise AssertionError(f"step {i}: launch counts {step_counts} != "
                                 f"{per_step}")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] {TRAIN_STEPS} steps: launches {counts}; peak device "
        f"memory {peak:.2f} GiB")
    out = {"counts": counts, "step_ms": dt * 1e3, "tokens_per_s": tokens / dt,
           "peak_gib": peak, "idle": None}

    # where the time of one more step goes, against the last timed step
    def one_step():
        nonlocal state
        state, metrics = step_fn(state, batches[-1])
        float(metrics["loss"])
    rows = profiled_kernels(one_step)
    if not rows:
        log(f"[{tag}] device time: not measured (the profiler recorded no "
            f"device kernels)")
    else:
        busy_ms = sum(r[0] for r in rows) / 1e3
        share = {k: sum(r[0] for r in rows if name in r[2]) / 1e3
                 for k, name in ours.items()}
        out["idle"] = 1 - busy_ms / (dt * 1e3)
        log(f"[{tag}] profiled step: device kernels {busy_ms:.1f} ms "
            f"({sum(r[1] for r in rows)} launches) against {dt * 1e3:.1f} ms "
            f"of wall time unprofiled (the last timed step): device idle "
            f"share {out['idle']:.3f}; the port's kernels "
            + ", ".join(f"{k} {v:.1f} ms ({100 * v / busy_ms:.1f}%)"
                        for k, v in share.items()))
        log_top(tag, rows, busy_ms)
    del state, model, step_fn
    release()
    return out


def phase_train():
    """Train llama3.2-1b at full width and depth for ``TRAIN_STEPS`` steps
    through ``make_train_step``.  Returns the launch counts of those
    steps."""
    from repro_torch.configs import get_config
    # per step: 2 micro-batches x (33 norms forward + 32 recomputed under
    # remat; the final norm sits outside the checkpoint), x (16 attention
    # forwards + 16 recomputed), x 16 attention backwards
    per_step = {"rmsnorm": TRAIN_ACCUM * (33 + 32),
                "flash_prefill": TRAIN_ACCUM * (16 + 16),
                "flash_bwd": TRAIN_ACCUM * 16, "paged_decode": 0,
                "ssd_scan": 0}
    ours = {"flash_bwd": "flash_bwd_",
            "flash_bwd dK/dV": "flash_bwd_dkv_kernel",
            "flash_bwd dQ": "flash_bwd_dq_kernel",
            "flash_bwd delta": "flash_bwd_delta_kernel",
            "flash_prefill": "flash_prefill_kernel",
            "rmsnorm": "rmsnorm_kernel"}

    def describe(m):
        c = m.cfg
        return (f"L={c.n_layers} d={c.d_model} H={c.n_heads}/{c.n_kv_heads} "
                f"D={c.resolved_head_dim}")
    return train_model("train", get_config("llama3.2-1b"), describe,
                       per_step, ours)["counts"]


def _ssd_share(tag, out, bwd_ms, calls):
    """Logs the plain SSD backward's share of a step, computed from its
    time at the step's shape (``phase_ssd_grads``) times its calls."""
    share = bwd_ms * calls / out["step_ms"]
    log(f"[{tag}] the plain SSD backward: {calls} calls a step x "
        f"{bwd_ms:.3f} ms (timed alone at the step's shape) = "
        f"{bwd_ms * calls:.1f} ms, {share:.3f} of the last timed step's "
        f"{out['step_ms']:.1f} ms (computed)")
    out["ssd_bwd_share"] = share
    return out


def phase_train_ssm(ssd_bwd_ms):
    """Train mamba2-370m at full width and depth (48 layers) as
    ``phase_train`` trains llama3.2-1b.  Per micro-batch, counted from the
    code: 2 L + 1 RMSNorms forward (a norm before each block, its gate
    norm, the final norm) and 2 L recomputed under remat, L SSD scans
    forward and L recomputed; no attention.  Returns ``train_model``'s
    summary with the plain SSD backward's share of a step."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-370m")
    L = cfg.n_layers
    per_step = {"rmsnorm": TRAIN_ACCUM * ((2 * L + 1) + 2 * L),
                "flash_prefill": 0, "flash_bwd": 0, "paged_decode": 0,
                "ssd_scan": TRAIN_ACCUM * (L + L)}
    ours = {"ssd_scan (forward)": "ssd_scan_", "rmsnorm": "rmsnorm_kernel"}

    def describe(m):
        s = m.cfg.ssm
        return (f"L={m.cfg.n_layers} d={m.cfg.d_model} d_inner={m.d_inner} "
                f"heads={m.nh}x{s.head_dim} state={s.state_dim} "
                f"groups={s.n_groups} chunk={s.chunk_size}")
    out = train_model("train_ssm", cfg, describe, per_step, ours)
    return _ssd_share("train_ssm", out, ssd_bwd_ms, TRAIN_ACCUM * L)


def phase_train_hybrid(ssd_bwd_ms):
    """Train zamba2-7b at full width with its depth cut to
    ``HYBRID_TRAIN_LAYERS`` (the reason beside the constant) as
    ``phase_train`` trains llama3.2-1b.  Per micro-batch, counted from the
    code: 2 L + 2 A + 1 RMSNorms forward (A applications of the shared
    block) and, under remat, those of the full groups again (2 per Mamba2
    block, 2 per application; the tail and its application run outside
    the checkpoint); L SSD scans forward and the groups' again; A flash
    forwards with their log-sum-exp and the groups' again; A flash
    backwards at head_dim 224.  Returns ``train_model``'s summary with the
    plain SSD backward's share of a step."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("zamba2-7b"),
                              n_layers=HYBRID_TRAIN_LAYERS)
    # as HybridLM counts them: full groups, the tail, shared applications
    L = cfg.n_layers
    groups, tail = divmod(L, cfg.attn_every)
    A = groups + (1 if tail else 0)
    in_groups = groups * cfg.attn_every
    log(f"[train_hybrid] {cfg.name} at {L} of 81 layers ({groups} groups of "
        f"{cfg.attn_every}, a tail of {tail}, the shared block "
        f"applied {A} times): at 81 its f32 masters, gradients and AdamW "
        f"moments alone would need ~111 GB of the card's 80 GB")
    per_step = {"rmsnorm": TRAIN_ACCUM * ((2 * L + 2 * A + 1)
                                          + 2 * in_groups + 2 * groups),
                "flash_prefill": TRAIN_ACCUM * (A + groups),
                "flash_bwd": TRAIN_ACCUM * A, "paged_decode": 0,
                "ssd_scan": TRAIN_ACCUM * (L + in_groups)}
    ours = {"flash_bwd (D224)": "flash_bwd_",
            "flash_bwd dK/dV": "flash_bwd_dkv_wide_kernel",
            "flash_bwd dQ": "flash_bwd_dq_wide_kernel",
            "flash_bwd pre-pass": "flash_bwd_prep_kernel",
            "flash_prefill (D224, lse)": "flash_prefill_wide_kernel",
            "ssd_scan (forward)": "ssd_scan_", "rmsnorm": "rmsnorm_kernel"}

    def describe(m):
        s = m.cfg.ssm
        return (f"L={m.cfg.n_layers} d={m.cfg.d_model} d_inner={m.d_inner} "
                f"heads={m.nh}x{s.head_dim} state={s.state_dim} "
                f"groups={s.n_groups}; shared block every "
                f"{m.cfg.attn_every} ({m.n_attn} applications) "
                f"H={m.cfg.n_heads}/{m.cfg.n_kv_heads} D={m.attn_head_dim} "
                f"ff={m.cfg.d_ff}")
    out = train_model("train_hybrid", cfg, describe, per_step, ours)
    return _ssd_share("train_hybrid", out, ssd_bwd_ms, TRAIN_ACCUM * L)


def phase_trainer():
    """``Trainer.run()`` at a small width on the card with an injected
    failure at step 3: it restarts from the step-2 checkpoint and
    finishes."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.models import build_model
    from repro_torch.runtime import FailureInjector
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train.loop import Trainer, TrainerConfig
    # llama3.2-1b's family at a small width that keeps what the kernels are
    # built for: bf16 compute and head_dim 64 (RMSNorm is built for d 256)
    cfg = dataclasses.replace(get_config("llama3.2-1b"), name="llama-small",
                              n_layers=2, d_model=256, n_heads=4,
                              n_kv_heads=2, head_dim=64, d_ff=1024,
                              vocab_size=257)
    model = build_model(cfg, device="cuda")
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckpt_dir:
        trainer = Trainer(
            model, make_train_step(model, OptimizerConfig(
                lr=1e-2, warmup_steps=2, decay_steps=100), accum_steps=2,
                remat=True),
            DataPipeline(cfg.vocab_size, 4, 128),
            CheckpointManager(ckpt_dir, keep=2),
            TrainerConfig(total_steps=6, ckpt_every=2, max_restarts=2),
            failure_injector=FailureInjector((3,)))
        out = trainer.run()
    losses = [(h["step"], round(h["loss"], 4)) for h in trainer.history]
    log(f"[trainer] {cfg.name} on {model.device}: {out}; (step, loss) "
        f"{losses}")
    if out["restarts"] != 1 or out["final_step"] != 6 \
            or [h["step"] for h in trainer.history] != [0, 1, 2, 2, 3, 4, 5] \
            or not all(math.isfinite(h["loss"]) for h in trainer.history):
        raise AssertionError(f"Trainer did not restart and finish: {out}")
    return out


def main() -> int:
    smi = phase_device()
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"[time] {name}: {seconds[name]:.1f} s")
        return out
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    cfg, model, params = build_full_model()
    serve = timed("serve", phase_serve, cfg, model, params)
    timed("profile", lambda: [phase_profile(cfg, model, params, graphs=g)
                              for g in (True, False)])
    timed("consistency", phase_consistency, model, params)
    del model, params
    release()
    cfg, model, params = build_mamba_model()
    serve_ssm = timed("serve_ssm", phase_serve_ssm, cfg, model, params)
    timed("consistency_ssm", phase_consistency_ssm, model, params)
    del model, params
    release()
    train = timed("train", phase_train)
    timed("trainer", phase_trainer)
    release()
    cfg, model, params = timed("build_hybrid", build_hybrid_model)
    hybrid = timed("serve_hybrid", phase_serve_hybrid, cfg, model, params)
    timed("consistency_hybrid", phase_consistency_hybrid, model, params)
    del model, params
    release()
    ssd_bwd = timed("ssd_grads", phase_ssd_grads)
    timed("train_ssm", phase_train_ssm, ssd_bwd["mamba2-370m"])
    train_hybrid = timed("train_hybrid", phase_train_hybrid,
                         ssd_bwd["zamba2-7b"])["counts"]
    # each kernel's launches on the path it serves: paged decode's in one
    # serve run of its page type, the serving prefill's in a bf16-page run,
    # the others' in the training run (the forward with its log-sum-exp
    # counts as flash_prefill); zamba2-7b's instantiations in one of its
    # serve runs (RMSNorm: both widths, 82 a forward at d 3584 and 109 at
    # 7168, counted from the code), its flash backward in its training run
    for row in rows:
        name, _, tag = row["name"].partition("[")
        tag = tag.rstrip("]")
        if row["name"] == "flash_bwd[D224]":
            row["launches"] = train_hybrid[name]
            row["launches_of"] = (f"one zamba2-7b training run at "
                                  f"{HYBRID_TRAIN_LAYERS} layers, "
                                  f"{TRAIN_STEPS} steps")
        elif row.get("model") == "zamba2-7b":
            run = HYBRID_ROW_RUNS[row["name"]]
            row["launches"] = hybrid[run][name]
            row["launches_of"] = (f"one zamba2-7b serve run, {run} pages, "
                                  f"CUDA graphs"
                                  + (" (both widths)" if name == "rmsnorm"
                                     else ""))
        elif name == "paged_decode":
            row["launches"] = serve[tag][name]
            row["launches_of"] = f"one serve run, {tag} pages, CUDA graphs"
        elif name == "ssd_scan":
            row["launches"] = serve_ssm[name]
            row["launches_of"] = ("one mamba2-370m serve run, dense cache, "
                                  "CUDA graphs")
        elif name == "flash_prefill":
            row["launches"] = serve["bf16"][name]
            row["launches_of"] = "one serve run, bf16 pages, CUDA graphs"
        else:
            name = name.removesuffix("_lse")
            row["launches"] = train[name]
            row["launches_of"] = (f"one training run, {TRAIN_STEPS} steps "
                                  f"(one serve run: {serve['bf16'][name]})"
                                  if name == "rmsnorm" else
                                  f"one training run, {TRAIN_STEPS} steps")
        row["kernel_ms"] = row["ms"]
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never ran on the main path")
    log(f"[done] {time.perf_counter() - t0:.1f} s after the device check "
        f"({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}); card "
        f"{smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
