"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  Each source is
compiled to an object by its own ``nvcc`` process, all started together,
then one ``nvcc -shared`` links them.  The library lands in
``build/repro_torch/`` at the repository root, named after a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  The build runs at the first kernel launch, never at import: a
machine without ``nvcc`` imports every module and runs the plain versions.

Calling convention of every C entry point: device pointers and the CUDA
stream travel as ``c_void_p``, sizes as ``c_int``/``c_longlong``, and the
return value is ``cudaGetLastError()`` right after the launch; the Python
wrappers raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
# src/repro_torch/kernels -> repository root
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    _HERE))), "build", "repro_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: C signature of every entry point (all return ``int`` = cudaError_t)
SIGNATURES: Dict[str, list] = {
    # x, w, out, rows, d, eps, dtype, stream
    "rmsnorm_launch": [_P, _P, _P, _I, _I, _F, _I, _P],
    # q, k_pages, v_pages, tables, pos, k_scales, v_scales, workspace, out,
    # B, H, KV, D, page, nb, keys_per_split, window, softcap, q_dtype,
    # kv_dtype, stream
    "paged_decode_launch": [_P] * 9 + [_I] * 8 + [_F, _I, _I, _P],
    # q, k, v, kv_valid_len, out, lse (or null), B, Sq, Sk, H, KV, D,
    # q/k/v/o strides (batch, seq, head) in elements,
    # causal, window, softcap, dtype, stream
    "flash_prefill_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                             _I, _I, _F, _I, _P],
    # q, k, v, o, dout, lse, delta scratch, scaled-q scratch (or null at
    # head_dim 64), dq, dk, dv, B, Sq, Sk, H, KV, D, causal, window, dtype,
    # stream
    "flash_bwd_launch": [_P] * 11 + [_I] * 9 + [_P],
    # x, a, B, C, h0 (or null), workspace, y, h_final, B, S, H, G, N, P,
    # chunk, stream
    "ssd_scan_launch": [_P] * 8 + [_I] * 7 + [_P],
    "kernels_error_string": [_I],
}

#: dtype codes shared with the C sources (``csrc/common.cuh``)
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "float8_e4m3fn": 3}
_CODE_OF = {getattr(torch, name): code for name, code in DTYPE_CODES.items()}


class _Library:
    """The loaded kernel library and how it was built."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.path = ""
        self.build_seconds = 0.0
        self.compiler_log = ""


_LIBRARY = _Library()


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels cannot be built on this machine")
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(path: str) -> str:
    sources = _sources()
    units = [s for s in sources if s.endswith(".cu")]
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        t0 = time.perf_counter()
        for src in units:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            with open(obj + ".log", "w") as out:
                procs.append((src, obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj],
                    stdout=out, stderr=subprocess.STDOUT)))
        seconds: Dict[str, float] = {}
        while len(seconds) < len(procs):
            for src, _, proc in procs:
                if src not in seconds and proc.poll() is not None:
                    seconds[src] = time.perf_counter() - t0
            time.sleep(0.05)
        failed = []
        for src, obj, proc in procs:
            with open(obj + ".log") as f:
                logs.append(f"== {os.path.basename(src)} "
                            f"({seconds[src]:.1f} s)\n{f.read()}")
            if proc.returncode:
                failed.append(os.path.basename(src))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        partial = os.path.join(tmp, os.path.basename(path))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", partial, *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # atomic publish: a concurrent builder sees a whole file or none
        os.replace(partial, path)
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use (thread-unsafe by design:
    the serving engine launches from one thread)."""
    if _LIBRARY.lib is not None:
        return _LIBRARY.lib
    sources = _sources()
    path = os.path.join(BUILD_DIR, f"libkernels_{_digest(sources)}.so")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        _LIBRARY.compiler_log = _compile(path)
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernels_error_string.restype = ctypes.c_char_p
    _LIBRARY.lib = lib
    _LIBRARY.path = path
    _LIBRARY.build_seconds = time.perf_counter() - t0
    return lib


def build_info() -> Dict[str, object]:
    """Where the library is, how long loading (and building) took, and the
    compiler's resource report (registers, shared memory, spills)."""
    library()
    return {"path": _LIBRARY.path, "seconds": _LIBRARY.build_seconds,
            "compiler_log": _LIBRARY.compiler_log}


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err:
        what = library().kernels_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({what}) at launch")


def dtype_code(t) -> int:
    """The C sources' code for a tensor's dtype; raises on other dtypes."""
    code = _CODE_OF.get(t.dtype)
    if code is None:
        raise TypeError(f"dtype {t.dtype} has no kernel instantiation")
    return code


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor lies on the current CUDA device with
    16-byte-aligned data, as the kernels' vector loads need.  Every wrapper
    call of a serving step runs it, so it reads only what a check needs
    (an eager decode step is host-bound)."""
    device = None
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: tensor on {t.device}, expected a "
                             f"CUDA device (CPU tensors take the plain "
                             f"version)")
        if device is None:          # CUDA is initialised: t lives there
            device = torch._C._cuda_getDevice()
        if t.get_device() != device:
            raise ValueError(f"{name}: tensor on {t.device}, expected the "
                             f"current CUDA device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data not 16-byte aligned")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when an input requires grad under grad mode.  A kernel writes
    its output through raw pointers, which autograd cannot follow, so a
    wrapper that is not a ``torch.autograd.Function`` would hand back a
    result without a gradient; it raises instead, on the CPU too, so that a
    CPU test shows it."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{name} is not differentiable")


def stream_handle(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer (the raw
    handle, without building a ``torch.cuda.Stream`` object each call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
