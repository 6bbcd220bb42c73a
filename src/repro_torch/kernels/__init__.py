"""Hand-written CUDA kernels of the port (Hopper, ``sm_90a``).

Each kernel ships as a module with three parts: a plain PyTorch version of
the function (the CPU path and the kernel's oracle), a wrapper that sends a
CPU tensor to the plain version and a CUDA tensor to the kernel (counting
its launches), and the CUDA source under ``csrc/`` built by ``_build.py``.

- ``rmsnorm``                    fused RMSNorm (replaces ``rmsnorm_rows``),
                                 differentiable (plain f32 backward)
- ``flash_attention.prefill``    prefill attention with per-row valid
                                 lengths and an optional log-sum-exp
                                 output (replaces ``flash_attention_fwd``)
- ``flash_attention.backward``   flash-attention backward at head_dim 64
                                 and 224 (replaces ``flash_attention_bwd``)
- ``flash_attention.ops``        ``flash_attention_train``, the autograd
                                 ``Function`` over the two above
- ``flash_attention.paged``      paged decode attention over bf16 / f32 /
                                 int8 / fp8 pools (replaces
                                 ``paged_flash_decode``)
- ``ssd_scan``                   Mamba2 SSD chunked scan with an optional
                                 initial state (replaces ``ssd_scan``),
                                 differentiable (plain f32 backward)
"""
from . import flash_attention, rmsnorm, ssd_scan

__all__ = ["flash_attention", "rmsnorm", "ssd_scan", "launch_counts",
           "reset_launch_counts", "add_launch_counts"]


def _wrappers():
    return {"rmsnorm": rmsnorm.rmsnorm,
            "flash_prefill": flash_attention.flash_prefill,
            "flash_bwd": flash_attention.flash_attention_bwd,
            "paged_decode": flash_attention.paged_flash_decode,
            "ssd_scan": ssd_scan.ssd_scan}


def launch_counts():
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def add_launch_counts(delta) -> None:
    """Add ``delta`` (kernel name -> launches) to the counts.  The counts
    are kept in Python, where a wrapper launches: a CUDA graph's capture
    counts launches that never run and its replays count none, so the
    graph runner takes its capture's delta back out and adds it again at
    every replay (``serve/graphs.py``)."""
    wrappers = _wrappers()
    for name, n in delta.items():
        wrappers[name].launches += n
