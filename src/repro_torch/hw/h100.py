"""NVIDIA H100 SXM 80 GB hardware constants for roofline analysis.

The port's counterpart of the JAX package's ``hw/tpu.py``, with its names.
Each figure is NVIDIA's published one for the H100 SXM 80 GB (dense, no
sparsity) at its 700 W power limit, as ``nvidia-smi --query-gpu=name,
power.limit`` reads the card: ``NVIDIA H100 80GB HBM3, 700.00 W``.  None
is a measurement.  ``core.power_model.h100_like`` and ``chip_smoke.py``'s
kernel bounds read them from here.
"""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores, dense (data sheet)
PEAK_FLOPS_F32 = 67e12        # FLOP/s, f32 without tensor cores (data sheet)
HBM_BW = 3.35e12              # B/s, HBM3 (data sheet)
HBM_BYTES = 80e9              # bytes of HBM3 (data sheet)
NVLINK_BW = 450e9             # B/s a direction, NVLink 4 (900 GB/s both ways)


def roofline_terms(flops: float, bytes_hbm: float, bytes_link: float,
                   n_chips: int):
    """The three §Roofline terms, in seconds (aggregate work / aggregate
    capability).  ``flops``/``bytes`` are per-device values times n_chips,
    or global values; pass per-device values with n_chips=1."""
    return {
        "compute_s": flops / (n_chips * PEAK_FLOPS_BF16),
        "memory_s": bytes_hbm / (n_chips * HBM_BW),
        "collective_s": bytes_link / (n_chips * NVLINK_BW),
    }
