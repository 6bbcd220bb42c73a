"""The H100's roofline constants (``hw.h100``) and the count of a step
(``hw.step_count``, which loads torch: import it from its module)."""
from .h100 import PEAK_FLOPS_BF16, PEAK_FLOPS_F32, HBM_BW, HBM_BYTES, \
    NVLINK_BW, roofline_terms

__all__ = ["PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "HBM_BW", "HBM_BYTES",
           "NVLINK_BW", "roofline_terms"]
