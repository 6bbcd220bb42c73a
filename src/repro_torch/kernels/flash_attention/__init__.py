from .backward import flash_attention_bwd, flash_attention_bwd_ref
from .ops import flash_attention_train
from .paged import paged_attention_ref, paged_flash_decode
from .prefill import flash_prefill, flash_prefill_ref

__all__ = ["flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_train", "flash_prefill", "flash_prefill_ref",
           "paged_flash_decode", "paged_attention_ref"]
