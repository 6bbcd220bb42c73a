from .paged import paged_attention_ref, paged_flash_decode
from .prefill import flash_prefill, flash_prefill_ref

__all__ = ["flash_prefill", "flash_prefill_ref", "paged_flash_decode",
           "paged_attention_ref"]
