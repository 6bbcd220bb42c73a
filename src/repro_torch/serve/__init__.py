from .batch_state import BatchState
from .engine import Request, ServeEngine, sample_token
from .kv_pages import (KV_DTYPES, PagePool, PagedBatchState, cow_copy_block,
                       kv_dtype_bytes, resolve_kv_dtype)
from .scheduler import Scheduler
from .wave import WaveEngine

__all__ = ["ServeEngine", "WaveEngine", "Request", "sample_token",
           "Scheduler", "BatchState", "PagePool", "PagedBatchState",
           "KV_DTYPES", "cow_copy_block", "kv_dtype_bytes",
           "resolve_kv_dtype"]
