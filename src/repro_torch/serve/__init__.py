from .batch_state import BatchState
from .engine import Request, ServeEngine, sample_token
from .kv_pages import (KV_DTYPES, PagePool, PagedBatchState, kv_dtype_bytes,
                       resolve_kv_dtype)
from .scheduler import Scheduler

__all__ = ["ServeEngine", "Request", "sample_token", "Scheduler",
           "BatchState", "PagePool", "PagedBatchState", "KV_DTYPES",
           "kv_dtype_bytes", "resolve_kv_dtype"]
