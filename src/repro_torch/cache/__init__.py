"""repro_torch.cache — radix prefix cache over the paged-KV pool.

Shares finished prefills across requests: a trie keyed on
page-granularity token chunks maps known prefixes to resident
:class:`~repro_torch.serve.kv_pages.PagePool` pages, which admission
splices into new slots' block tables read-only (copy-on-write on
divergence).  See :mod:`repro_torch.cache.radix` for the data structure
and the sharing / eviction rules.
"""
from .radix import RadixCache, extras_namespace

__all__ = ["RadixCache", "extras_namespace"]
