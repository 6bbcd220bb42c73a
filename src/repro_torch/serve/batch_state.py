"""Device-side state of the continuous-batching slot pool (dense caches).

``BatchState`` owns the pooled cache (one batch row per slot; the model's
``cache_slot_axes()`` names where the batch dim sits in each leaf: attention
KV for the dense decoder, SSM state and conv window for the SSM family)
plus three (n_slots,) int32 device vectors that ride the decode loop, the
rows of one ``slot_vectors`` tensor:

* ``tokens``    — last sampled token per slot,
* ``pos``       — its absolute position,
* ``remaining`` — generation budget left; ``remaining > 0`` is the
  on-device "live" mask that lets the decode chunk terminate per slot
  (EOS / max-len) without a host round-trip.

Which slot holds which request is the
:class:`~repro_torch.serve.scheduler.Scheduler`'s single source of truth.
A retired slot keeps ``remaining == 0`` and its rows freeze in place until
the next admission overwrites them.

Every tensor keeps its storage for the life of the state: the engine's
CUDA graphs replay against fixed addresses, so writers update in place and
:meth:`BatchState.clear` zeroes instead of reallocating.
"""
from __future__ import annotations

import torch


def slot_vectors(n_slots: int, device):
    """One (3, n_slots) int32 tensor and its rows ``tokens``, ``pos`` and
    ``remaining``: an admission activates its slots with one scatter into
    all three."""
    vecs = torch.zeros((3, n_slots), dtype=torch.int32, device=device)
    return (vecs, *vecs.unbind(0))


def cache_bytes(cache, keys=None) -> int:
    """Bytes of the cache leaves named by ``keys`` (all when None)."""
    return sum(a.numel() * a.element_size() for k, a in cache.items()
               if keys is None or k in keys)


class BatchState:
    """Per-slot device state for a fixed pool of ``n_slots`` sequences."""

    def __init__(self, model, n_slots: int, max_seq: int):
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.cache = model.init_cache(n_slots, max_seq)
        # the unbounded (max_seq-proportional) attention-KV leaves — the
        # ones a paged layout would pool (none for a recurrent state)
        self._kv_keys = set(model.paged_cache_keys())
        self.slot_vectors, self.tokens, self.pos, self.remaining = \
            slot_vectors(n_slots, model.device)

    def clear(self) -> None:
        """Back to the state of a fresh pool, in place."""
        for t in (self.slot_vectors, *self.cache.values()):
            t.zero_()

    def kv_hbm_bytes(self) -> int:
        """Bytes of the unbounded attention-KV leaves only — comparable
        across dense and paged layouts."""
        return cache_bytes(self.cache, self._kv_keys)

    def cache_hbm_bytes(self) -> int:
        """Bytes of every cache leaf."""
        return cache_bytes(self.cache)
