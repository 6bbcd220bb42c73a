"""Deterministic, shardable, resumable synthetic data pipeline (numpy only).

The port's own copy of the JAX package's ``data/pipeline.py``: the same
token stream for the same (seed, step, shard), so both packages train on
identical batches.

At 1000-node scale the data layer must be (a) host-shardable (each host
reads only its slice), (b) deterministic under restart (checkpoint carries
the pipeline cursor), and (c) cheap to skip-ahead (resume does not replay).
The synthetic corpus is a seeded Markov-ish token stream so losses are
reproducible; the same interface takes a real tokenized corpus by swapping
the source.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class PipelineState:
    step: int = 0
    epoch: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "PipelineState":
        return cls(**d)


class SyntheticCorpus:
    """Seeded synthetic token source: ngram-flavored stream with structure
    (so the loss actually decreases during the example runs)."""

    def __init__(self, vocab_size: int, seed: int = 0, order: int = 2):
        self.vocab_size = vocab_size
        self.seed = seed
        self.order = order

    def batch(self, step: int, shard: int, batch: int, seq: int
              ) -> np.ndarray:
        """Deterministic (batch, seq+1) token block for (step, shard)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        V = self.vocab_size
        # structured stream: tokens follow t_{i+1} = (a*t_i + drift) % V
        # with noise — learnable low-entropy transitions
        a = 31
        toks = np.empty((batch, seq + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, batch)
        noise = rng.random((batch, seq)) < 0.15
        rand = rng.integers(0, V, (batch, seq))
        for t in range(seq):
            nxt = (a * toks[:, t] + 7) % V
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return toks


class DataPipeline:
    """Host-sharded batch iterator with O(1) resume."""

    def __init__(self, vocab_size: int, batch_per_host: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1, seed: int = 0,
                 state: Optional[PipelineState] = None):
        self.corpus = SyntheticCorpus(vocab_size, seed=seed)
        self.batch_per_host = batch_per_host
        self.seq_len = seq_len
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.state = state or PipelineState()

    def next_batch(self) -> Dict[str, np.ndarray]:
        toks = self.corpus.batch(self.state.step, self.host_id,
                                 self.batch_per_host, self.seq_len)
        self.state.step += 1
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- checkpointable cursor --------------------------------------------
    def state_dict(self) -> Dict:
        return self.state.to_dict()

    def load_state_dict(self, d: Dict):
        self.state = PipelineState.from_dict(d)
