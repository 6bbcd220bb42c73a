"""CUDA-graph capture of the serving engine's hot-path calls.

The port's counterpart of the JAX package's memoized ``jax.jit`` entry
points (``serve/engine.py`` ``_chunk_fn`` / ``_prefill_fn``): where the
reference compiles one decode chunk or one bucket's prefill into one XLA
program, the port captures it once as a ``torch.cuda.CUDAGraph`` and
replays it, so the host makes one graph launch instead of one for every
operation of every layer.

A captured body reads and writes only tensors whose storage outlives the
graph: the engine's state tensors, written in place (``copy_``), the
model's parameters and the static input buffers a caller fills before each
call.  The first call of a :class:`GraphedCall` runs its body eagerly, which
is the real work of that call and the warm-up a capture needs (the kernel
library's build, lazy module loads, cuBLAS workspaces), then captures the
body; every later call replays the graph.  A capture executes nothing, so
it neither writes the state nor draws from a sampling generator: the
sequence of eager runs and replays does the same work, and draws the same
Philox numbers, as the same calls run eagerly.

What capture changes for a caller:

* A replay returns the graph's static outputs, which the next replay of the
  same graph overwrites; the engine copies or consumes each one before it
  enqueues another replay, which is also why all of an engine's graphs can
  share one memory pool.
* The kernel launch counts (``repro_torch.kernels``) are kept in Python:
  the capture's delta is taken back out and added again at each replay.
* A failed capture or replay raises; nothing falls back to eager.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from .. import kernels


class GraphedCall:
    """``body()`` run eagerly once, then captured and replayed.

    With ``enabled`` False (a CPU model, or the engine's ``cuda_graphs``
    switch off) every call runs the body eagerly.  ``generator``, when
    given, is registered with the graph, so that a replay advances its
    Philox offset as the eager calls would.  ``pool`` is a
    ``torch.cuda.graph_pool_handle()`` shared by the engine's graphs.
    """

    def __init__(self, body: Callable, enabled: bool, pool=None,
                 generator: Optional[torch.Generator] = None):
        self.body = body
        self.enabled = enabled
        self.pool = pool
        self.generator = generator
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches: Dict[str, int] = {}   # kernel launches a replay
        self.capture_ms = 0.0                 # host ms of the capture
        self.pool_bytes = 0                   # pool growth at the capture
        self.replays = 0

    def __call__(self):
        if not self.enabled:
            return self.body()
        if self.graph is None:
            out = self.body()
            self._capture()
            return out
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        self.replays += 1
        return self.outputs

    def _capture(self) -> None:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, pool=self.pool):
            outputs = self.body()
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        kernels.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph, self.outputs = graph, outputs
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_ms = (time.perf_counter() - t0) * 1e3
