"""Wave-based batching baseline (the pre-continuous engine) of the port.

The counterpart of the JAX package's ``serve/wave.py``: requests are served
in rigid fixed-size waves.  A wave of ``slots`` requests is left-padded to
its longest prompt, prefilled together in one dense ``model.prefill`` (the
flash prefill kernel on the card, no per-row valid lengths) and decoded
with dense ``decode_step`` calls until *every* member finishes; then the
next wave starts.  It is the baseline continuous batching is measured
against: with a skewed generation-length mix every short request of a wave
waits on the wave's straggler.  Sampling goes through the engine's
``sample_token`` with a seeded ``torch.Generator``, so only greedy streams
match the reference token for token, as for :class:`ServeEngine`.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models import common as cm
from .engine import Request, sample_token


class WaveEngine:
    """Single-host batched engine over a port model (wave scheduling); runs
    on the model's device."""

    def __init__(self, model, params, batch_slots: int = 4,
                 max_seq: int = 512, temperature: float = 0.0,
                 seed: int = 0):
        self.model = model
        self.params = params
        self.device = model.device
        self.slots = batch_slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.seed = seed
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(seed)
        self.n_decode_steps = 0

    def reset(self) -> None:
        """Re-seed the sampler and zero the step counter, so a seeded run
        repeats."""
        self.rng.manual_seed(self.seed)
        self.n_decode_steps = 0

    def _prefill_batch(self, prompts: np.ndarray):
        """prompts: (B, P) host int32.  Returns (next tokens, cache, pos)."""
        tokens = cm.to_device(prompts, self.device)
        logits, cache = self.model.prefill(self.params, tokens,
                                           max_seq=self.max_seq, remat=False)
        nxt = sample_token(logits, self.rng, self.temperature)
        pos = torch.full((tokens.shape[0],), tokens.shape[1],
                         dtype=torch.int32, device=self.device)
        return nxt, cache, pos

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve ``requests`` in waves of ``slots`` (each wave left-padded
        to its longest prompt).  One host copy of the sampled tokens per
        decode step, as the reference's ``int(nxt[i])`` reads."""
        queue = list(requests)
        while queue:
            wave, queue = queue[:self.slots], queue[self.slots:]
            plen = max(len(r.prompt) for r in wave)
            prompts = np.zeros((len(wave), plen), np.int32)
            for i, r in enumerate(wave):
                prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad
            nxt, cache, pos = self._prefill_batch(prompts)
            steps = max(r.max_new_tokens for r in wave)
            for _ in range(steps):
                host = nxt.cpu().numpy()
                for i, r in enumerate(wave):
                    if len(r.generated) < r.max_new_tokens:
                        r.generated.append(int(host[i]))
                        if len(r.generated) >= r.max_new_tokens:
                            r.finished_step = self.n_decode_steps
                if all(len(r.generated) >= r.max_new_tokens for r in wave):
                    break
                logits, cache = self.model.decode_step(self.params, cache,
                                                       nxt, pos)
                self.n_decode_steps += 1
                pos = pos + 1
                nxt = sample_token(logits, self.rng, self.temperature)
            for r in wave:
                r.done = True
        return requests
