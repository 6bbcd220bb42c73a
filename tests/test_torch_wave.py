"""The port's wave baseline (``serve/wave.py``) against the JAX package's, on
the CPU: greedy tokens, decode steps and finish steps equal to the
reference ``WaveEngine`` on ``tests/test_serve_continuous.py``'s requests
(equal prompt lengths, so left-padding is a no-op) and on ragged prompts
(where it is not); on the equal-length requests its tokens also equal the
port's continuous ``ServeEngine``'s, which needs fewer decode steps."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.serve import Request as JaxRequest
from repro.serve import WaveEngine as JaxWave
from repro_torch.serve import Request, ServeEngine, WaveEngine
from torch_parity import twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _work(cfg, n=6, plen=8, ragged=False):
    """``tests/test_serve_continuous.py:_requests``: equal prompt lengths
    with skewed generation lengths; ``ragged`` draws lengths 3..12."""
    rng = np.random.default_rng(7)
    news = [3, 11, 2, 7, 5, 9]
    out = []
    for i in range(n):
        n_tok = int(rng.integers(3, 13)) if ragged else plen
        out.append((i, rng.integers(0, cfg.vocab_size, n_tok),
                    news[i % len(news)]))
    return out


def _serve(engine, req_cls, work):
    return engine.generate([req_cls(uid=u, prompt=p, max_new_tokens=n)
                            for u, p, n in work])


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("slots", [2, 4])
def test_wave_matches_reference(ragged, slots):
    model, params, cfg, tmodel, tparams = twin()
    work = _work(cfg, ragged=ragged)
    jeng = JaxWave(model, params, batch_slots=slots, max_seq=64)
    teng = WaveEngine(tmodel, tparams, batch_slots=slots, max_seq=64)
    ref, got = _serve(jeng, JaxRequest, work), _serve(teng, Request, work)
    for r, t in zip(ref, got):
        assert t.generated == r.generated, (t.uid, t.generated, r.generated)
        assert t.finished_step == r.finished_step, t.uid
        assert t.done and r.done
    assert teng.n_decode_steps == jeng.n_decode_steps


def test_wave_matches_continuous_engine():
    """``tests/test_serve_continuous.py::test_continuous_matches_wave_greedy``
    on the port: equal greedy tokens, and continuous batching needs fewer
    decode steps than the waves."""
    _, _, cfg, tmodel, tparams = twin()
    work = _work(cfg)
    cont = ServeEngine(tmodel, tparams, batch_slots=2, max_seq=64)
    wave = WaveEngine(tmodel, tparams, batch_slots=2, max_seq=64)
    a, b = _serve(cont, Request, work), _serve(wave, Request, work)
    for x, y in zip(a, b):
        assert x.generated == y.generated, (x.uid, x.generated, y.generated)
    assert all(r.done and r.finished_step is not None for r in b)
    assert cont.n_decode_steps < wave.n_decode_steps


def test_wave_reset_repeats():
    _, _, cfg, tmodel, tparams = twin()
    eng = WaveEngine(tmodel, tparams, batch_slots=2, max_seq=64,
                     temperature=0.8, seed=5)

    def run():
        return [(r.generated, r.finished_step)
                for r in _serve(eng, Request, _work(cfg, ragged=True))]

    first, steps = run(), eng.n_decode_steps
    eng.reset()
    assert eng.n_decode_steps == 0
    assert run() == first and eng.n_decode_steps == steps


_PROBE = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["jaxlib"] = None
from repro_torch.serve import wave
from repro_torch.serve.wave import WaveEngine
print(json.dumps(sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro."))))
"""


def test_wave_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
