"""The port's sharded prefill and context-parallel decode
(``parallel.serve_step.ShardedServe``) on CPU ``gloo`` ranks, against the
JAX package's unsharded ``prefill`` and dense ``decode_step``.

Two worlds, (data, model) = (2, 2) and (1, 4), spawned side by side once
for the module (``launch.mesh.spawn_ranks``); their ranks run
``torch_ranks.serve_world``, which imports no JAX.  Each serves the
smoke twins of a dense (llama3.2-1b), a VLM (internvl2-1b, 8 patch rows
before the prompt) and an MoE model (granite-moe-1b-a400m, every routed
pair kept) from the reference's weights: a prefill of 4 prompts into a
cache of ``max_seq`` 1024, where ``cache_specs`` shards the sequence
over ``model`` (below 1024 it would split head_dim), then 4 decode steps
on seeded tokens.  The (2, 2) world also serves one prompt (the batch
cannot split over data, so the sequence goes over data and model, the
``long_500k`` layout) and llama4-scout's twin at window 1024 with a
prompt of 1030 tokens into 2048 positions: its ring caches (1024 slots)
and global caches sharded, the ring wrapped by the prompt.

The sharded prefill's logits and its cache blocks gathered, and each
decode step's logits, within ``RTOL`` 1e-5 (f32) of the largest
|reference value| (the logits over the real vocab), and within ``RTOL``
of the port's own unsharded ``prefill`` and ``decode_step`` on the same
weights.  At llama4-scout's positions past 1000 the port's unsharded
prefill itself parts from the reference's by 1.28e-5 (its ring keys;
1.15e-5 its global keys: f32 rounding of the rotary angles and the
1030-key softmax), so that case is held to the reference at
``LONG_RTOL`` 3e-5 and to the port's unsharded path at ``RTOL``.  Each
rank's cache block holds a slice of the sequence.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.models import build_model as jax_build_model
from repro_torch.launch.mesh import spawn_ranks
import torch_ranks
from test_torch_multidevice import _flat, _side_by_side
from torch_parity import jref, twin

MESHES = ((2, 2), (1, 4))
RTOL = 1e-5
LONG_RTOL = 3e-5
STEPS = 4
MAX_SEQ = 1024
FAMILY = ("llama3.2-1b", "internvl2-1b", "granite-moe-1b-a400m")
LLAMA4 = "llama4-scout-17b-a16e"
LLAMA4_WINDOW, LLAMA4_PROMPT, LLAMA4_MAX_SEQ = 1024, 1030, 2048


def _cases(mesh):
    """name -> (arch, config changes, batch, prompt length, max_seq)."""
    out = {arch: (arch, {}, 4, 40, MAX_SEQ) for arch in FAMILY}
    if mesh == (2, 2):
        out["llama3.2-1b B1"] = ("llama3.2-1b", {}, 1, 40, MAX_SEQ)
        out["llama4 ring"] = (LLAMA4, {"attn_window": LLAMA4_WINDOW}, 2,
                              LLAMA4_PROMPT, LLAMA4_MAX_SEQ)
    return out


_MODELS = {}


def _reference_model(arch, changes):
    """The reference twin (``twin``'s), or its model with ``changes`` on
    the same weights."""
    model, params, cfg, _, _ = twin(arch)
    if not changes:
        return model, params, cfg
    key = (arch, tuple(sorted(changes.items())))
    if key not in _MODELS:
        cfg = dataclasses.replace(cfg, **changes)
        _MODELS[key] = (jax_build_model(cfg, block_k=16), params, cfg)
    return _MODELS[key]


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    patch = rng.normal(size=(B, cfg.vision_prefix_len, cfg.d_model)) \
        .astype(np.float32) if cfg.family == "vlm" else None
    return tokens, feed, patch


_REF = {}


def reference(mesh, name):
    """The reference's prefill logits and cache and its decode logits on
    the case's inputs, and the job the ranks get."""
    key = (mesh, name)
    if key not in _REF:
        arch, changes, B, S, max_seq = _cases(mesh)[name]
        model, params, cfg = _reference_model(arch, changes)
        tokens, feed, patch = _inputs(cfg, B, S, seed=len(_REF) + 11)
        P = 0 if patch is None else patch.shape[1]
        fns = jref(model)
        logits, cache = fns.prefill(
            params, jnp.asarray(tokens),
            patch_embeds=None if patch is None else jnp.asarray(patch),
            max_seq=max_seq)
        steps = [np.asarray(logits)]
        ref_cache = {k: np.asarray(v) for k, v in cache.items()}
        pos = jnp.full((B,), S + P, jnp.int32)
        for row in feed:
            logits, cache = fns.decode_step(params, cache, jnp.asarray(row),
                                            pos)
            steps.append(np.asarray(logits))
            pos = pos + 1
        job = dict(name=name, arch=arch, changes=changes,
                   params=_flat(params), tokens=tokens, patch_embeds=patch,
                   max_seq=max_seq, feed=feed, pos=S + P)
        _REF[key] = dict(logits=steps, cache=ref_cache, job=job, cfg=cfg,
                         port=_port_unsharded(job),
                         tol=LONG_RTOL if S > MAX_SEQ else RTOL)
    return _REF[key]


def _port_unsharded(job):
    """The port's unsharded prefill and decode on the case's inputs."""
    model = torch_ranks.smoke_twin_model(job["arch"], **job["changes"])
    params = torch_ranks._tensors(model, job["params"])
    patch = job["patch_embeds"]
    logits, cache = model.prefill(
        params, torch.from_numpy(job["tokens"]), max_seq=job["max_seq"],
        patch_embeds=None if patch is None else torch.from_numpy(patch))
    out = {"cache": {k: v.numpy().copy() for k, v in cache.items()},
           "logits": [logits.numpy()]}
    pos = torch.full((job["tokens"].shape[0],), job["pos"],
                     dtype=torch.int32)
    for row in job["feed"]:
        logits, cache = model.decode_step(params, cache,
                                          torch.from_numpy(row), pos)
        out["logits"].append(logits.numpy())
        pos = pos + 1
    return out


@pytest.fixture(scope="module")
def worlds():
    jobs = {mesh: (spawn_ranks, torch_ranks.serve_world, math.prod(mesh),
                   dict(mesh=mesh, cases=[reference(mesh, n)["job"]
                                          for n in _cases(mesh)]))
            for mesh in MESHES}
    return _side_by_side(jobs)


CASES = [(mesh, name) for mesh in MESHES for name in _cases(mesh)]
IDS = [f"{'x'.join(map(str, m))}-{n.replace(' ', '_')}" for m, n in CASES]


def _err(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_sharded_prefill_matches_reference(worlds, mesh, name):
    ref = reference(mesh, name)
    V = ref["cfg"].vocab_size
    for want, tol in ((ref, ref["tol"]), (ref["port"], RTOL)):
        for r in worlds[mesh]:
            got = r[name]["logits"][0]
            assert got.shape == want["logits"][0].shape
            assert _err(got[:, :V], want["logits"][0][:, :V]) <= tol
        cache = worlds[mesh][0][name]["cache"]
        assert set(cache) == set(want["cache"])
        for leaf, w in want["cache"].items():
            assert cache[leaf].shape == w.shape, leaf
            err = _err(cache[leaf], w)
            assert err <= tol, f"{leaf}: {err:.3e}"


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_context_parallel_decode_matches_reference(worlds, mesh, name):
    ref = reference(mesh, name)
    V = ref["cfg"].vocab_size
    for want, tol in ((ref, ref["tol"]), (ref["port"], RTOL)):
        for r in worlds[mesh]:
            steps = r[name]["logits"][1:]
            assert len(steps) == STEPS
            for i, (got, w) in enumerate(zip(steps, want["logits"][1:])):
                err = _err(got[:, :V], w[:, :V])
                assert err <= tol, f"step {i}: {err:.3e}"


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_each_rank_holds_a_slice_of_the_sequence(worlds, mesh, name):
    ref = reference(mesh, name)
    full = {k: v.shape for k, v in ref["cache"].items()}
    B = ref["job"]["tokens"].shape[0]
    rows = B // mesh[0] if B % mesh[0] == 0 and B > 1 else B
    parts = mesh[1] if rows != B or mesh[0] == 1 else math.prod(mesh)
    for r in worlds[mesh]:
        for leaf, shape in r[name]["shapes"].items():
            seq = 3 if len(shape) == 6 else 2
            want = list(full[leaf])
            want[seq - 1], want[seq] = rows, want[seq] // parts
            assert list(shape) == want, (leaf, shape, full[leaf])
            assert parts > 1 and want[seq] < full[leaf][seq]
