"""The port's sharding rules (``repro_torch.parallel.sharding``), logical
axes, meshes and the sharded step's count against the JAX package's, in
one process: no process group but the ``fake`` one.

* ``param_axes()`` equals the reference's leaf for leaf for all eleven
  configs at full width (abstract: nothing is allocated).
* ``param_specs``, ``state_shardings``, ``batch_specs`` and
  ``cache_specs`` equal the reference's on ``AbstractMesh`` meshes (4, 4),
  (16, 16) and (2, 16, 16); the port's rules read the same extents from a
  ``MeshSpec``.  Caches at B 8 / max_seq 4096 and B 1 / max_seq 8192, as
  ``tests/test_sharding.py`` takes them.
* ``make_production_mesh`` gives 256 and 512 ranks with the reference's
  axis names under the ``fake`` backend, and ``MeshSpec.from_mesh`` reads
  them back.
* ``count_train_step(mesh=)`` gives per-device state bytes equal to the
  sum of the local blocks the reference's specs imply.
"""
import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import AbstractMesh, PartitionSpec as P
from repro.configs import REGISTRY
from repro.models import build_model as jax_build_model
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config
from repro_torch.hw.step_count import count_train_step, fake_world
from repro_torch.launch.mesh import (MeshSpec, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.parallel import sharding as tsh
from repro_torch.tree import flatten
import torch_parity  # noqa: F401  (one intra-op thread a process)

ARCHS = sorted(REGISTRY)
MESHES = {"4x4": ((4, 4), ("data", "model"), MeshSpec(dp=4, tp=4)),
          "16x16": ((16, 16), ("data", "model"), MeshSpec(dp=16, tp=16)),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"),
                      MeshSpec(dp=16, tp=16, pod=2))}
CACHES = ((8, 4096), (1, 8192))

_MODELS = {}


def models(arch):
    """(reference model, port model) at full width, memoized."""
    if arch not in _MODELS:
        _MODELS[arch] = (jax_build_model(REGISTRY[arch]),
                         build_model(get_config(arch), device="cpu"))
    return _MODELS[arch]


def jmesh(name):
    shape, names, _ = MESHES[name]
    return AbstractMesh(shape, names)


def _flat(tree, prefix=""):
    """"/"-path -> leaf of a nested dict whose leaves are tuples."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _ref_specs(tree):
    """A reference spec (or sharding) tree as "/"-path -> tuple."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(p.key) for p in path):
            tuple(getattr(leaf, "spec", leaf)) for path, leaf in leaves}


def _ref_shapes(jm):
    """"/"-path -> shape of a reference model's abstract parameters."""
    leaves = jax.tree_util.tree_flatten_with_path(jm.abstract_params())[0]
    return {"/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(arch):
    jm, tm = models(arch)
    ref = _flat(jm.param_axes())
    got = _flat(tm.param_axes())
    assert got == ref
    assert {k: tuple(v) for k, v in _flat(tm.param_shapes()).items()} \
        == _ref_shapes(jm)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_reference(arch, mesh):
    jm, tm = models(arch)
    spec = MESHES[mesh][2]
    ref = _ref_specs(jsh.param_specs(jm, jmesh(mesh)))
    got = dict(flatten(tsh.param_specs(tm, spec)))
    assert got == ref
    assert any(s for s in got.values())        # something is sharded
    jstate = jsh.state_shardings(jm, jmesh(mesh))
    tstate = tsh.state_shardings(tm, spec)
    for key in ("m", "v"):
        assert dict(flatten(tstate["opt"][key])) == \
            _ref_specs(jstate["opt"][key])
    assert tstate["opt"]["step"] == tuple(jstate["opt"]["step"].spec)
    assert tstate["rng"] == tuple(jstate["rng"].spec)
    # the same rules on the axes of a mapping
    assert dict(flatten(tsh.param_specs(tm, spec.axes()))) == ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_match_reference(mesh):
    spec = MESHES[mesh][2]
    for B in (1, 8, 12, 32, 256, 512):
        shapes = {"tokens": (B, 128), "targets": (B, 128),
                  "patch_embeds": (B, 16, 64), "cache": (B,)}
        ref = jsh.batch_specs({k: jax.ShapeDtypeStruct(s, np.int32)
                               for k, s in shapes.items()}, jmesh(mesh))
        got = tsh.batch_specs(shapes, spec)
        assert got == {k: tuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    jm, tm = models(arch)
    spec = MESHES[mesh][2]
    for B, max_seq in CACHES:
        jc = jm._cache_struct(B, max_seq)
        ref = _ref_specs(jsh.cache_specs(jc, jmesh(mesh)))
        shapes = {k: tuple(v.shape) for k, v in jc.items()}
        try:
            tc = tm._cache_struct(B, max_seq)
        except ValueError as e:
            # the port refuses positions past a learned table
            assert "learned position" in str(e)
            tc = shapes
        else:
            assert {k: tuple(v.shape) for k, v in tc.items()} == shapes
        assert tsh.cache_specs(tc, spec) == ref


def test_cache_specs_shard_the_decode_cache():
    """tests/test_sharding.py's own statements, on the port."""
    _, tm = models("llama3.2-1b")
    mesh = MeshSpec(dp=4, tp=4)
    sk = tsh.cache_specs(tm._cache_struct(8, 4096), mesh)["k"]
    assert sk[1] == "data" and "model" in sk
    s1 = tsh.cache_specs(tm._cache_struct(1, 8192), mesh)["k"]
    assert s1[2] == ("data", "model")


@contextlib.contextmanager
def fake_pg(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_fake_ranks(multi_pod):
    n = 512 if multi_pod else 256
    with fake_pg(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert mesh.mesh_dim_names == names
        assert mesh.mesh.numel() == n
        assert MeshSpec.from_mesh(mesh) == (
            MeshSpec(dp=16, tp=16, pod=2) if multi_pod
            else MeshSpec(dp=16, tp=16))
        assert tsh.mesh_axes(mesh) == MESHES[
            "2x16x16" if multi_pod else "16x16"][2].axes()
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_host_mesh(2, 2, device_type="cpu")
    with pytest.raises(RuntimeError, match="none is initialized"):
        make_production_mesh(device_type="cpu")


def test_placements_on_a_device_mesh():
    from torch.distributed.tensor import Replicate, Shard
    with fake_pg(8):
        mesh = make_host_mesh(4, 2, device_type="cpu")
        assert tsh.placements(("model", "data"), mesh) == (Shard(1),
                                                           Shard(0))
        assert tsh.placements((None, ("data", "model")), mesh) == (
            Shard(1), Shard(1))
        assert tsh.placements((), mesh) == (Replicate(), Replicate())
        assert tsh.mesh_coords(mesh) == {"data": 0, "model": 0}
        coords = tsh.rank_coords(mesh)
        assert coords[5] == {"data": 2, "model": 1}


def test_shard_state_blocks_tile_the_global_array():
    """Every rank's block, cut with its coordinates and no process group,
    put back at its slices, is the global array; a dim over two axes is
    split data-major, as JAX lays it out."""
    mesh = MeshSpec(dp=2, tp=2, pod=2)
    sizes = mesh.axes()
    x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    specs = [("model", ("pod", "data")), (("pod", "data", "model"),), (),
             (None, "data")]
    for spec in specs:
        out = torch.full_like(x, -1.0)
        for pod in range(2):
            for data in range(2):
                for model in range(2):
                    c = {"pod": pod, "data": data, "model": model}
                    block = tsh.shard_state({"w": x}, sizes, {"w": spec},
                                            coords=c)["w"]
                    assert tuple(block.shape) == tsh.local_shape(
                        x.shape, spec, sizes)
                    out[tsh.local_slices(x.shape, spec, sizes, c)] = block
        assert torch.equal(out, x)
    c = {"pod": 1, "data": 0, "model": 1}
    block = tsh.shard_state({"w": x}, sizes, {"w": ((
        "pod", "data", "model"),)}, coords=c)["w"]
    assert torch.equal(block, x[5:6])            # ravel (1, 0, 1) = 5


@pytest.mark.parametrize("spec", [(), (("pod", "data", "model"),)],
                         ids=["replicated", "split-on-dim-0"])
def test_shard_state_blocks_are_copies(spec):
    """A block the optimizer updates in place never writes into the global
    state it was cut from, even where the block is the whole array or a
    contiguous slice of it."""
    sizes = MeshSpec(dp=2, tp=2, pod=2).axes()
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    want = x.clone()
    block = tsh.shard_state({"w": x}, sizes, {"w": spec},
                            coords={"pod": 0, "data": 1, "model": 0})["w"]
    block.add_(1.0)
    assert torch.equal(x, want)


@pytest.mark.parametrize("arch,mesh", [("llama3.2-1b", "16x16"),
                                       ("gpt3-xl", "4x4"),
                                       ("gpt3-xl", "2x16x16")])
def test_sharded_count_state_bytes(arch, mesh):
    """One rank's state on fake ranks: its f32 masters and two AdamW
    moments are the blocks the reference's specs imply (plus the int32
    step); FLOPs and collective bytes per device are counted."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    jcfg = dataclasses.replace(REGISTRY[arch], n_layers=2)
    jm = jax_build_model(jcfg)
    spec = MESHES[mesh][2]
    sizes = spec.axes()
    specs = _ref_specs(jsh.param_specs(jm, jmesh(mesh)))
    abstract = _ref_shapes(jm)
    local = 0
    for path, sp in specs.items():
        parts = math.prod(sizes[n] for e in sp for n in tsh.entry_names(e))
        local += math.prod(abstract[path]) // parts
    batch = 2 * spec.data_extent
    count = count_train_step(cfg, global_batch=batch, seq_len=64, mesh=spec)
    assert count.state_bytes == 3 * 4 * local + 4
    whole = count_train_step(cfg, global_batch=batch, seq_len=64)
    assert whole.state_bytes == 3 * 4 * sum(
        math.prod(s) for s in abstract.values()) + 4
    assert whole.collective_bytes == {}
    assert set(count.collective_bytes) >= {"all-gather", "all-reduce",
                                           "reduce-scatter"}
    assert 0 < count.flops < whole.flops


def test_sharded_step_refuses_other_families():
    """Every family's sharded step runs (mamba2-370m's is counted here on
    fake ranks); what it refuses is a Mamba2 head split whose rank heads
    straddle a B/C group (24 heads in 3 groups of 8, 12 a rank)."""
    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=1)
    count = count_train_step(cfg, global_batch=4, seq_len=16,
                             mesh=MeshSpec(dp=2, tp=2))
    assert count.flops > 0 and count.collective_bytes["all-reduce"] > 0
    odd = dataclasses.replace(cfg, d_model=768, ssm=dataclasses.replace(
        cfg.ssm, n_groups=3))
    with pytest.raises(NotImplementedError, match="straddle a B/C group"):
        count_train_step(odd, global_batch=4, seq_len=16,
                         mesh=MeshSpec(dp=2, tp=2))
    with fake_world(MeshSpec(dp=2, tp=2)) as mesh:
        assert MeshSpec.from_mesh(mesh) == MeshSpec(dp=2, tp=2)
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)],
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "zamba2-7b",
                                  "seamless-m4t-medium", "nemotron-4-340b"])
def test_init_sharded_state_draws_init_train_states_blocks(arch, mesh,
                                                           monkeypatch):
    """``init_sharded_state`` draws one leaf at a time and keeps the rank's
    block of it: every rank's blocks equal, bit for bit, the same blocks
    of ``init_train_state``'s whole draw (a copy of the same draw: an
    exact comparison), with ``DRAW_WHOLE_MAX`` small here so that the
    larger leaves take the row-block draw (a stacked leaf a layer at a
    time, an unstacked one in blocks of rows), as llama4-scout's and
    nemotron-4-340b's do at full width; the AdamW moments are zeros at
    the blocks' shapes."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer
    from repro_torch.parallel.train_step import init_sharded_state
    from repro_torch.train import init_train_state
    monkeypatch.setattr(transformer, "DRAW_WHOLE_MAX", 1 << 12)
    model = build_model(smoke_config(get_config(arch)), device="cpu")
    whole = init_train_state(model, seed=0).params
    assert max(t.numel() for _, t in flatten(whole)) > 1 << 12
    sizes = MeshSpec(dp=mesh[0], tp=mesh[1]).axes()
    specs = tsh.param_specs(model, sizes)
    split = 0
    for data in range(mesh[0]):
        for rank in range(mesh[1]):
            coords = {"data": data, "model": rank}
            got = init_sharded_state(model, sizes, seed=0, coords=coords)
            want = flatten(tsh.shard_state(whole, sizes, specs,
                                           coords=coords))
            assert [p for p, _ in flatten(got.params)] == [p for p, _ in
                                                           want]
            for (path, a), (_, b) in zip(flatten(got.params), want):
                assert a.dtype == b.dtype and torch.equal(a, b), path
                assert a.is_contiguous(), path
                split += a.shape != dict(flatten(whole))[path].shape
            for key in ("m", "v"):
                for (_, m), (_, b) in zip(flatten(got.opt[key]), want):
                    assert m.shape == b.shape and not m.any()
    assert split > 0


def test_count_rank_step_tool_prints_the_sharded_count(monkeypatch, capsys):
    """``python -m tools.count_rank_step`` (what ``chip_smoke.py --cards 4``
    logs each rank's peak memory beside) parses its arguments into one
    ``count_train_step(mesh=)`` call and prints the counted step as one
    JSON line: the configuration cut to ``--layers``, the ``--mesh``'s
    data and model sizes, and the peak as resident plus transient
    bytes in GiB."""
    import json
    import os
    import sys
    from types import SimpleNamespace
    from repro_torch.hw import step_count
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools import count_rank_step
    calls = []

    def fake(cfg, **kw):
        calls.append((cfg, kw))
        return SimpleNamespace(resident_bytes=3 * 2**30,
                               peak_bytes=2**29, flops=7.0,
                               collective_bytes={"all-gather": 5})
    monkeypatch.setattr(step_count, "count_train_step", fake)
    assert count_rank_step.main(["--arch", "llama3.2-1b", "--layers", "2",
                                 "--rows", "4", "--seq", "64",
                                 "--mesh", "2x1"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (cfg, kw), = calls
    assert cfg.n_layers == 2 and kw["global_batch"] == 4 \
        and kw["seq_len"] == 64
    assert (kw["mesh"].dp, kw["mesh"].tp) == (2, 1)
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    assert got == {"arch": "llama3.2-1b", "layers": 2, "rows": 4,
                   "seq": 64, "mesh": [2, 1],
                   "params": cfg.param_count()[0],
                   "resident_bytes": 3 * 2**30,
                   "transient_bytes": 2**29, "peak_gib": 3.5, "flops": 7.0,
                   "wire": {"all-gather": 5}}
