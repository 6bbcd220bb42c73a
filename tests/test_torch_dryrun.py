"""The port's dry run (``launch/dryrun.py``) and what it reads: the cell
registry, ``input_specs``, ``input_shardings`` and the fake-rank counts
of ``hw.step_count``, against the JAX package's.

* ``ASSIGNED``, ``ASSIGNED_SHAPES``, ``all_cells`` and ``config_summary``
  equal to the reference's.
* ``input_specs`` of every arch at every shape: the same names, shapes
  and dtypes as the reference's ``ShapeDtypeStruct``s; ``input_shardings``
  equal to the reference's specs on ``AbstractMesh``es.
* A rank's resident bytes (``step_count.resident_bytes``: its blocks of
  the state, or of the serving parameters, the cache and the inputs) equal
  to the sum of ``NamedSharding.shard_shape`` over the reference's
  ``state_shardings`` (less its 8-byte PRNG key: the port's generator
  lives on the host) or ``param_specs``, and ``input_shardings``, on the
  16x16 and 2x16x16 ``AbstractMesh``es, for every runnable cell of every
  family and gpt3-xl's paper cell (no compile).
* Two rank coordinates give the same count at smoke size (the MoE twin's
  and the SSM twin's train step, the dense twin's prefill and decode, the
  hybrid twin's decode): rank 0 stands for every rank.
* One full-size cell through the CLI (``llama3.2-1b decode_32k``): its
  record ``ok``, its resident bytes the reference's, ``fits``; the
  ``skipped`` status, an SSM cell (``mamba2-370m decode_32k``) ``ok``,
  and the exit codes.
"""
import json
import math
import os

import numpy as np
import pytest

import jax
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec
import repro.configs as rcfg
from repro.models import build_model as jax_build_model
from repro.parallel import sharding as jsh
import repro_torch.configs as tcfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.hw.step_count import (count_decode, count_prefill,
                                       count_train_step, fake_world,
                                       resident_bytes)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import build_model
from repro_torch.parallel.sharding import input_shardings
import torch_parity  # noqa: F401  (one intra-op thread)

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def test_registry_matches_reference():
    assert tcfg.ASSIGNED == rcfg.ASSIGNED
    assert tcfg.ASSIGNED_SHAPES == rcfg.ASSIGNED_SHAPES
    assert list(tcfg.all_cells(include_skipped=True)) == \
        list(rcfg.all_cells(include_skipped=True))
    assert list(tcfg.all_cells()) == list(rcfg.all_cells())
    for arch in tcfg.REGISTRY:
        assert tcfg.config_summary(tcfg.get_config(arch)) == \
            rcfg.config_summary(rcfg.get_config(arch))


@pytest.mark.parametrize("arch", sorted(tcfg.REGISTRY))
def test_input_specs_and_shardings_match_reference(arch):
    model = build_model(tcfg.get_config(arch), device="cpu")
    ref = jax_build_model(rcfg.get_config(arch))
    for name in tcfg.SHAPES:
        got = _flat(model.input_specs(tcfg.get_shape(name)))
        want = _flat(ref.input_specs(rcfg.get_shape(name)))
        assert list(got) == list(want), name
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert str(t.dtype).removeprefix("torch.") == \
                str(want[k].dtype), (name, k)
        mesh = AbstractMesh(*MESHES[False])
        specs = _flat(input_shardings(model, tcfg.get_shape(name),
                                      MeshSpec(dp=16, tp=16)))
        shard = _flat(jsh.input_shardings(ref, rcfg.get_shape(name), mesh))
        assert specs == {k: tuple(v.sharding.spec) for k, v in
                         shard.items()}, name


def _reference_resident(arch, shape_name, multi):
    """Bytes of one device's shards of the reference's dry-run arguments:
    the state (params, AdamW moments, step; not its PRNG key) or the
    parameters, and the inputs, by ``NamedSharding.shard_shape``."""
    mesh = AbstractMesh(*MESHES[multi])
    model = jax_build_model(rcfg.get_config(arch))
    shape = rcfg.get_shape(shape_name)
    params = jax.tree.leaves(model.abstract_params())
    is_spec = lambda x: isinstance(x, (PartitionSpec,  # noqa: E731
                                       NamedSharding))

    def shard_bytes(shapes, specs, itemsize=None):
        specs = [sp if isinstance(sp, NamedSharding)
                 else NamedSharding(mesh, sp)
                 for sp in jax.tree.leaves(specs, is_leaf=is_spec)]
        assert len(specs) == len(shapes)
        return sum(math.prod(sp.shard_shape(s.shape))
                   * (itemsize or s.dtype.itemsize)
                   for s, sp in zip(shapes, specs))
    total = 0
    if shape.kind == "train":
        st = jsh.state_shardings(model, mesh)
        total += shard_bytes(params, st["params"])
        total += 2 * shard_bytes(params, st["opt"]["m"], itemsize=4)
        total += 4                                   # the int32 step
    else:
        total += shard_bytes(params, jsh.param_specs(model, mesh))
    for leaf in jax.tree.leaves(jsh.input_shardings(model, shape, mesh)):
        total += math.prod(leaf.sharding.shard_shape(leaf.shape)) \
            * leaf.dtype.itemsize
    return total


CELLS = [(a, s) for a, s, ok, _ in tcfg.all_cells()
         if tcfg.get_config(a).family in FAMILIES] \
    + [("gpt3-xl", "paper_gpt3xl")]


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_resident_bytes_equal_reference_shards(arch, shape, multi):
    model = build_model(tcfg.get_config(arch), device="cpu")
    sh = tcfg.get_shape(shape)
    got = resident_bytes(model, model.input_specs(sh),
                         dryrun.production_spec(multi),
                         train=sh.kind == "train")
    assert got == _reference_resident(arch, shape, multi)


def _smoke(arch, kind, S, B=4):
    cfg = tcfg.smoke_config(tcfg.get_config(arch))
    shape = ShapeConfig(name=f"smoke_{kind}", seq_len=S, global_batch=B,
                        kind=kind)
    return cfg, build_model(cfg, device="cpu").input_specs(shape)


def _fields(c):
    return (c.flops, c.hbm_bytes, dict(c.collective_bytes),
            c.resident_bytes, c.peak_bytes)


@pytest.mark.parametrize("arch,kind,S", [
    ("granite-moe-1b-a400m", "train", 64),
    ("llama3.2-1b", "prefill", 1024),
    ("llama3.2-1b", "decode", 2048),
    ("mamba2-370m", "train", 64),
    ("zamba2-7b", "decode", 2048)])
def test_two_rank_coordinates_count_the_same(arch, kind, S):
    cfg, inputs = _smoke(arch, kind, S)
    spec = MeshSpec(dp=2, tp=2)
    fn = {"train": lambda c, i, m: count_train_step(c, inputs=i, mesh=m),
          "prefill": count_prefill, "decode": count_decode}[kind]
    counts = []
    for rank in (0, 3):
        with fake_world(spec, rank=rank) as mesh:
            counts.append(_fields(fn(cfg, inputs, mesh)))
    assert counts[0] == counts[1]
    flops, _, wire, resident, peak = counts[0]
    assert flops > 0 and peak > 0 and sum(wire.values()) > 0
    model = build_model(cfg, device="cpu")
    assert resident == resident_bytes(model, inputs, spec,
                                      train=kind == "train")


def test_cli_counts_a_full_size_cell(tmp_path):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--out", out]) == 0
    with open(os.path.join(out, "llama3_2-1b__decode_32k__single.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["resident_bytes"] == _reference_resident(
        "llama3.2-1b", "decode_32k", False)
    assert rec["bytes_per_device"] == rec["resident_bytes"] \
        + rec["peak_transient_bytes"]
    assert rec["fits"] and rec["count"]["flops_per_device"] > 0
    wire = rec["collectives"]
    assert wire["total_bytes"] == sum(v for k, v in wire.items()
                                      if k != "total_bytes") > 0


def test_cli_statuses_and_exit_codes(tmp_path):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                        "--out", out, "--multi-pod"]) == 0
    recs = {}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            recs[name] = json.load(f)
    skip = recs["llama3_2-1b__long_500k__single.json"]
    assert skip["status"] == "skipped"
    assert skip["reason"] == tcfg.cell_is_runnable(
        tcfg.get_config("llama3.2-1b"), tcfg.get_shape("long_500k"))[1]
    ssm = recs["mamba2-370m__decode_32k__multi.json"]
    assert ssm["status"] == "ok" and ssm["mesh"] == "2x16x16"
    assert ssm["resident_bytes"] == _reference_resident(
        "mamba2-370m", "decode_32k", True)
    assert ssm["fits"] and ssm["count"]["flops_per_device"] > 0
    assert {r["status"] for r in recs.values()} == {"ok", "skipped"}
    # an existing record is kept with --skip-existing
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--out", out, "--skip-existing"]) == 0
    assert np.all([r["status"] != "error" for r in recs.values()])
