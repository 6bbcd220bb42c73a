"""The port's DP/TP and cross-chip plan transfer
(``repro_torch.parallel.plan_transfer``, ``repro_torch.launch.mesh``)
against the JAX package's, on the CPU: ``MeshSpec``; gpt3-xl at
``paper_gpt3xl`` planned on the reference's chips and transferred to dp 2,
dp 4 and tp 2 (``transfer_train_bundle``, ``compare_transfer``); a serve
plan moved across chip models (``transfer_serve_plan``); the port's train
executor replaying a transferred bundle; a transfer onto ``h100_like``.

The copies run identical numpy code on identical inputs, so results are
compared with ``==``, as ``test_torch_dvfs.py`` compares them."""
import dataclasses
import math

import pytest

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
import torch_parity  # noqa: F401  (one intra-op thread a process)
from repro import core as jcore
from repro import dvfs as jdvfs
from repro import parallel as jpar
from repro.launch.mesh import MeshSpec as JaxMeshSpec
from repro.runtime import TrainPhaseExecutor as JaxTrainPhaseExecutor
from repro_torch import core as tcore
from repro_torch import dvfs as tdvfs
from repro_torch import parallel as tpar
from repro_torch.core.freq import AUTO
from repro_torch.launch.mesh import MeshSpec

PKGS = {"jax": (jcore, jdvfs, jcfgs, jpar, JaxMeshSpec),
        "port": (tcore, tdvfs, tcfgs, tpar, MeshSpec)}
ARCH, SHAPE, TAU, N_REPS = "gpt3-xl", "paper_gpt3xl", 0.006, 3
CHIPS = ("tpu-v5e", "rtx3080ti")
MESHES = {"dp2": dict(dp=2), "dp4": dict(dp=4), "tp2": dict(tp=2)}

_SRC = {}


def _source(pkg, chip):
    """gpt3-xl's single-device bundle at ``paper_gpt3xl`` on ``chip``,
    planned by ``pkg``; memoized."""
    if (pkg, chip) not in _SRC:
        core, _, cfgs, _, _ = PKGS[pkg]
        _SRC[pkg, chip] = core.plan_train_bundle(
            cfgs.get_config(ARCH), core.get_chip(chip),
            shape=cfgs.get_shape(SHAPE), policy=core.WastePolicy(TAU),
            n_reps=N_REPS)
    return _SRC[pkg, chip]


def _transfer(pkg, chip, mesh):
    core, _, cfgs, par, spec = PKGS[pkg]
    return par.transfer_train_bundle(
        _source(pkg, chip), cfgs.get_config(ARCH), core.get_chip(chip),
        cfgs.get_shape(SHAPE), spec(**MESHES[mesh]), n_reps=N_REPS)


def _books(bundle):
    """What a bundle decides and books: per phase, the kernels' clock
    pairs, names and the schedule's meta (time, energy, switches, the
    transfer's counts)."""
    return {ph: (bundle.phases[ph].kernel_clock_pairs(),
                 [k.name for k in bundle.phases[ph].kernels],
                 bundle.phases[ph].schedule.meta)
            for ph in bundle.phase_names()}


def test_mesh_spec():
    spec = MeshSpec(dp=4, tp=2, pod=2)
    assert spec.n_devices == 16
    assert spec.data_extent == 8
    assert spec.describe() == "dp8_tp2_pod2"
    with pytest.raises(ValueError):
        MeshSpec(dp=0)
    for kw in (dict(), dict(dp=2), dict(tp=4), dict(dp=2, tp=2, pod=3)):
        ref = JaxMeshSpec(**kw)
        got = MeshSpec(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert (got.n_devices, got.data_extent, got.describe()) \
            == (ref.n_devices, ref.data_extent, ref.describe())
    # from_mesh reads a DeviceMesh as the reference's reads a jax mesh
    import jax
    from repro_torch.hw.step_count import fake_world
    for kw in (dict(dp=2, tp=4), dict(dp=4, tp=2, pod=2)):
        with fake_world(MeshSpec(**kw)) as mesh:
            got = MeshSpec.from_mesh(mesh)
        axes = MeshSpec(**kw).axes()
        ref = JaxMeshSpec.from_mesh(jax.sharding.AbstractMesh(
            tuple(axes.values()), tuple(axes)))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref) == kw \
            | {k: 1 for k in ("dp", "tp", "pod") if k not in kw}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("chip", CHIPS)
def test_transfer_train_bundle_is_equal(chip, mesh):
    """Per-kernel clock choices, the transfer's remap/repair counts and
    the per-shard time and energy of the transferred bundle, equal."""
    j, t = _transfer("jax", chip, mesh), _transfer("port", chip, mesh)
    assert t.chip_name == j.chip_name
    assert t.meta == j.meta
    assert _books(t) == _books(j)
    assert t.step_time_s == j.step_time_s
    assert t.step_energy_j == j.step_energy_j
    assert t.to_ir().to_json() == j.to_ir().to_json()
    assert t.meta["mesh"] == JaxMeshSpec(**MESHES[mesh]).describe()
    for ph in t.phase_names():
        assert t.phases[ph].schedule.meta["n_unmatched"] == 0


@pytest.mark.parametrize("chip", CHIPS)
def test_compare_transfer_rows_are_equal(chip):
    rows = {}
    for pkg, (core, _, cfgs, par, spec) in PKGS.items():
        rows[pkg] = [r.to_dict() for r in par.compare_transfer(
            _source(pkg, chip), cfgs.get_config(ARCH), core.get_chip(chip),
            cfgs.get_shape(SHAPE), [spec(**MESHES[m]) for m in
                                    sorted(MESHES)],
            core.WastePolicy(TAU), n_reps=N_REPS)]
    assert rows["port"] == rows["jax"]
    assert [r["mesh"] for r in rows["port"]] == ["dp2_tp1", "dp4_tp1",
                                                 "dp1_tp2"]
    for r in rows["port"]:
        assert all(math.isfinite(v) for v in r.values()
                   if isinstance(v, float))


def _serve_plan(pkg, chip):
    _, dvfs, cfgs, _, _ = PKGS[pkg]
    with dvfs.DvfsSession(chip=chip, tau=0.005, n_reps=N_REPS) as sess:
        return sess.plan_serve(cfgs.get_config("llama3.2-1b"), n_slots=4,
                               **_serve_shapes(cfgs))


def _serve_shapes(cfgs):
    return dict(prefill_shape=cfgs.ShapeConfig(
                    name="serve_prefill", seq_len=512, global_batch=1,
                    kind="prefill"),
                decode_shape=cfgs.ShapeConfig(
                    name="serve_decode", seq_len=512, global_batch=4,
                    kind="decode"))


@pytest.mark.parametrize("dst", ["a4000", "tpu-v5e"])
def test_transfer_serve_plan_is_equal(dst):
    """A serve plan discovered on the rtx3080ti model, moved to another
    chip model: the snapped, repaired and re-coalesced plan is the
    reference's, as JSON and as its summary."""
    plans = {}
    for pkg, (core, _, cfgs, par, _) in PKGS.items():
        plans[pkg] = par.transfer_serve_plan(
            _serve_plan(pkg, "rtx3080ti"), cfgs.get_config("llama3.2-1b"),
            core.get_chip(dst), n_reps=N_REPS, **_serve_shapes(cfgs))
    j, t = plans["jax"], plans["port"]
    assert t.to_json() == j.to_json()
    assert t.summary() == j.summary()
    assert t.meta["transferred"] is True and t.chip_name == j.chip_name
    with pytest.raises(ValueError, match="distinct chip"):
        tpar.transfer_serve_plan(
            _serve_plan("port", "rtx3080ti"),
            tcfgs.get_config("llama3.2-1b"), tcore.get_chip("rtx3080ti"),
            **_serve_shapes(tcfgs))


def test_train_executor_replays_a_transferred_bundle():
    """The port's train executor (``DvfsSession.adopt`` of the dp-2
    bundle's plan, ``train_executor()``) books three steps as the
    reference's ``TrainPhaseExecutor`` replays the reference's bundle
    (``tests/test_plan_transfer.py``)."""
    chip = "tpu-v5e"
    with pytest.warns(DeprecationWarning):
        j = JaxTrainPhaseExecutor(_transfer("jax", chip, "dp2"),
                                  jcore.get_chip(chip))
    with tdvfs.DvfsSession(chip=chip) as sess:
        sess.adopt(tdvfs.DvfsPlan.from_train_bundle(
            _transfer("port", chip, "dp2")))
        t = sess.train_executor()
        for ex in (j, t):
            for s in range(3):
                ex.on_step(s)
            ex.finish()
    assert t.summary() == j.summary()
    assert t.summary()["totals"]["energy_pct"] < -5.0
    assert t.summary()["totals"]["steps"] == 9


def test_transfer_onto_h100_snaps_to_its_grid():
    """gpt3-xl planned on ``h100_like`` at dp 1 with its bundle's clocks
    replayed at dp 2, dp 4 and tp 2 (every clock on the card's grid or
    auto, finite books), and a serve plan moved onto ``h100_like`` from
    the rtx3080ti model, snapped to the card's grid."""
    chip = tcore.get_chip("h100")
    cfg, shape = tcfgs.get_config(ARCH), tcfgs.get_shape(SHAPE)
    src = tcore.plan_train_bundle(cfg, chip, shape=shape,
                                  policy=tcore.WastePolicy(TAU),
                                  n_reps=N_REPS)
    grid = chip.grid
    plans = [tpar.transfer_train_bundle(src, cfg, chip, shape,
                                        MeshSpec(**MESHES[m]),
                                        n_reps=N_REPS).to_ir()
             for m in sorted(MESHES)]
    plans.append(tpar.transfer_serve_plan(
        _serve_plan("port", "rtx3080ti"), tcfgs.get_config("llama3.2-1b"),
        chip, n_reps=N_REPS, **_serve_shapes(tcfgs)))
    for plan in plans:
        assert plan.chip_name == "h100-like"
        for seg in plan.segments:
            assert math.isfinite(seg.schedule.meta["energy_j"])
            for e in seg.schedule.entries:
                assert e.mem == AUTO or e.mem in grid.mem_clocks_mhz
                assert e.core == AUTO or e.core in grid.core_clocks_mhz
    # the serve plan names its source chip, found in the port's registry
    assert plans[-1].meta["transfer_src_chip"] == "rtx3080ti-like"
    rows = tpar.compare_transfer(src, cfg, chip, shape,
                                 [MeshSpec(dp=2), MeshSpec(tp=2)],
                                 tcore.WastePolicy(TAU), n_reps=N_REPS)
    assert all(math.isfinite(r.energy_vs_replan_pct) for r in rows)
    with pytest.raises(ValueError, match="planned for"):
        tpar.transfer_train_bundle(src, cfg, tcore.get_chip("rtx3080ti"),
                                   shape, MeshSpec(dp=2), n_reps=1)
