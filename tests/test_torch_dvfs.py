"""The port's DVFS stack (``repro_torch.core``, ``.dvfs``, ``.runtime``,
``.obs``) against the JAX package's, on the CPU: the chip models, the
measurement campaign, every governor's serve and train plans (equal JSON,
each package loading the other's), the rate-limited controller, the serve
executor behind both engines and the train executor behind both trainers
(books, ledger rows, metrics, trace events, a restart), the online
governor through ``DvfsSession``, and the H100 chip model of the port.

The copies run identical numpy code on identical inputs, so everything is
compared with ``==``, not a tolerance."""
import dataclasses
import importlib
import json
import tempfile

import numpy as np
import pytest

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from conftest import make_requests
from repro import core as jcore
from repro import dvfs as jdvfs
from repro.ckpt import CheckpointManager as JaxCheckpoints
from repro.data import DataPipeline as JaxPipeline
from repro.obs import Tracer as JaxTracer
from repro.obs import check_executor as jax_check_executor
from repro.runtime import FailureInjector as JaxInjector
from repro.serve import ServeEngine as JaxEngine
from repro.train import OptimizerConfig as JaxOptConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainerConfig as JaxTrainerConfig
from repro_torch import core as tcore
from repro_torch import dvfs as tdvfs
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.freq import AUTO, h100_grid
from repro_torch.data import DataPipeline
from repro_torch.models import build_model
from repro_torch.obs import Tracer as TorchTracer
from repro_torch.obs import check_executor
from repro_torch.runtime import FailureInjector
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeEngine as TorchEngine
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train.loop import Trainer, TrainerConfig
from torch_parity import twin

# each package with the modules a test reaches through it
PKGS = {"jax": (jcore, jdvfs, jcfgs), "port": (tcore, tdvfs, tcfgs)}
GOVERNORS = ("kernel-static", "pass-level", "edp", "online")
ARCH, CHIP, TAU, N_REPS = "llama3.2-1b", "tpu-v5e", 0.01, 2


def _plan(pkg, governor, kind, chip=CHIP, **session_kw):
    """A plan of llama3.2-1b at full size with ``governor``: the serving
    phases (4 slots, seq 256) or a training step (seq 256, batch 4)."""
    _, dvfs, cfgs = PKGS[pkg]
    cfg = cfgs.get_config(ARCH)
    with dvfs.DvfsSession(chip=chip, tau=TAU, n_reps=N_REPS,
                          governor=governor, **session_kw) as sess:
        if kind == "serve":
            return sess.plan_serve(
                cfg, n_slots=4,
                prefill_shape=cfgs.ShapeConfig(name="p", seq_len=256,
                                               global_batch=1,
                                               kind="prefill"),
                decode_shape=cfgs.ShapeConfig(name="d", seq_len=256,
                                              global_batch=4,
                                              kind="decode"))
        return sess.plan_train(cfg, shape=cfgs.ShapeConfig(
            name="t", seq_len=256, global_batch=4, kind="train"))


# ---------------------------------------------------------------------------
# chip models, measurement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rtx3080ti", "a4000", "tpu-v5e"])
def test_reference_chips_are_equal(name):
    assert dataclasses.asdict(tcore.get_chip(name)) \
        == dataclasses.asdict(jcore.get_chip(name))


def test_h100_chip_model_constants():
    chip = tcore.get_chip("h100")
    assert chip == tcore.h100_like() and chip.name == "h100-like"
    assert (chip.peak_flops, chip.hbm_bw, chip.ici_bw) \
        == (989e12, 3.35e12, 450e9)
    assert (chip.p_cap, chip.launch_overhead_s, chip.switch_latency_s) \
        == (700.0, 3e-6, 100e-3)
    # the rtx3080ti split scaled by 700 / 330, to 5 W
    rtx = tcore.get_chip("rtx3080ti")
    for field in ("p_static", "p_core_max", "p_mem_max", "p_ici_max"):
        scaled = getattr(rtx, field) * 700 / 330
        assert abs(getattr(chip, field) - scaled) <= 2.5, field
    # the card's supported clocks: two memory clocks; graphics clocks
    # 345..1980 MHz in 15 MHz steps, taken at 210 MHz from the top
    grid = chip.grid
    assert grid == h100_grid()
    assert grid.mem_clocks_mhz == (1593.0, 2619.0)
    cores = grid.core_clocks_mhz
    assert cores[-1] == 1980.0 and cores[0] >= 345.0
    assert all(b - a == 210.0 for a, b in zip(cores, cores[1:]))
    assert all((c - 345.0) % 15.0 == 0 for c in cores)
    assert "h100" not in jcore.CHIPS          # the reference has no H100


def test_h100_kernel_static_plan_saves_and_reloads(tmp_path):
    """A kernel-static plan of full-size llama3.2-1b on the H100 model:
    finite, every clock on the card's grid, saved and re-loaded equal."""
    for kind in ("serve", "train"):
        plan = _plan("port", "kernel-static", kind, chip="h100")
        assert plan.chip_name == "h100-like"
        rows = plan.summary()["phases"]
        assert rows and all(np.isfinite(r["energy_pct"])
                            and np.isfinite(r["time_pct"])
                            for r in rows.values())
        grid = tcore.get_chip("h100").grid
        for seg in plan.segments:
            for e in seg.schedule.entries:
                assert e.mem in grid.mem_clocks_mhz + (AUTO,)
                assert e.core in grid.core_clocks_mhz + (AUTO,)
        path = str(tmp_path / f"{kind}.json")
        plan.save(path)
        again = tdvfs.DvfsPlan.load(path)
        assert again.to_json() == plan.to_json()
        assert again.summary()["phases"] == rows


def test_measurement_tables_are_equal():
    tables = {}
    for pkg, (core, _, cfgs) in PKGS.items():
        kernels = core.WorkloadBuilder(
            cfgs.get_config(ARCH), cfgs.get_shape("paper_gpt3xl")).build()
        tables[pkg] = core.Campaign(core.get_chip("rtx3080ti"), seed=3,
                                    n_reps=3).run(kernels)
    j, t = tables["jax"], tables["port"]
    assert t.chip_name == j.chip_name and t.auto_idx == j.auto_idx
    assert [p.label() for p in t.pairs] == [p.label() for p in j.pairs]
    assert [dataclasses.asdict(k) for k in t.kernels] \
        == [dataclasses.asdict(k) for k in j.kernels]
    assert np.array_equal(t.time, j.time)
    assert np.array_equal(t.energy, j.energy)


# ---------------------------------------------------------------------------
# plans: every governor, serve and train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("governor", GOVERNORS)
def test_plans_are_equal_and_load_across_packages(governor, kind, tmp_path):
    j, t = _plan("jax", governor, kind), _plan("port", governor, kind)
    assert t.to_json() == j.to_json()
    assert t.summary() == j.summary()
    for src, dst, name in ((j, tdvfs.DvfsPlan, "jax"),
                           (t, jdvfs.DvfsPlan, "port")):
        path = str(tmp_path / f"{name}.json")
        src.save(path)
        loaded = dst.load(path)
        out = str(tmp_path / f"{name}-again.json")
        loaded.save(out)
        with open(path) as f, open(out) as g:
            assert g.read() == f.read()


def test_hlo_calibration_raises_in_the_port():
    """The port compiles no HLO: ``plan_train`` takes no ``hlo_text`` and
    ``core`` has no HLO calibration; a count of the step takes its place
    (``test_count_calibration_lands_in_a_planned_bundle``)."""
    with pytest.raises(TypeError, match="hlo_text"):
        with tdvfs.DvfsSession(chip=CHIP, n_reps=1) as sess:
            sess.plan_train(tcfgs.get_config(ARCH), shape=tcfgs.ShapeConfig(
                name="t", seq_len=64, global_batch=2, kind="train"),
                hlo_text="HloModule m")
    assert not hasattr(tcore, "calibrate_workload_against_hlo")


def test_count_calibration_lands_in_a_planned_bundle():
    """``DvfsSession.plan_train(..., step_count=)`` records the analytic
    workload against a count of the port's step (llama3.2-1b at full width
    on fake tensors, ``hw.step_count.count_train_step``) in the adopted
    plan's meta, as the reference records its HLO calibration; a plan
    without a count stays the reference's (``test_plans_are_equal_...``)."""
    from repro_torch.hw.step_count import count_train_step
    cfg = tcfgs.get_config(ARCH)
    shape = tcfgs.ShapeConfig(name="t", seq_len=64, global_batch=2,
                              kind="train")
    count = count_train_step(cfg, global_batch=2, seq_len=64)
    with tdvfs.DvfsSession(chip="h100", n_reps=1) as sess:
        plan = sess.plan_train(cfg, shape=shape, step_count=count)
    cal = plan.meta["count_calibration"]
    kernels = tcore.WorkloadBuilder(cfg, shape,
                                    include_optimizer=True).build()
    assert cal == tcore.calibrate_workload_against_count(kernels, count)
    assert cal["counted_flops"] == count.flops
    assert cal["counted_hbm_bytes"] == count.hbm_bytes
    assert np.isfinite(cal["flops_ratio"]) and np.isfinite(cal["hbm_ratio"])
    assert tdvfs.DvfsPlan.from_json(plan.to_json()) \
        .meta["count_calibration"] == cal


def test_session_default_chip_is_the_references():
    assert tdvfs.DvfsSession().chip == tcore.get_chip("tpu-v5e")
    assert dataclasses.asdict(tdvfs.DvfsSession().chip) \
        == dataclasses.asdict(jdvfs.DvfsSession().chip)


# ---------------------------------------------------------------------------
# controllers
# ---------------------------------------------------------------------------

def _drive_controller(ctl, pair, grid, seed=0, n=300):
    """A seeded schedule of ``set_clocks`` (on and off the grid, and back
    to auto), modeled time and driver faults; ``pair`` is the package's
    ``ClockPair``."""
    rng = np.random.default_rng(seed)
    mems, cores = grid.mem_clocks_mhz, grid.core_clocks_mhz
    for _ in range(n):
        m = mems[rng.integers(len(mems))] + float(rng.choice([0.0, 7.0]))
        c = cores[rng.integers(len(cores))] + float(rng.choice([0.0, -11.0]))
        ctl.set_clocks(pair(m, c) if rng.random() < 0.9
                       else pair(AUTO, AUTO))
        ctl.advance(float(rng.exponential(2e-3)))
        if rng.random() < 0.03:
            ctl.inject_failure(float(rng.exponential(5e-3)))
    return ctl


def test_rate_limited_controller_is_equal():
    ctls = {}
    for pkg, (core, dvfs, _) in PKGS.items():
        chip = core.get_chip(CHIP)
        ctls[pkg] = _drive_controller(
            dvfs.RateLimitedController(chip, min_interval_s=4e-3),
            core.ClockPair, chip.grid)
    j, t = ctls["jax"], ctls["port"]
    assert t.n_throttled == j.n_throttled > 0
    assert t.n_quantized == j.n_quantized > 0
    for key in ("n_switches", "n_failed", "n_giveups", "switch_time_s"):
        assert getattr(t, key) == getattr(j, key), key
    assert t.current.label() == j.current.label()
    assert t.controller_events == j.controller_events


# ---------------------------------------------------------------------------
# executors behind the engines and the trainers
# ---------------------------------------------------------------------------

_SERVE = {}


def _serve_run(governor, controller):
    """Both engines on the smoke twin (paged, 2 slots) over
    ``conftest.make_requests``, each behind its own package's serve
    executor planned for llama3.2-1b, one tracer per package shared by the
    session and the engine; memoized."""
    key = (governor, controller)
    if key not in _SERVE:
        model, params, cfg, tmodel, tparams = twin()
        out = {}
        for pkg, tracer, eng, m, p, to_req in (
                ("jax", JaxTracer(), JaxEngine, model, params, lambda r: r),
                ("port", TorchTracer(), TorchEngine, tmodel, tparams,
                 lambda r: TorchRequest(uid=r.uid, prompt=r.prompt,
                                        max_new_tokens=r.max_new_tokens))):
            _, dvfs, cfgs = PKGS[pkg]
            with dvfs.DvfsSession(chip=CHIP, tau=TAU, n_reps=N_REPS,
                                  governor=governor, controller=controller,
                                  tracer=tracer) as sess:
                sess.plan_serve(
                    cfgs.get_config(ARCH), n_slots=2,
                    prefill_shape=cfgs.ShapeConfig(
                        name="p", seq_len=64, global_batch=1,
                        kind="prefill"),
                    decode_shape=cfgs.ShapeConfig(
                        name="d", seq_len=64, global_batch=2,
                        kind="decode"))
                ex = sess.serve_executor()
                engine = eng(m, p, batch_slots=2, max_seq=64, paged=True,
                             executor=ex, tracer=tracer)
                engine.generate([to_req(r) for r in make_requests(cfg)])
                report = sess.report()
            out[pkg] = (ex, tracer, engine, report)
        _SERVE[key] = out
    return _SERVE[key]


SERVE_CASES = [("kernel-static", None), ("online", None),
               ("kernel-static", "rate-limited")]


@pytest.mark.parametrize("governor,controller", SERVE_CASES)
def test_serve_executor_books_are_equal(governor, controller):
    (jex, _, jeng, jrep), (tex, _, teng, trep) = \
        _serve_run(governor, controller).values()
    assert tex.summary() == jex.summary()
    assert teng.energy_summary() == jeng.energy_summary()
    assert tex.ledger_rows() == jex.ledger_rows()
    assert tex.metrics().snapshot() == jex.metrics().snapshot()
    assert check_executor(tex) == jax_check_executor(jex) == []
    jrep.pop("planner_wall_s"), trep.pop("planner_wall_s")
    assert trep == jrep
    tot = tex.summary()["totals"]
    assert tot["steps"] == len(make_requests(twin()[2])) \
        + teng.n_decode_steps
    assert tot["energy_j"] > 0


@pytest.mark.parametrize("governor,controller", SERVE_CASES)
def test_serve_executor_trace_events_are_equal(governor, controller):
    (_, jtr, _, _), (_, ttr, _, _) = _serve_run(governor, controller).values()
    assert ttr.events == jtr.events
    spans = [e for e in ttr.events
             if e["track"] == "dvfs" and e["kind"] == "span"]
    assert len(spans) == _serve_run(governor, controller)["port"][0] \
        .summary()["totals"]["steps"]
    assert ttr.to_dict()["traceEvents"] == jtr.to_dict()["traceEvents"]


TRAIN_STEPS = 4
TRAINER_CFG = dict(total_steps=TRAIN_STEPS, ckpt_every=2, max_restarts=2)


def _train_executor(pkg):
    _, dvfs, cfgs = PKGS[pkg]
    sess = dvfs.DvfsSession(chip=CHIP, tau=0.0, n_reps=N_REPS)
    sess.plan_train(cfgs.get_config(ARCH), shape=cfgs.ShapeConfig(
        name="t", seq_len=256, global_batch=4, kind="train"))
    return sess.train_executor()


def _port_trainer_run(fail_at=()):
    model = build_model(twin()[2], block_k=16, device="cpu")
    ex = _train_executor("port")
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(
            model, make_train_step(model, OptimizerConfig(lr=1e-2),
                                   accum_steps=2),
            DataPipeline(model.cfg.vocab_size, 4, 16),
            CheckpointManager(d, keep=2), TrainerConfig(**TRAINER_CFG),
            executor=ex, failure_injector=FailureInjector(fail_at))
        out = trainer.run()
        saved = CheckpointManager(d).restore_extra()["dvfs_exec"]
    return out, trainer.history, ex, saved


@pytest.fixture(scope="module")
def train_runs():
    """Both trainers behind their train executors with a failure at step 3
    (restart from the step-2 checkpoint), and the port's clean run."""
    model, _, cfg, _, _ = twin()
    ex = _train_executor("jax")
    with tempfile.TemporaryDirectory() as d:
        trainer = JaxTrainer(
            model, jax_make_train_step(model, JaxOptConfig(lr=1e-2),
                                       accum_steps=2),
            JaxPipeline(cfg.vocab_size, 4, 16), JaxCheckpoints(d, keep=2),
            JaxTrainerConfig(**TRAINER_CFG), executor=ex,
            failure_injector=JaxInjector((3,)))
        ref = (trainer.run(), trainer.history, ex)
    return {"jax": ref, "port": _port_trainer_run((3,)),
            "port_clean": _port_trainer_run()}


def test_train_executor_books_are_equal(train_runs):
    (jout, jhist, jex), (tout, thist, tex, _) = \
        train_runs["jax"], train_runs["port"]
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] \
        == [0, 1, 2, 2, 3]
    for key in ("dvfs_time_s", "dvfs_energy_j"):
        assert [h[key] for h in thist] == [h[key] for h in jhist]
        assert all(h[key] > 0 for h in thist)
    assert tout["dvfs"] == jout["dvfs"]
    assert tout["restarts"] == jout["restarts"] == 1
    assert set(tout["dvfs"]["phases"]) == {"fwd", "bwd", "opt"}
    assert tex.state_dict() == jex.state_dict()
    assert check_executor(tex) == jax_check_executor(jex) == []


def test_train_executor_restart_restores_its_books(train_runs):
    """The run with a failure at step 3 resumes the executor's books from
    the step-2 checkpoint (JSON in the index's ``extra``) and ends with the
    books of the run without one; a state_dict round trip into a fresh
    executor gives the same summary."""
    (out, _, ex, saved), (clean, _, _, _) = \
        train_runs["port"], train_runs["port_clean"]
    assert out["dvfs"] == clean["dvfs"]
    assert out["dvfs"]["totals"]["steps"] == 3 * TRAIN_STEPS
    assert json.loads(json.dumps(saved)) == saved == ex.state_dict()
    fresh = _train_executor("port")
    fresh.load_state_dict(json.loads(json.dumps(ex.state_dict())))
    assert fresh.summary() == ex.summary()


def test_online_governor_through_the_session_is_equal():
    """The online governor by name, as ``tests/test_dvfs_api.py`` drives
    it: a reference mix, then drifted traffic re-plans; both packages
    give the same report."""
    reports = {}
    for pkg, (_, dvfs, cfgs) in PKGS.items():
        with dvfs.DvfsSession(chip=CHIP, tau=TAU, n_reps=N_REPS,
                              governor="online", window=16,
                              mix_threshold=0.2) as sess:
            sess.plan_serve(
                cfgs.get_config(ARCH), n_slots=4,
                prefill_shape=cfgs.ShapeConfig(name="p", seq_len=256,
                                               global_batch=1,
                                               kind="prefill"),
                decode_shape=cfgs.ShapeConfig(name="d", seq_len=256,
                                              global_batch=4,
                                              kind="decode"))
            ex = sess.serve_executor()
            for _ in range(20):
                ex.on_decode(4)
            for _ in range(40):
                ex.on_decode(1)
            rep = sess.report()
        rep.pop("planner_wall_s")
        reports[pkg] = (rep, sess.governor.revision,
                        sess.governor.plan.to_json())
    assert reports["port"] == reports["jax"]
    rep, revision, _ = reports["port"]
    assert revision > 2 and rep["governor_events"]
    assert rep["executed"][0]["totals"]["steps"] == 60


def test_deprecated_shims_match_the_executors():
    """``runtime.dvfs_exec``'s shims replay a bundle as the governor
    executors do, in both packages."""
    books = {}
    for pkg, (core, _, cfgs) in PKGS.items():
        rt = importlib.import_module(
            "repro.runtime" if pkg == "jax" else "repro_torch.runtime")
        bundle = core.plan_train_bundle(
            cfgs.get_config(ARCH), core.get_chip(CHIP),
            shape=cfgs.ShapeConfig(name="t", seq_len=256, global_batch=4,
                                   kind="train"),
            policy=core.WastePolicy(TAU), n_reps=N_REPS)
        with pytest.warns(DeprecationWarning):
            shim = rt.TrainPhaseExecutor(bundle, core.get_chip(CHIP))
        for s in range(3):
            shim.on_step(s)
        books[pkg] = shim.summary()
    assert books["port"] == books["jax"]
    assert books["port"]["totals"]["steps"] == 9
