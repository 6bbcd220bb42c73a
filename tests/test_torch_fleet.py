"""The port's fleet tier against the JAX package's, on the CPU.

The fleet (``repro_torch.fleet``) runs in modeled time on numpy and the
port's copies of the scheduler, page pool, radix cache and DVFS stack, so
on the same seeds, specs and traces it must give the reference's numbers:
equal trace and fault-schedule JSON, equal thermally clamped tables,
equal router placements on the same replicas, and whole ``Fleet.serve``
runs whose ``fleet_report`` agrees key by key at relative 1e-9, with the
telemetry trace of a fault run equal event for event.  Chips are ones
both packages model (``tpu-v5e``, ``rtx3080ti``, ``a4000``; the reference
has no ``h100``).  Then the port's launcher: ``main()`` runs on the CPU
and prints a report ``check_fleet`` accepts, on its default ``h100``
replicas too, and where the reference's launcher fails on a capped fleet
with no loaded power window, the port's says so and prints the rest.
"""
import contextlib
import io
import json
import math
import sys

import numpy as np
import pytest

import repro.fleet as jfleet
import repro_torch.fleet as tfleet
from repro.configs import get_config as jax_config
from repro.core.measure import Campaign as JaxCampaign
from repro.core.workload import WorkloadBuilder as JaxBuilder
from repro.dvfs.session import DvfsSession as JaxSession
from repro.launch import fleet as jax_launch
from repro.obs import Tracer as JaxTracer
from repro_torch.configs import get_config
from repro_torch.core.measure import Campaign
from repro_torch.core.workload import WorkloadBuilder
from repro_torch.dvfs.session import DvfsSession
from repro_torch.launch import fleet as launch
from repro_torch.obs import Tracer, check_fleet
import torch_parity  # noqa: F401  (one intra-op thread a worker)

ARCH = "llama3.2-1b"
RTOL = 1e-9
PKGS = {"ref": (jfleet, jax_config, JaxTracer),
        "port": (tfleet, get_config, Tracer)}

# name -> (replica specs, build_fleet options, trace options, faults);
# the trace options are generate_trace's (n_tenants: the tenant trace's)
FLEETS = {
    "round-robin": ("2xtpu-v5e:4", dict(router="round-robin"),
                    dict(process="poisson", rate_rps=60.0, n_requests=60),
                    None),
    "energy-slo-transfer": ("2xrtx3080ti:4,a4000:4",
                            dict(router="energy-slo",
                                 transfer_from="rtx3080ti"),
                            dict(process="diurnal", rate_rps=25.0,
                                 n_requests=60),
                            None),
    "power-cap": ("2xtpu-v5e:4", dict(power_cap_w=200.0,
                                      cap_interval_s=0.25),
                  dict(process="poisson", rate_rps=200.0, n_requests=120),
                  None),
    "autopark": ("3xtpu-v5e:4", dict(autopark_idle_s=0.05),
                 dict(process="diurnal", rate_rps=30.0, n_requests=60),
                 None),
    "disaggregated": ("tpu-v5e@prefill,2xtpu-v5e@decode", dict(),
                      dict(process="poisson", rate_rps=60.0, n_requests=60),
                      None),
    "storm": ("3xtpu-v5e:4", dict(controller="rate-limited"),
              dict(process="poisson", rate_rps=120.0, n_requests=80),
              "storm"),
    "storm-no-recover": ("3xtpu-v5e:4", dict(recover=False),
                         dict(process="poisson", rate_rps=120.0,
                              n_requests=80),
                         "storm"),
    "prefix-cache": ("3xtpu-v5e:4",
                     dict(router="cache-affinity", prefix_cache=True),
                     dict(process="poisson", rate_rps=150.0, n_requests=80,
                          n_tenants=4),
                     None),
}

_RUNS = {}


def _trace(fl, opts):
    opts = dict(opts)
    if "n_tenants" in opts:
        return fl.generate_tenant_trace(opts.pop("process"), seed=0, **opts)
    return fl.generate_trace(opts.pop("process"), seed=0,
                             straggler_tokens=64, straggler_every=3, **opts)


def _router(fl, name):
    """A registry router; the energy-aware ones at the launcher's SLO."""
    if name in ("energy-slo", "cache-affinity"):
        return fl.router(name, slo_ttft_s=0.1)
    return fl.router(name)


def _serve(pkg, name):
    """One fleet of ``FLEETS`` served by one package (memoized): its
    report, its fleet and its telemetry trace events."""
    if (pkg, name) not in _RUNS:
        fl, config, tracer_cls = PKGS[pkg]
        specs, opts, topts, faults = FLEETS[name]
        opts = dict(opts)
        if "router" in opts:
            opts["router"] = _router(fl, opts["router"])
        tracer = tracer_cls(meta={"fleet": name}) if faults else None
        fleet = fl.build_fleet(fl.parse_replica_specs(specs),
                               config(ARCH), seed=0, tracer=tracer, **opts)
        trace = _trace(fl, topts)
        if faults:
            fleet.injector = fl.FaultInjector(fl.generate_faults(
                faults, seed=0, replicas=[r.name for r in fleet.replicas],
                duration_s=trace.duration_s))
        report = fleet.serve(trace)
        _RUNS[pkg, name] = (report, fleet,
                            tracer.events if tracer is not None else None)
    return _RUNS[pkg, name]


def _assert_close(got, want, path="report"):
    """Equal structure; numbers within relative 1e-9 (ints exact)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, str, type(None))):
        assert got == want, (path, got, want)
    elif isinstance(want, (int, np.integer)) \
            and isinstance(got, (int, np.integer)):
        assert got == want, (path, got, want)
    else:
        w, g = float(want), float(got)
        if math.isnan(w):
            assert math.isnan(g), path
        else:
            assert g == w or abs(g - w) <= RTOL * abs(w), (path, g, w)


# ---------------------------------------------------------------------------
# traces, fault schedules, clamped tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tenants", [False, True])
@pytest.mark.parametrize("process", ["poisson", "diurnal", "bursty"])
def test_traces_equal_reference(process, tenants):
    opts = dict(process=process, rate_rps=40.0, n_requests=120)
    if tenants:
        opts["n_tenants"] = 4
    want = _trace(jfleet, opts)
    got = _trace(tfleet, opts)
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()
    assert tfleet.Trace.from_json(want.to_json()).to_dict() == want.to_dict()
    assert got.summary() == want.summary()


@pytest.mark.parametrize("kind", ["storm", "random"])
def test_fault_schedules_equal_reference(kind):
    names = ["r0-tpu-v5e", "r1-tpu-v5e", "r2-a4000"]
    want = jfleet.generate_faults(kind, seed=3, replicas=names,
                                  duration_s=2.0)
    got = tfleet.generate_faults(kind, seed=3, replicas=names,
                                 duration_s=2.0)
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    back = tfleet.FaultSchedule.from_json(want.to_json())
    assert back.to_dict() == want.to_dict()


@pytest.mark.parametrize("frac", [0.3, 0.6, 0.95])
@pytest.mark.parametrize("chip", ["tpu-v5e", "rtx3080ti"])
def test_clamp_table_equal_reference(chip, frac):
    shape = tfleet.default_serve_shapes(4)[0]
    jshape = jfleet.default_serve_shapes(4)[0]
    want = jfleet.clamp_table(
        JaxCampaign(JaxSession(chip=chip).chip, seed=0, n_reps=3)
        .run(JaxBuilder(jax_config(ARCH), jshape).build()), frac)
    got = tfleet.clamp_table(
        Campaign(DvfsSession(chip=chip).chip, seed=0, n_reps=3)
        .run(WorkloadBuilder(get_config(ARCH), shape).build()), frac)
    assert [(p.core, p.mem) for p in got.pairs] \
        == [(p.core, p.mem) for p in want.pairs]
    assert got.auto_idx == want.auto_idx
    np.testing.assert_allclose(got.time, want.time, rtol=RTOL)
    np.testing.assert_allclose(got.energy, want.energy, rtol=RTOL)


# ---------------------------------------------------------------------------
# routers and whole fleets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["round-robin", "least-queue",
                                  "energy-slo", "cache-affinity"])
def test_router_placements_equal_reference(name):
    """Each arrival of a bursty trace lands on the same replica of the same
    heterogeneous fleet in both packages."""
    picks = {}
    for pkg, (fl, config, _) in PKGS.items():
        rt = _router(fl, name)
        route, log = rt.route, []

        def recording(req, pool, route=route, log=log):
            rep = route(req, pool)
            log.append((req.uid, rep.name, [r.name for r in pool]))
            return rep

        rt.route = recording
        fleet = fl.build_fleet(
            fl.parse_replica_specs("tpu-v5e:4,rtx3080ti:4,a4000:4"),
            config(ARCH), router=rt, seed=0, n_reps=3)
        fleet.serve(fl.generate_trace("bursty", n_requests=40,
                                      rate_rps=80.0, seed=1))
        picks[pkg] = log
    assert len(picks["port"]) == 40
    assert picks["port"] == picks["ref"]


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_report_equals_reference(name):
    want, ref_fleet, ref_events = _serve("ref", name)
    got, fleet, events = _serve("port", name)
    _assert_close(got, want)
    assert check_fleet(fleet.replicas, got) == []
    assert [r.state for r in fleet.replicas] \
        == [r.state for r in ref_fleet.replicas]
    if events is not None:
        _assert_close(events, ref_events, "events")


def test_fleet_configurations_exercise_their_features():
    """What each configuration is there for shows in its report."""
    rep = {name: _serve("port", name)[0] for name in FLEETS}
    assert rep["power-cap"]["fleet_governor"]["n_replans"] >= 1
    assert "loaded_tracking_err_frac" in rep["power-cap"]["power"]
    assert rep["autopark"]["parked_energy_j"] > 0.0
    assert rep["disaggregated"]["disaggregated"]
    assert rep["disaggregated"]["n_migrations"] > 0
    assert rep["disaggregated"]["migration_bytes"] > 0
    assert rep["storm"]["recovery"]["n_crashes"] >= 1
    assert rep["storm"]["n_stranded"] == 0
    assert rep["storm-no-recover"]["n_stranded"] > 0
    assert sum(b["prefix_cache"]["hits"]
               for b in rep["prefix-cache"]["replicas"]) > 0
    assert rep["energy-slo-transfer"]["n_completed"] == 60


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


def test_launcher_json_report_passes_check_fleet():
    argv = ["--replicas", "2xtpu-v5e:4", "--requests", "30", "--json"]
    res, text = _launch(launch.main, argv)
    rep = json.loads(text)
    assert check_fleet(res["fleet"].replicas, rep) == []
    assert rep["n_completed"] == 30
    _, ref_text = _launch(lambda a: _with_argv(jax_launch.main, a), argv)
    _assert_close(rep, json.loads(ref_text))


def _with_argv(main, argv):
    """Run a launcher whose ``main()`` reads ``sys.argv``."""
    old = sys.argv
    sys.argv = ["fleet"] + list(argv)
    try:
        return main()
    finally:
        sys.argv = old


def test_launcher_defaults_to_modeled_h100_replicas():
    res, text = _launch(launch.main, ["--requests", "24", "--rate", "40"])
    rep = res["report"]
    assert [b["chip"] for b in rep["replicas"]] == ["h100-like"] * 3
    assert check_fleet(res["fleet"].replicas, rep) == []
    assert "modeled" in text and "h100-like" in text
    assert "24/24 completed" in text


def test_capped_fleet_without_loaded_window():
    """A capped disaggregated fleet whose power windows never reach the
    loaded utilization: ``fleet_report`` (as in the reference) sets no
    tracking error, the reference's launcher raises reading it, and the
    port's prints that no window was loaded."""
    argv = ["--replicas", "tpu-v5e@prefill,2xtpu-v5e@decode",
            "--power-cap", "300", "--rate", "60", "--requests", "60"]
    with pytest.raises(KeyError, match="loaded_tracking_err_frac"):
        _launch(lambda a: _with_argv(jax_launch.main, a), argv)
    res, text = _launch(launch.main, argv)
    assert "loaded_tracking_err_frac" not in res["report"]["power"]
    assert "no loaded window" in text
    assert "60/60 completed" in text
    assert check_fleet(res["fleet"].replicas, res["report"]) == []
