"""The port's host-only examples (``repro_torch.examples.quickstart``,
``.plan_transfer``, ``.fleet_serve``) against the JAX package's
``examples/*.py``, in-process on the CPU with the reference's chip model:
the same printed lines, but for the port's first line (the chip model its
numbers are modeled on) and its line of host seconds; the saved plan's
``summary()`` equal to the reference's.  Then quickstart on its default
``h100`` chip model: the kernel-static plan spends no more energy than the
pass-level one, and no more time than auto (tau 0)."""
import importlib.util
import os
import sys

import pytest

from repro.dvfs import DvfsPlan as JaxPlan
from repro_torch.dvfs import DvfsPlan
from repro_torch.examples import fleet_serve, plan_transfer, quickstart
from repro_torch.examples._common import HOST_MARK
import torch_parity  # noqa: F401  (one intra-op thread a worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_lines(monkeypatch, capsys, name, flags=()):
    """Run the JAX package's ``examples/<name>.py`` ``main()`` with
    ``flags`` on its command line; its printed lines."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *flags])
    module.main()
    return capsys.readouterr().out.splitlines()


def port_lines(capsys, module, flags):
    """Run the port's ``main(flags)``; what it returned and printed, the
    printed lines without the chip line and the host-seconds lines."""
    capsys.readouterr()
    out = module.main(list(flags))
    printed = capsys.readouterr().out.splitlines()
    assert printed == out["lines"]
    chip = flags[flags.index("--chip") + 1]
    assert printed[0].startswith(f"chip model: {chip} ")
    assert "modeled" in printed[0]
    return out, [ln for ln in printed[1:] if HOST_MARK not in ln]


def test_quickstart_prints_the_references_lines(monkeypatch, capsys,
                                                tmp_path):
    monkeypatch.chdir(tmp_path)
    ref = reference_lines(monkeypatch, capsys, "quickstart")
    out, port = port_lines(capsys, quickstart, ["--chip", "rtx3080ti"])
    assert out["path"] == "artifacts/torch_quickstart_plan.json"
    assert port == [ln.replace("artifacts/quickstart_plan.json", out["path"])
                    for ln in ref]
    assert out["round_trips"] is True
    saved = DvfsPlan.load(out["path"])
    assert saved.summary() == out["plan"].summary() \
        == JaxPlan.load("artifacts/quickstart_plan.json").summary()
    # the abstract's 2% / 14.6%: pass-level against kernel-static
    assert out["plans"]["pass-level"]["energy_pct"] == pytest.approx(
        -1.75, abs=0.005)
    assert out["plans"]["kernel-static"]["energy_pct"] == pytest.approx(
        -14.46, abs=0.005)


def test_quickstart_on_the_h100_model(monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)
    out, port = port_lines(capsys, quickstart, ["--chip", "h100"])
    plans = out["plans"]
    assert out["round_trips"] is True
    assert plans["kernel-static"]["energy_pct"] <= \
        plans["pass-level"]["energy_pct"]
    # kernel-static plans at the default WastePolicy's tau 0: no slower
    assert plans["kernel-static"]["time_pct"] <= 1e-9
    assert DvfsPlan.load(out["path"]).chip_name == "h100-like"
    assert len(port) == 7


def test_plan_transfer_prints_the_references_lines(monkeypatch, capsys):
    ref = reference_lines(monkeypatch, capsys, "plan_transfer")
    out, port = port_lines(capsys, plan_transfer, ["--chip", "rtx3080ti"])
    assert port == ref
    assert sorted(out["dp"]) == [1, 2, 8, 20]
    assert sorted(out["tp"]) == [2, 4, 8, 16]


def test_plan_transfer_says_when_savings_do_not_transfer(capsys):
    out, port = port_lines(capsys, plan_transfer, ["--chip", "h100"])
    moved = [e for e, _ in (*out["dp"].values(), *out["tp"].values())]
    slowest = max(t for _, t in (*out["dp"].values(), *out["tp"].values()))
    holds = slowest <= plan_transfer.FEW_PP and max(
        abs(e - out["discovered"][0]) for e in moved) <= plan_transfer.FEW_PP
    assert not holds
    assert port[-1].startswith("savings do not transfer within 3 pp")
    assert f"{slowest:+.2f}%" in port[-1]
    assert not any("savings transfer within" in ln for ln in port)


def test_fleet_serve_prints_the_references_lines(monkeypatch, capsys):
    ref = reference_lines(monkeypatch, capsys, "fleet_serve")
    out, port = port_lines(capsys, fleet_serve, ["--chip", "tpu-v5e"])
    assert port == ref
    assert len(port) == 11
    assert out["capped"]["fleet_governor"]["n_replans"] > 0
    assert [b["state"] for b in out["parked"]["replicas"]].count(
        "parked") >= 1
