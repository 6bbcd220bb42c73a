"""The port's examples that build a model (``repro_torch.examples.
serve_dvfs``, ``.train_gpt3xl_dvfs``) against the JAX package's
``examples/*.py``, in-process on the CPU with the reference's chip model
and sizes (``--device cpu``: the kernels' plain versions).  The port's
model draws its own weights (the reference's come from ``jax.random``),
so what must agree is what does not depend on them: the plan lines, the
served requests' lengths and finishing steps (no EOS: they depend on
lengths only), the executed DVFS totals, the online governor's lines, the
parameter count and the restart count.  The trained losses need only be
finite.  Without ``--device cpu`` and without a card, each raises."""
import importlib.util
import math
import os
import sys

import pytest
import torch

from repro_torch.examples import serve_dvfs, train_gpt3xl_dvfs
from repro_torch.examples._common import HOST_MARK
from repro_torch.obs import check_executor
import torch_parity  # noqa: F401  (one intra-op thread a worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_FLAGS = ["--steps", "6", "--fail-at", "3", "--d-model", "64",
               "--layers", "2", "--seq", "64", "--batch", "4", "--vocab",
               "512"]


def reference_lines(monkeypatch, capsys, name, flags=()):
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
    capsys.readouterr()
    out = module.main(list(flags) + ["--chip", "tpu-v5e", "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert printed == out["lines"]
    assert printed[0].startswith("chip model: tpu-v5e ")
    return out, [ln for ln in printed[1:] if HOST_MARK not in ln]


def test_serve_dvfs_prints_the_references_lines(monkeypatch, capsys,
                                                tmp_path):
    monkeypatch.chdir(tmp_path)
    ref = reference_lines(monkeypatch, capsys, "serve_dvfs")
    out, port = port_lines(capsys, serve_dvfs, [])
    assert port == ref
    assert len(out["lines"]) == len(port) + 2     # the chip and host lines
    # every request served whole; the executor's hooks are the engine's
    reqs = out["requests"]
    assert all(r.done and len(r.generated) == r.max_new_tokens
               for r in reqs)
    assert out["tokens"] == sum(r.max_new_tokens for r in reqs)
    # one prefill hook a request admitted, one decode hook a decode step
    phases = out["executor"].summary()["phases"]
    assert phases["prefill"]["steps"] == len(reqs) == 10
    assert sum(r["steps"] for n, r in phases.items() if n != "prefill") \
        == out["n_decode_steps"]
    assert out["executed"]["steps"] == len(reqs) + out["n_decode_steps"]
    assert check_executor(out["executor"]) == []
    assert os.path.exists(out["path"])
    assert out["online"]["energy_j"] < out["stale"]["energy_j"]


def test_train_gpt3xl_dvfs_prints_the_references_lines(monkeypatch, capsys,
                                                       tmp_path):
    monkeypatch.chdir(tmp_path)
    ref = reference_lines(monkeypatch, capsys, "train_gpt3xl_dvfs",
                          TRAIN_FLAGS)
    out, port = port_lines(capsys, train_gpt3xl_dvfs, TRAIN_FLAGS)

    def without_losses(lines):
        return [ln.split(" over ", 1)[1] if ln.startswith("loss ") else ln
                for ln in lines]
    assert without_losses(port) == without_losses(ref)
    assert len(port) == len(ref) == 6
    done = out["done"]
    assert done["restarts"] == 1 and done["final_step"] == 6
    # steps 0-2, the failure at 3; the first checkpoint comes at step 10 or
    # the last, so the restart begins afresh at 0
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 0, 1, 2, 3, 4,
                                                   5]
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    assert check_executor(out["executor"]) == []
    assert os.path.exists(os.path.join("artifacts", "torch_train_gpt3xl",
                                       "ckpt_00000006", "index.json"))


@pytest.mark.parametrize("module", [serve_dvfs, train_gpt3xl_dvfs])
def test_device_example_raises_without_a_card(module, tmp_path,
                                              monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--steps", "1"] if module is train_gpt3xl_dvfs
                    else [])
