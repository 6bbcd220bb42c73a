"""The port's NVML module (``repro_torch.runtime.nvml``) on the CPU: the
``Trainer``'s measured energy meter over a stub counter, and ``Nvml()``
refusing to start where there is no NVML library.  The reads themselves
run on the card (``chip_smoke.py``'s dvfs phases)."""
import tempfile

import pytest

import torch_parity  # noqa: F401  (one intra-op thread a process)
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import DataPipeline
from repro_torch.models import build_model
from repro_torch.runtime import Nvml, NvmlStepMeter, StepReading
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train.loop import Trainer, TrainerConfig
from torch_parity import twin


class StubCounter:
    """``Nvml``'s two reads the meter takes: a running energy total in
    joules (a fixed sequence) and the (SM, memory) clocks."""

    def __init__(self, totals):
        self.totals = list(totals)
        self.reads = 0

    def energy_j(self):
        value = self.totals[self.reads]
        self.reads += 1
        return value

    def clocks_mhz(self):
        return (1980, 2619 - self.reads)


def test_meter_books_the_differences():
    stub = StubCounter([100.0, 112.5, 125.0, 150.0])
    meter = NvmlStepMeter(stub)                  # reads 100.0
    got = [meter.on_step(s) for s in range(3)]
    assert all(isinstance(r, StepReading) for r in got)
    assert [r.step for r in got] == [0, 1, 2]
    assert [r.energy_j for r in got] == [12.5, 12.5, 25.0]
    assert [r.clocks for r in got] == [(1980, 2617), (1980, 2616),
                                       (1980, 2615)]
    assert all(r.time_s >= 0.0 for r in got)
    assert meter.records == got
    tot = meter.totals()
    assert tot["steps"] == 3 and tot["energy_j"] == 50.0
    assert tot["time_s"] == sum(r.time_s for r in got)


def test_meter_is_the_trainers_energy_meter():
    """Three ``Trainer`` steps of the smoke twin on the CPU with the meter
    over a stub: one reading a step, booked in the history as the
    ``Trainer`` books its modeled meter, and the run's totals."""
    cfg = twin()[2]
    model = build_model(cfg, block_k=16, device="cpu")
    stub = StubCounter([10.0, 11.0, 13.0, 16.0])
    meter = NvmlStepMeter(stub)
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(
            model, make_train_step(model, OptimizerConfig(lr=1e-2)),
            DataPipeline(cfg.vocab_size, 2, 16), CheckpointManager(d),
            TrainerConfig(total_steps=3, ckpt_every=3), energy_meter=meter)
        out = trainer.run()
    assert [h["sim_energy_j"] for h in trainer.history] == [1.0, 2.0, 3.0]
    assert [h["sim_time_s"] for h in trainer.history] \
        == [r.time_s for r in meter.records]
    assert out["energy"] == meter.totals()
    assert out["energy"]["energy_j"] == 6.0 and stub.reads == 4


def test_nvml_raises_without_its_library():
    """No ``libnvidia-ml.so.1`` here: construction raises (no fallback to
    a modeled counter)."""
    with pytest.raises(OSError, match="libnvidia-ml"):
        Nvml()
