"""Fault-tolerant training loop.

The port of the JAX package's ``train/loop.py``: the train step, the data
pipeline (resumable cursor), a checkpoint every ``ckpt_every`` steps and at
the last, restart from the latest checkpoint on an ``InjectedFailure``
(at most ``max_restarts`` times), the straggler watchdog, and one history
record per step run.

Two duck-typed hooks book each step, as in the reference:

* ``energy_meter`` — ``on_step(step)`` returning an object with
  ``time_s`` and ``energy_j``, and ``totals()`` for the run report;
* ``executor`` — ``on_step(step)`` (the same return), ``finish()``,
  ``summary()``, ``reset()``, ``state_dict()`` and ``load_state_dict(d)``;
  its state rides in the checkpoint's ``extra["dvfs_exec"]``, so a restart
  resumes its books.

The loop imports nothing of a DVFS stack: the port's own
(``repro_torch.dvfs``'s ``TrainGovernorExecutor``), or any object with
these methods, plugs in.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..ckpt import CheckpointManager
from ..data import DataPipeline
from ..runtime.ft import FailureInjector, InjectedFailure, StragglerWatchdog
from .step import TrainState, init_train_state


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    max_restarts: int = 3


class Trainer:
    def __init__(self, model, train_step: Callable, pipeline: DataPipeline,
                 ckpt: CheckpointManager, cfg: TrainerConfig,
                 energy_meter=None, executor=None,
                 failure_injector: Optional[FailureInjector] = None,
                 seed: int = 0):
        self.model = model
        self.train_step = train_step
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.cfg = cfg
        self.meter = energy_meter
        self.executor = executor
        self.injector = failure_injector
        self.watchdog = StragglerWatchdog()
        self.seed = seed
        self.history: List[Dict] = []
        self.restarts = 0

    # ------------------------------------------------------------------
    def _fresh_state(self) -> TrainState:
        return init_train_state(self.model, self.seed)

    def _restore_or_init(self) -> Tuple[Any, int]:
        step = self.ckpt.latest_step()
        if step is None:
            if self.executor is not None:
                # no checkpoint to resume: drop any books from an aborted
                # attempt so re-run steps are not double-counted
                self.executor.reset()
            return self._fresh_state(), 0
        state, index = self.ckpt.restore(self._fresh_state())
        extra = index.get("extra", {})
        if "pipeline" in extra:
            self.pipeline.load_state_dict(extra["pipeline"])
        if self.executor is not None:
            if "dvfs_exec" in extra:
                self.executor.load_state_dict(extra["dvfs_exec"])
            else:
                self.executor.reset()
        return state, int(index["step"])

    def _save(self, step: int, state: TrainState) -> None:
        extra = {"pipeline": self.pipeline.state_dict()}
        if self.executor is not None:
            extra["dvfs_exec"] = self.executor.state_dict()
        self.ckpt.save(step, state, extra=extra)

    # ------------------------------------------------------------------
    def run(self) -> Dict:
        """Run to total_steps, restarting from checkpoints on failure."""
        while True:
            try:
                return self._run_once()
            except InjectedFailure as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts: {e}") from e

    def _run_once(self) -> Dict:
        state, start = self._restore_or_init()
        for step in range(start, self.cfg.total_steps):
            if self.injector is not None:
                self.injector.check(step)
            batch = self.pipeline.next_batch()
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])        # waits for the step
            dt = time.perf_counter() - t0
            self.watchdog.observe(step, dt)
            rec = {"step": step, "loss": loss, "wall_s": dt,
                   "restarts": self.restarts}
            if self.meter is not None:
                e = self.meter.on_step(step)
                rec.update({"sim_time_s": e.time_s,
                            "sim_energy_j": e.energy_j})
            if self.executor is not None:
                e = self.executor.on_step(step)
                rec.update({"dvfs_time_s": e.time_s,
                            "dvfs_energy_j": e.energy_j})
            self.history.append(rec)
            next_step = step + 1
            if next_step % self.cfg.ckpt_every == 0 \
                    or next_step == self.cfg.total_steps:
                self._save(next_step, state)
        out = {"final_step": self.cfg.total_steps,
               "final_loss": self.history[-1]["loss"] if self.history
               else None,
               "restarts": self.restarts,
               "straggler_events": len(self.watchdog.events)}
        if self.meter is not None:
            out["energy"] = self.meter.totals()
        if self.executor is not None:
            self.executor.finish()
            out["dvfs"] = self.executor.summary()
        return out
