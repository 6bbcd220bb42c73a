"""Legacy executor entry points — thin shims over ``repro.dvfs``.

The replay + accounting machinery that used to live here
(``_BundleExecutor``) moved into the governor-driven
:class:`~repro.dvfs.executor.GovernorExecutor`; the two classes below
keep the historical bundle-first constructors working:

* ``PhaseExecutor(bundle, chip)`` — serving replay of a
  :class:`~repro.core.phase_plan.PhasePlanBundle`;
* ``TrainPhaseExecutor(bundle, chip)`` — training replay of a
  :class:`~repro.core.phase_plan.TrainPlanBundle`.

Both wrap the bundle in a
:class:`~repro.dvfs.governors.StaticPlanGovernor` via the lossless IR
converters and inherit everything else (hooks, metering, summary,
checkpoint state) unchanged.  New code should use
:class:`~repro.dvfs.DvfsSession` (or construct the governor executors
directly); constructing these shims emits a :class:`DeprecationWarning`.

The port's copy of the JAX package's ``runtime/dvfs_exec.py``.
"""
from __future__ import annotations

import warnings
from typing import Optional

from ..core.phase_plan import PhasePlanBundle, TrainPlanBundle
from ..core.power_model import Chip
from ..dvfs.executor import ServeGovernorExecutor, TrainGovernorExecutor
from ..dvfs.governors import StaticPlanGovernor
from ..dvfs.plan_ir import DvfsPlan
from .energy import FrequencyController


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"repro.runtime.dvfs_exec.{old} is deprecated; use "
                  f"{new} from repro.dvfs instead",
                  DeprecationWarning, stacklevel=3)


class PhaseExecutor(ServeGovernorExecutor):
    """Deprecated shim: replays a PhasePlanBundle around serve phases."""

    def __init__(self, bundle: PhasePlanBundle, chip: Chip,
                 controller: Optional[FrequencyController] = None):
        _deprecated("PhaseExecutor",
                    "DvfsSession.serve_executor() / ServeGovernorExecutor")
        gov = StaticPlanGovernor(DvfsPlan.from_phase_bundle(bundle))
        super().__init__(gov, chip, controller)
        self.bundle = bundle


class TrainPhaseExecutor(TrainGovernorExecutor):
    """Deprecated shim: replays a TrainPlanBundle around train steps."""

    def __init__(self, bundle: TrainPlanBundle, chip: Chip,
                 controller: Optional[FrequencyController] = None):
        _deprecated("TrainPhaseExecutor",
                    "DvfsSession.train_executor() / TrainGovernorExecutor")
        gov = StaticPlanGovernor(DvfsPlan.from_train_bundle(bundle))
        super().__init__(gov, chip, controller)
        self.bundle = bundle
