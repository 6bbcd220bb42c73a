from .energy import FrequencyController, SimulatedController, EnergyMeter, \
    StepEnergy
from .dvfs_exec import PhaseExecutor, TrainPhaseExecutor
from .ft import (FailureInjector, InjectedFailure, StragglerEvent,
                 StragglerWatchdog)
from .nvml import Nvml, NvmlStepMeter, StepReading

__all__ = ["FrequencyController", "SimulatedController", "EnergyMeter",
           "StepEnergy", "PhaseExecutor", "TrainPhaseExecutor",
           "FailureInjector", "InjectedFailure", "StragglerEvent",
           "StragglerWatchdog", "Nvml", "NvmlStepMeter", "StepReading"]
