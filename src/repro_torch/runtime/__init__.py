from .ft import (FailureInjector, InjectedFailure, StragglerEvent,
                 StragglerWatchdog)

__all__ = ["FailureInjector", "InjectedFailure", "StragglerEvent",
           "StragglerWatchdog"]
