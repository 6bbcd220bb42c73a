"""repro.dvfs — the unified DVFS governor facade.

One plan IR (:class:`DvfsPlan`), pluggable policies
(:func:`governor` + the registry), pluggable frequency-controller
backends (:func:`controller`), governor-driven executors, and the
:class:`DvfsSession` context manager that strings campaign -> plan ->
govern -> meter -> report together for both the serving and the training
path.  The legacy entry points (``Plan``, ``PhasePlanBundle``,
``TrainPlanBundle``, ``runtime.dvfs_exec``) keep working as shims over
this package.

The port's copy of the JAX package's ``dvfs/__init__.py``.
"""
from .plan_ir import (SCHEMA_VERSION, GRANULARITIES, SCOPES, DvfsPlan,
                      PlanSegment, validate_plan_dict)
from .governors import (GOVERNORS, BaseGovernor, EDPGovernor, Governor,
                        OnlineGovernor, PassLevelGovernor,
                        StaticPlanGovernor, governor, plan_decode_joint,
                        register_governor)
from .controllers import (CONTROLLERS, RateLimitedController, controller,
                          register_controller)
from .executor import (GovernorExecutor, ServeGovernorExecutor,
                       TrainGovernorExecutor)
from .session import DvfsSession

__all__ = [
    "SCHEMA_VERSION", "GRANULARITIES", "SCOPES", "DvfsPlan", "PlanSegment",
    "validate_plan_dict", "GOVERNORS", "Governor", "BaseGovernor",
    "StaticPlanGovernor", "PassLevelGovernor", "EDPGovernor",
    "OnlineGovernor", "governor", "register_governor", "plan_decode_joint",
    "CONTROLLERS", "RateLimitedController", "controller",
    "register_controller", "GovernorExecutor", "ServeGovernorExecutor",
    "TrainGovernorExecutor", "DvfsSession",
]
