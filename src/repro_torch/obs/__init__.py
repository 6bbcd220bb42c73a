"""Trace recording for the port's serving engine: the event schema and the
modeled-time :class:`Tracer` with its disabled twin :data:`NULL_TRACER`."""
from .schema import CATEGORIES, KINDS, OBS_SCHEMA_VERSION, make_event, \
    validate_trace_dict
from .tracer import NULL_TRACER, NullTracer, Tracer

__all__ = ["OBS_SCHEMA_VERSION", "KINDS", "CATEGORIES", "make_event",
           "validate_trace_dict", "Tracer", "NullTracer", "NULL_TRACER"]
