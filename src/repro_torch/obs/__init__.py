"""Observability of the port: the trace event schema and the modeled-time
:class:`Tracer` with its disabled twin :data:`NULL_TRACER`, the metrics
registry, and the energy-conservation ledger with its ``check_*``
reconciliations (``metrics.py`` and ``ledger.py`` are copies of the JAX
package's)."""
from .ledger import (EnergyLedger, check_executor, check_fleet,
                     check_replica, executor_ledger, fleet_ledger,
                     replica_ledger, segment_breakdown)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .schema import (CATEGORIES, KINDS, OBS_SCHEMA_VERSION,
                     from_controller_events, from_governor_events,
                     from_recovery_books, from_replica_events,
                     ingest_legacy_streams, make_event,
                     validate_trace_dict)
from .tracer import NULL_TRACER, NullTracer, Tracer

__all__ = ["OBS_SCHEMA_VERSION", "KINDS", "CATEGORIES", "make_event",
           "validate_trace_dict", "from_governor_events",
           "from_controller_events", "from_replica_events",
           "from_recovery_books", "ingest_legacy_streams", "Tracer",
           "NullTracer", "NULL_TRACER",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "EnergyLedger", "segment_breakdown", "executor_ledger",
           "replica_ledger", "fleet_ledger", "check_executor",
           "check_replica", "check_fleet"]
