"""Versioned wire schema of the trace events (a copy of the JAX package's
``obs/schema.py``, so traces from either package validate and load alike).

The document carries an explicit ``obs_schema_version`` and ships with a
hand-rolled validator (:func:`validate_trace_dict`).  The converters at the
end fold the legacy event streams (governor re-plans, controller records,
replica lifecycle instants, the fleet's fault/recovery books) into schema
events.

Canonical event record (plain dicts, JSON-stable)::

    {"kind": "span",          # span | aspan | instant | counter
     "cat":  "phase",         # see CATEGORIES
     "name": "decode@4",      # what happened
     "track": "r0-tpu-v5e",   # who it happened on (one timeline each)
     "ts":   1.25e-3,         # modeled seconds (NEVER wall clock)
     "dur":  3.1e-4,          # spans only
     "id":   17,              # aspan only: correlation id (may overlap)
     "args": {...}}           # optional payload

A trace *document* wraps the events with run metadata and a derived
Chrome ``trace_event`` view (``traceEvents``) loadable in Perfetto::

    {"obs_schema_version": 1, "meta": {...},
     "events": [...], "traceEvents": [...]}

Timestamps are modeled time (replica clocks, executor dwell integrals,
or engine decode-step counts), so the same run replays to a
bit-identical trace.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

OBS_SCHEMA_VERSION = 1

#: event kinds: sync span (non-overlapping per track), async span
#: (correlated by ``id``; may overlap — e.g. in-flight migrations),
#: point instant, counter sample
KINDS = ("span", "aspan", "instant", "counter")

#: what the event is about — the filterable dimension tools group by
CATEGORIES = (
    "phase",       # prefill/decode/train segment executions
    "freq",        # frequency-switch activity at the controller
    "replan",      # governor re-plans (online drift, fleet cap ticks)
    "migration",   # KV page-block transfers between replicas
    "fault",       # injected faults, crashes, link drops, driver fails
    "recovery",    # re-dispatch / re-delivery / re-prefill activity
    "cache",       # radix prefix-cache hits / evictions / flushes
    "lifecycle",   # drain / park / unpark / evict replica transitions
    "power",       # cluster power-window samples
)
#: replica lifecycle event names that are really fault-side records
_FAULT_EVENTS = frozenset({
    "crash", "evicted", "driver-fail", "driver-fail-skipped",
    "thermal-cap", "thermal-lift"})


def make_event(kind: str, cat: str, name: str, track: str, ts: float,
               dur: Optional[float] = None, id: Optional[object] = None,
               args: Optional[Dict] = None) -> Dict:
    """Build one canonical event dict (minimal keys, JSON-stable)."""
    ev: Dict = {"kind": kind, "cat": cat, "name": name,
                "track": track, "ts": float(ts)}
    if dur is not None:
        ev["dur"] = float(dur)
    if id is not None:
        ev["id"] = id
    if args:
        ev["args"] = args
    return ev


# ---------------------------------------------------------------------------
# validation (the plan_ir.validate_plan_dict idiom: a list of problems,
# empty when the document is loadable)
# ---------------------------------------------------------------------------

def _check_event(ev: object, where: str, errs: List[str]) -> None:
    if not isinstance(ev, dict):
        errs.append(f"{where} must be an object, got {type(ev).__name__}")
        return
    kind = ev.get("kind")
    if kind not in KINDS:
        errs.append(f"{where}.kind must be one of {KINDS}, got {kind!r}")
    if ev.get("cat") not in CATEGORIES:
        errs.append(f"{where}.cat must be one of {CATEGORIES}, "
                    f"got {ev.get('cat')!r}")
    for key in ("name", "track"):
        if not isinstance(ev.get(key), str) or not ev.get(key):
            errs.append(f"{where}.{key} must be a non-empty string")
    ts = ev.get("ts")
    if not isinstance(ts, (int, float)) or isinstance(ts, bool) \
            or ts < 0.0:
        errs.append(f"{where}.ts must be a number >= 0 (modeled "
                    f"seconds), got {ts!r}")
    if kind in ("span", "aspan"):
        dur = ev.get("dur")
        if not isinstance(dur, (int, float)) or isinstance(dur, bool) \
                or dur < 0.0:
            errs.append(f"{where}.dur must be a number >= 0 for "
                        f"{kind} events, got {dur!r}")
    if kind == "aspan" and "id" not in ev:
        errs.append(f"{where}.id is required for aspan events "
                    f"(the correlation id overlapping spans pair on)")
    if "args" in ev and not isinstance(ev["args"], dict):
        errs.append(f"{where}.args must be an object when present")


def _check_chrome(ev: object, where: str, errs: List[str]) -> None:
    if not isinstance(ev, dict):
        errs.append(f"{where} must be an object")
        return
    ph = ev.get("ph")
    if ph not in ("B", "E", "b", "e", "i", "C"):
        errs.append(f"{where}.ph must be one of B/E/b/e/i/C, got {ph!r}")
    if not isinstance(ev.get("ts"), (int, float)) \
            or isinstance(ev.get("ts"), bool):
        errs.append(f"{where}.ts must be a number (microseconds)")
    for key in ("pid", "tid", "name"):
        if key not in ev:
            errs.append(f"{where}.{key} is required")


def validate_trace_dict(d: Dict) -> List[str]:
    """Return every problem that would make the trace unloadable (or
    un-renderable in Perfetto); an empty list means the document is a
    valid version-``OBS_SCHEMA_VERSION`` trace."""
    errs: List[str] = []
    if not isinstance(d, dict):
        return [f"trace must be an object, got {type(d).__name__}"]
    ver = d.get("obs_schema_version")
    if ver != OBS_SCHEMA_VERSION:
        errs.append(f"obs_schema_version must be {OBS_SCHEMA_VERSION}, "
                    f"got {ver!r}")
    if "meta" in d and not isinstance(d["meta"], dict):
        errs.append("meta must be an object when present")
    events = d.get("events")
    if not isinstance(events, list):
        errs.append("events must be a list")
        events = []
    for i, ev in enumerate(events):
        _check_event(ev, f"events[{i}]", errs)
    chrome = d.get("traceEvents")
    if chrome is not None:
        if not isinstance(chrome, list):
            errs.append("traceEvents must be a list when present")
        else:
            for i, ev in enumerate(chrome):
                _check_chrome(ev, f"traceEvents[{i}]", errs)
            ts = [ev.get("ts") for ev in chrome
                  if isinstance(ev, dict)
                  and isinstance(ev.get("ts"), (int, float))]
            if any(b < a for a, b in zip(ts, ts[1:])):
                errs.append("traceEvents timestamps must be "
                            "non-decreasing")
    return errs


# ---------------------------------------------------------------------------
# converters: the three legacy event streams -> schema events
# ---------------------------------------------------------------------------

def from_governor_events(events: Sequence[Dict], track: str = "governor",
                         ts: float = 0.0) -> List[Dict]:
    """``BaseGovernor.events`` / ``OnlineGovernor.events`` records
    (``{"revision", "reason", ...}``; no timestamps of their own — the
    caller supplies the modeled time they are folded in at)."""
    out = []
    for ev in events:
        name = "replan" if ev.get("revision", 1) > 1 else "adopt"
        args = {k: v for k, v in ev.items()}
        out.append(make_event("instant", "replan", name, track, ts,
                              args=args))
    return out


def from_controller_events(events: Sequence[Dict],
                           track: str = "controller") -> List[Dict]:
    """``RateLimitedController.controller_events`` records (each carries
    ``t`` in the controller's modeled busy time).  ``driver-fault``
    windows are fault events; ``set-freq-*`` outcomes are frequency
    actuation events."""
    out = []
    for ev in events:
        name = str(ev.get("event", "controller"))
        cat = "fault" if name.startswith("driver") else "freq"
        args = {k: v for k, v in ev.items() if k not in ("t", "event")}
        out.append(make_event("instant", cat, name, track,
                              float(ev.get("t", 0.0)), args=args or None))
    return out


def from_replica_events(events: Sequence[Dict],
                        track: str) -> List[Dict]:
    """``Replica.events`` lifecycle records (``{"t", "event", ...}``);
    crash/evict/driver records classify as faults."""
    out = []
    for ev in events:
        name = str(ev.get("event", "event"))
        cat = "fault" if name in _FAULT_EVENTS else "lifecycle"
        args = {k: v for k, v in ev.items() if k not in ("t", "event")}
        out.append(make_event("instant", cat, name, track,
                              float(ev.get("t", 0.0)), args=args or None))
    return out


def from_recovery_books(recovery: Dict, track: str = "fleet",
                        ts: float = 0.0) -> List[Dict]:
    """The fleet's fault/recovery books -> one counter sample carrying
    the scalar tallies (nested crash books ride as an instant each)."""
    scalars = {k: v for k, v in recovery.items()
               if isinstance(v, (int, float))}
    out = [make_event("counter", "recovery", "recovery_books", track, ts,
                      args=scalars)]
    for name, books in (recovery.get("crash_books") or {}).items():
        out.append(make_event("instant", "fault", "crash_books", track,
                              ts, args={"replica": name, **books}))
    return out


def ingest_legacy_streams(tracer, *, governor_events: Iterable = (),
                          controller_events: Iterable = (),
                          replica_events: Iterable = (),
                          recovery: Optional[Dict] = None,
                          track: str = "legacy",
                          ts: float = 0.0) -> int:
    """Fold any of the legacy streams into a tracer; returns the number
    of events added (0 on a :class:`~repro.obs.tracer.NullTracer`)."""
    if not getattr(tracer, "enabled", False):
        return 0
    evs = from_governor_events(list(governor_events), track, ts)
    evs += from_controller_events(list(controller_events), track)
    evs += from_replica_events(list(replica_events), track)
    if recovery is not None:
        evs += from_recovery_books(recovery, track, ts)
    tracer.extend(evs)
    return len(evs)
