"""Modeled-time span/event recorder emitting Chrome ``trace_event`` JSON.

The :class:`Tracer` is deliberately dumb: callers hand it already-known
modeled timestamps (replica clocks, executor dwell integrals, engine
decode-step counts) and it appends canonical schema events — no wall
clock anywhere, so a re-run of the same seeded scenario produces a
byte-identical trace.  :meth:`Tracer.to_dict` derives a Chrome
``traceEvents`` view (one ``pid`` track per replica/phase, ``tid`` per
category) loadable in Perfetto / ``chrome://tracing``.

:class:`NullTracer` is the disabled twin: every method is a no-op and
``enabled`` is False, so instrumented hot paths guard with one
attribute check and pay nothing when tracing is off.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from .schema import OBS_SCHEMA_VERSION, make_event, validate_trace_dict

#: microseconds per modeled second (Chrome trace ts unit)
_US = 1e6


class Tracer:
    """Append-only recorder of schema events on modeled time."""

    enabled = True

    def __init__(self, meta: Optional[Dict] = None):
        self.meta: Dict = dict(meta or {})
        self.events: List[Dict] = []

    # -- emission ----------------------------------------------------------
    def span(self, track: str, name: str, ts: float, dur: float,
             cat: str = "phase", args: Optional[Dict] = None) -> None:
        self.events.append(
            make_event("span", cat, name, track, ts, dur=dur, args=args))

    def aspan(self, track: str, name: str, ts: float, dur: float,
              id: object, cat: str = "migration",
              args: Optional[Dict] = None) -> None:
        self.events.append(
            make_event("aspan", cat, name, track, ts, dur=dur, id=id,
                       args=args))

    def instant(self, track: str, name: str, ts: float,
                cat: str = "lifecycle",
                args: Optional[Dict] = None) -> None:
        self.events.append(
            make_event("instant", cat, name, track, ts, args=args))

    def counter(self, track: str, name: str, ts: float, values: Dict,
                cat: str = "power") -> None:
        self.events.append(
            make_event("counter", cat, name, track, ts, args=values))

    def extend(self, events) -> None:
        self.events.extend(events)

    def note_segment(self, track: str, name: str, revision: int,
                     breakdown: Dict) -> None:
        """Stash a per-kernel planned-vs-auto breakdown for one mounted
        plan segment (keyed so re-plans keep every revision's view);
        ``trace_view --waste`` joins executed spans against these."""
        key = f"{track}|{name}|r{revision}"
        self.meta.setdefault("segments", {})[key] = breakdown

    # -- serialization -----------------------------------------------------
    def chrome(self) -> List[Dict]:
        """Derive the Chrome ``trace_event`` list: spans become B/E
        pairs, async spans b/e pairs (correlated by id — migrations may
        overlap), instants ``i``, counters ``C``; globally sorted so ts
        is non-decreasing (close events sort before opens at equal ts,
        keeping back-to-back spans nested correctly)."""
        raw: List = []
        for seq, ev in enumerate(self.events):
            pid, tid = ev["track"], ev["cat"]
            name, ts = ev["name"], ev["ts"] * _US
            args = ev.get("args")
            base = {"pid": pid, "tid": tid, "name": name, "cat": tid}
            if ev["kind"] == "span":
                end = ts + ev["dur"] * _US
                raw.append((ts, 1, seq, dict(base, ph="B", ts=ts,
                                             **({"args": args} if args
                                                else {}))))
                raw.append((end, 0, seq, dict(base, ph="E", ts=end)))
            elif ev["kind"] == "aspan":
                end = ts + ev["dur"] * _US
                eid = str(ev["id"])
                raw.append((ts, 1, seq, dict(base, ph="b", ts=ts, id=eid,
                                             **({"args": args} if args
                                                else {}))))
                raw.append((end, 0, seq, dict(base, ph="e", ts=end,
                                              id=eid)))
            elif ev["kind"] == "counter":
                raw.append((ts, 1, seq, dict(base, ph="C", ts=ts,
                                             args=args or {})))
            else:
                raw.append((ts, 1, seq, dict(base, ph="i", ts=ts, s="t",
                                             **({"args": args} if args
                                                else {}))))
        raw.sort(key=lambda r: (r[0], r[1], r[2]))
        return [r[3] for r in raw]

    def to_dict(self) -> Dict:
        return {"obs_schema_version": OBS_SCHEMA_VERSION,
                "meta": self.meta,
                "events": list(self.events),
                "traceEvents": self.chrome()}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=float)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))
            f.write("\n")
        return path

    # -- loading -----------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict) -> "Tracer":
        errs = validate_trace_dict(d)
        if errs:
            raise ValueError("invalid trace document: " + "; ".join(errs))
        tr = cls(meta=d.get("meta"))
        tr.events = [dict(ev) for ev in d.get("events", [])]
        return tr

    @classmethod
    def from_json(cls, text: str) -> "Tracer":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "Tracer":
        with open(path) as f:
            return cls.from_json(f.read())


class NullTracer:
    """Disabled tracer: one shared instance, every method a no-op, so
    the instrumented hot paths cost a single truthiness check."""

    enabled = False
    events: tuple = ()
    meta: Dict = {}

    def span(self, *a, **k) -> None:
        pass

    def aspan(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    def extend(self, *a, **k) -> None:
        pass

    def note_segment(self, *a, **k) -> None:
        pass


#: the shared disabled tracer instrumented code defaults to
NULL_TRACER = NullTracer()
