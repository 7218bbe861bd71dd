"""Trace recorder for the serving path.

``TraceRecorder`` collects **spans** (begin/end pairs), **instant
events** and **counter samples**, each stamped on the *modeled* clock
(the ``M2CacheEngine`` transfer clock, in seconds) with the wall clock
(``time.perf_counter``) recorded side-by-side. Events live in a bounded
ring buffer — when it overflows the oldest events are dropped and the
drop is accounted (``dropped_events``), never silently.

Two invariants keep instrumentation safe to leave on:

* Recording NEVER advances the modeled clock — emitters pass the
  current engine time (or the recorder reads it through an attached
  ``clock`` callable); the recorder only stores floats. Modeled tok/s
  with tracing on is therefore *identical* to tracing off, which
  ``benchmarks/serving_obs.py`` asserts.
* Recording never touches RNG or model state, so generated tokens are
  byte-identical with tracing on/off.

``export_chrome`` writes Chrome ``trace_event`` JSON (the
``{"traceEvents": [...]}`` envelope) that loads directly in Perfetto /
``chrome://tracing``: spans as ``ph="X"`` complete events, instants as
``ph="i"``, counters as ``ph="C"``. Modeled seconds map to trace
microseconds; each track becomes a named thread via ``ph="M"``
``thread_name`` metadata. Wall-clock timestamps ride along in each
event's ``args`` (``wall_s``) — see ``docs/OBSERVABILITY.md`` for the
modeled-vs-wall semantics.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

#: event kinds stored in the ring buffer
SPAN = "span"          # completed span: t .. t + dur
INSTANT = "instant"
COUNTER = "counter"

DEFAULT_CAPACITY = 200_000


@dataclasses.dataclass
class TraceEvent:
    kind: str                 # SPAN | INSTANT | COUNTER
    track: str                # display track (Chrome "thread")
    name: str
    t: float                  # modeled seconds (raw engine clock)
    dur: float = 0.0          # modeled seconds; spans only
    wall_s: float = 0.0       # wall clock at emission (perf_counter)
    args: Optional[Dict[str, Any]] = None


class _OpenSpan:
    __slots__ = ("track", "name", "t0", "wall0", "args")

    def __init__(self, track, name, t0, wall0, args):
        self.track, self.name = track, name
        self.t0, self.wall0, self.args = t0, wall0, args


class TraceRecorder:
    """Bounded-ring trace recorder on the modeled clock.

    ``clock`` (optional) is a zero-arg callable returning the current
    modeled time; emitters that do not pass an explicit ``t`` fall back
    to it. All timestamps are *raw* engine-clock seconds — consumers
    work in differences (TTFT = first_token − queued start) so the
    origin never matters.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._clock = clock
        self._open: Dict[int, _OpenSpan] = {}
        self._next_sid = 0
        self.total_events = 0      # lifetime emits (incl. dropped)
        self.dropped_events = 0    # evicted by ring overflow

    # -- clock ---------------------------------------------------------
    def set_default_clock(self, clock: Optional[Callable[[], float]]):
        self._clock = clock

    def _now(self, t: Optional[float]) -> float:
        if t is not None:
            return float(t)
        if self._clock is not None:
            return float(self._clock())
        return 0.0

    # -- emission ------------------------------------------------------
    def _push(self, ev: TraceEvent):
        self.total_events += 1
        if len(self._events) == self.capacity:
            self.dropped_events += 1
        self._events.append(ev)

    def span_begin(self, track: str, name: str,
                   t: Optional[float] = None, **args) -> int:
        """Open a span; returns a span id for :meth:`span_end`."""
        sid = self._next_sid
        self._next_sid += 1
        self._open[sid] = _OpenSpan(track, name, self._now(t),
                                    time.perf_counter(), dict(args) or None)
        return sid

    def span_end(self, sid: int, t: Optional[float] = None, **args):
        """Close span ``sid``; extra ``args`` merge into the span's."""
        op = self._open.pop(sid, None)
        if op is None:
            return
        t1 = self._now(t)
        merged = dict(op.args or {})
        merged.update(args)
        self._push(TraceEvent(SPAN, op.track, op.name, op.t0,
                              dur=max(0.0, t1 - op.t0), wall_s=op.wall0,
                              args=merged or None))

    def span(self, track: str, name: str, t0: float, t1: float, **args):
        """Emit an already-complete span in one call."""
        self._push(TraceEvent(SPAN, track, name, float(t0),
                              dur=max(0.0, float(t1) - float(t0)),
                              wall_s=time.perf_counter(),
                              args=dict(args) or None))

    def instant(self, track: str, name: str,
                t: Optional[float] = None, **args):
        self._push(TraceEvent(INSTANT, track, name, self._now(t),
                              wall_s=time.perf_counter(),
                              args=dict(args) or None))

    def counter(self, track: str, name: str,
                t: Optional[float] = None, **values):
        """Counter sample; ``values`` are the series of the counter."""
        self._push(TraceEvent(COUNTER, track, name, self._now(t),
                              wall_s=time.perf_counter(),
                              args={k: float(v) for k, v in values.items()}))

    # -- access --------------------------------------------------------
    def events(self) -> List[TraceEvent]:
        """Events currently in the ring, oldest first."""
        return list(self._events)

    def open_spans(self) -> int:
        return len(self._open)

    def stats(self) -> Dict[str, int]:
        return {"trace_events": len(self._events),
                "trace_total_events": self.total_events,
                "trace_dropped_events": self.dropped_events,
                "trace_open_spans": len(self._open)}

    # -- export --------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON object (Perfetto-loadable)."""
        pid = 1
        tids: Dict[str, int] = {}
        out: List[Dict[str, Any]] = []
        for ev in self._events:
            tid = tids.get(ev.track)
            if tid is None:
                tid = tids[ev.track] = len(tids) + 1
            args = dict(ev.args or {})
            args["wall_s"] = round(ev.wall_s, 6)
            rec = {"name": ev.name, "pid": pid, "tid": tid,
                   "ts": ev.t * 1e6}
            if ev.kind == SPAN:
                rec.update(ph="X", dur=ev.dur * 1e6, args=args)
            elif ev.kind == INSTANT:
                rec.update(ph="i", s="t", args=args)
            else:  # COUNTER — args ARE the series; wall_s would plot too
                args.pop("wall_s", None)
                rec.update(ph="C", args=args)
            out.append(rec)
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": track}} for track, tid in tids.items()]
        return {"traceEvents": meta + out,
                "displayTimeUnit": "ms",
                "otherData": {"clock": "modeled_seconds",
                              "dropped_events": self.dropped_events,
                              "total_events": self.total_events}}

    def export_chrome(self, path) -> str:
        obj = self.to_chrome()
        with open(path, "w") as f:
            json.dump(obj, f)
        return str(path)
