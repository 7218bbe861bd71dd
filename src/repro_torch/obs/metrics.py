"""Metrics registry: counters, gauges, histograms.

A ``MetricsRegistry`` is the process-wide (well, run-wide) home for
numeric series the serving path increments as it goes. Three metric
kinds, matching the Prometheus data model closely enough that
``to_prometheus`` emits valid exposition text:

* ``Counter`` — monotonically increasing (``inc``).
* ``Gauge`` — set to the current value (``set``/``inc``/``dec``).
* ``Histogram`` — observations bucketed by fixed upper bounds, with
  ``_count`` / ``_sum`` and cumulative ``_bucket`` series.

Metrics may carry label sets (``registry.counter("x", tier="hbm")``);
each distinct label set is its own series. ``snapshot()`` returns a
plain dict for JSON dumps; ``PeriodicSnapshotter`` appends one snapshot
line (JSONL) every ``interval_s`` of *modeled* time — driven by the
caller's ``tick(now)``, never by wall-clock threads, so snapshots are
deterministic and free on the modeled clock.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   50.0, 100.0, 500.0)


def _labelkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self.series: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError("counters only go up")
        k = _labelkey(labels)
        self.series[k] = self.series.get(k, 0.0) + float(value)

    def get(self, **labels) -> float:
        return self.series.get(_labelkey(labels), 0.0)


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self.series: Dict[Tuple, float] = {}

    def set(self, value: float, **labels):
        self.series[_labelkey(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels):
        k = _labelkey(labels)
        self.series[k] = self.series.get(k, 0.0) + float(value)

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def get(self, **labels) -> float:
        return self.series.get(_labelkey(labels), 0.0)


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label set: (bucket counts [len+1 for +Inf], count, sum)
        self.series: Dict[Tuple, List[Any]] = {}

    def observe(self, value: float, **labels):
        k = _labelkey(labels)
        st = self.series.get(k)
        if st is None:
            st = self.series[k] = [[0] * (len(self.buckets) + 1), 0, 0.0]
        v = float(value)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                st[0][i] += 1
                break
        else:
            st[0][-1] += 1
        st[1] += 1
        st[2] += v

    def count(self, **labels) -> int:
        st = self.series.get(_labelkey(labels))
        return st[1] if st else 0

    def sum(self, **labels) -> float:
        st = self.series.get(_labelkey(labels))
        return st[2] if st else 0.0


class MetricsRegistry:
    """Create-or-get factory plus exporters."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help_: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help_, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def get(self, name: str):
        """Registered metric by name (None when absent) — the health
        engine's read-only lookup."""
        return self._metrics.get(name)

    # -- export --------------------------------------------------------
    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Plain-dict snapshot (JSON-serialisable)."""
        out: Dict[str, Any] = {}
        if now is not None:
            out["t_modeled_s"] = float(now)
        for name, m in sorted(self._metrics.items()):
            if m.kind == "histogram":
                out[name] = {
                    _fmt_labels(k) or "_": {
                        "count": st[1], "sum": st[2],
                        "buckets": dict(zip(
                            [str(b) for b in m.buckets] + ["+Inf"],
                            st[0]))}
                    for k, st in sorted(m.series.items())}
            else:
                out[name] = {_fmt_labels(k) or "_": v
                             for k, v in sorted(m.series.items())}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if m.kind == "histogram":
                for k, st in sorted(m.series.items()):
                    cum = 0
                    for ub, n in zip(m.buckets, st[0]):
                        cum += n
                        le = _fmt_labels(k + (("le", repr(ub)),))
                        lines.append(f"{name}_bucket{le} {cum}")
                    cum += st[0][-1]
                    le = _fmt_labels(k + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{le} {cum}")
                    lines.append(f"{name}_sum{_fmt_labels(k)} {st[2]}")
                    lines.append(f"{name}_count{_fmt_labels(k)} {st[1]}")
            else:
                for k, v in sorted(m.series.items()):
                    lines.append(f"{name}{_fmt_labels(k)} {v}")
        return "\n".join(lines) + "\n"

    def export_prometheus(self, path) -> str:
        with open(path, "w") as f:
            f.write(self.to_prometheus())
        return str(path)


class PeriodicSnapshotter:
    """Append a registry snapshot every ``interval_s`` of modeled time.

    Drive with ``tick(now)`` from the serving loop; emits all snapshots
    due since the last tick (at most one per interval boundary — long
    idle jumps produce one snapshot, not thousands; the coalesced
    boundaries are counted in ``dropped`` and the
    ``obs_snapshot_dropped_total`` counter so the loss is never silent).
    ``close()`` writes a final snapshot so short runs still produce
    output.
    """

    def __init__(self, registry: MetricsRegistry, path,
                 interval_s: float = 1.0):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.registry = registry
        self.path = str(path)
        self.interval_s = float(interval_s)
        self._next_due: Optional[float] = None
        self.snapshots = 0
        self.dropped = 0
        self._drop_counter = registry.counter(
            "obs_snapshot_dropped_total",
            "snapshot interval boundaries coalesced by idle jumps")
        self._f = open(self.path, "w")

    def tick(self, now: float):
        if self._next_due is None:
            self._next_due = now + self.interval_s
            return
        if now >= self._next_due:
            missed = int((now - self._next_due) // self.interval_s)
            if missed:
                self.dropped += missed
                self._drop_counter.inc(missed)
            self._write(now)
            self._next_due = now + self.interval_s

    def _write(self, now: float):
        json.dump(self.registry.snapshot(now), self._f)
        self._f.write("\n")
        self.snapshots += 1

    def close(self, now: Optional[float] = None):
        if self._f.closed:
            return
        self._write(now if now is not None else (self._next_due or 0.0))
        self._f.close()
