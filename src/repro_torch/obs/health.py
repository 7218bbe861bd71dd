"""Health / alert-rule engine over modeled-clock metric snapshots.

An :class:`AlertRule` names a metric in a
:class:`~repro_torch.obs.metrics.MetricsRegistry`, an extraction ``mode`` and
a threshold; the :class:`HealthMonitor` evaluates every rule whenever
the scheduler ticks it (on the **modeled** clock — alerts carry modeled
timestamps, so a replayed run alerts identically) and records
**transitions**: one ``firing`` alert when a rule's condition becomes
true (after holding ``for_s`` seconds) and one ``resolved`` alert when
it clears. Alerts land in ``monitor.alerts`` (exported as
``alerts.jsonl``) and as ``health`` trace instants, so
``scripts/perf_report.py`` can rebuild the alert history from the trace
file alone.

Extraction modes:

* ``value`` — sum of the metric's series (counter or gauge);
* ``rate``  — increase of that sum over the trailing ``window_s``
  modeled seconds, per second;
* ``p95`` (or any ``p<NN>``) — histogram quantile estimated from the
  merged bucket counts with linear interpolation;
* ``ratio`` — ``value(metric) / value(denominator)`` (skipped while the
  denominator is zero).

Rule files are JSON: ``{"rules": [{"name": ..., "metric": ...,
"mode": "value", "op": ">", "threshold": 1.0, ...}]}`` — see
:func:`load_rules` / :meth:`AlertRule.to_dict` for the full field list
and ``docs/OBSERVABILITY.md`` for the schema.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


@dataclasses.dataclass
class AlertRule:
    """One health condition over one registry metric."""
    name: str
    metric: str
    op: str = ">"
    threshold: float = 0.0
    mode: str = "value"              # value | rate | ratio | p<NN>
    window_s: float = 5.0            # rate mode: trailing window
    denominator: Optional[str] = None  # ratio mode
    for_s: float = 0.0               # must hold this long before firing
    severity: str = "warning"
    description: str = ""

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")
        if self.mode not in ("value", "rate", "ratio") and not (
                self.mode.startswith("p") and self.mode[1:].isdigit()):
            raise ValueError(
                f"rule {self.name!r}: unknown mode {self.mode!r}")
        if self.mode == "ratio" and not self.denominator:
            raise ValueError(
                f"rule {self.name!r}: ratio mode needs a denominator")

    @classmethod
    def from_dict(cls, d: dict) -> "AlertRule":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(
                f"alert rule {d.get('name', '?')!r}: unknown fields "
                f"{sorted(extra)}")
        return cls(**d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_rules(path: str) -> List[AlertRule]:
    """Load ``{"rules": [...]}`` (or a bare list) from a JSON file."""
    with open(path) as f:
        doc = json.load(f)
    rules = doc["rules"] if isinstance(doc, dict) else doc
    return [AlertRule.from_dict(r) for r in rules]


def default_rules() -> List[AlertRule]:
    """The built-in serving health policy (docs/OBSERVABILITY.md)."""
    return [
        AlertRule("slo_burn", "serving_slo_violations_total",
                  mode="ratio",
                  denominator="serving_requests_finished_total",
                  op=">", threshold=0.25, severity="critical",
                  description="more than 25% of finished requests "
                              "missed their SLO"),
        AlertRule("ttft_p95_high", "serving_ttft_seconds", mode="p95",
                  op=">", threshold=2.0,
                  description="p95 time-to-first-token above 2 modeled "
                              "seconds"),
        AlertRule("ssd_quarantine", "kv_ssd_quarantined", mode="value",
                  op=">=", threshold=1.0, severity="critical",
                  description="SSD circuit breaker tripped: flash tier "
                              "quarantined into DRAM-only paging"),
        AlertRule("recovery_rate", "serving_faults_recoveries_total",
                  mode="rate", window_s=5.0, op=">", threshold=0.0,
                  description="requests are being re-prefilled after "
                              "lost KV blocks"),
        AlertRule("failure_rate", "serving_faults_failed_requests_total",
                  mode="rate", window_s=5.0, op=">", threshold=0.0,
                  severity="critical",
                  description="requests are failing past max_recoveries"),
        AlertRule("dram_overcommit", "kv_dram_overcommit_bytes",
                  mode="value", op=">", threshold=0.0,
                  description="DRAM KV tier paging beyond its budget "
                              "(quarantine over-commit)"),
        AlertRule("prefix_hit_collapse", "serving_prefix_hit_rate",
                  mode="value", op="<", threshold=0.05, for_s=2.0,
                  description="radix prefix cache stopped hitting"),
        AlertRule("trace_ring_drops", "obs_trace_dropped_events_total",
                  mode="value", op=">", threshold=0.0,
                  description="trace ring buffer overflowed: the "
                              "exported trace is truncated"),
        AlertRule("snapshot_drops", "obs_snapshot_dropped_total",
                  mode="value", op=">", threshold=0.0,
                  description="metric snapshot boundaries skipped "
                              "(idle jumps coalesced snapshots)"),
    ]


class _RuleState:
    __slots__ = ("pending_since", "firing", "history")

    def __init__(self):
        self.pending_since: Optional[float] = None
        self.firing = False
        self.history: List[tuple] = []   # (t, value) for rate mode


class HealthMonitor:
    """Evaluates alert rules against a live registry on the modeled
    clock; purely passive (never advances any clock, never raises on a
    missing metric — a metric that does not exist yet just skips its
    rule this tick)."""

    def __init__(self, registry, rules: Optional[List[AlertRule]] = None,
                 *, trace=None):
        self.registry = registry
        self.rules = list(rules) if rules is not None else default_rules()
        self.trace = trace
        self._trace_t0 = 0.0
        self.alerts: List[dict] = []
        self._state = {r.name: _RuleState() for r in self.rules}

    def attach_trace(self, recorder, *, t0: float = 0.0):
        """Emit a ``health`` instant per alert into ``recorder``.
        Evaluation times are run-relative; ``t0`` is the raw-clock run
        origin so the instants line up with every other track."""
        self.trace = recorder
        self._trace_t0 = float(t0)

    # -- value extraction ---------------------------------------------
    def _metric_sum(self, name: str) -> Optional[float]:
        m = self.registry.get(name)
        if m is None or m.kind == "histogram":
            return None
        if not m.series:
            # an empty counter is meaningfully zero (rate rules need the
            # baseline); a never-set gauge is unknown — one the scheduler
            # only drives when its subsystem is on (e.g. the prefix hit
            # rate) must not read as a false zero
            return 0.0 if m.kind == "counter" else None
        return sum(m.series.values())

    def _quantile(self, name: str, q: float) -> Optional[float]:
        m = self.registry.get(name)
        if m is None or m.kind != "histogram":
            return None
        merged = [0] * (len(m.buckets) + 1)
        count = 0
        for st in m.series.values():
            for i, c in enumerate(st[0]):
                merged[i] += c
            count += st[1]
        if count == 0:
            return None
        target = q * count
        cum = 0
        lo = 0.0
        for i, ub in enumerate(m.buckets):
            prev = cum
            cum += merged[i]
            if cum >= target:
                # linear interpolation inside the bucket
                frac = (target - prev) / merged[i] if merged[i] else 0.0
                return lo + (ub - lo) * frac
            lo = ub
        return float("inf") if merged[-1] else lo

    def _rule_value(self, rule: AlertRule, now: float) -> Optional[float]:
        if rule.mode == "value":
            return self._metric_sum(rule.metric)
        if rule.mode == "ratio":
            num = self._metric_sum(rule.metric)
            den = self._metric_sum(rule.denominator)
            if num is None or not den:
                return None
            return num / den
        if rule.mode == "rate":
            v = self._metric_sum(rule.metric)
            if v is None:
                return None
            hist = self._state[rule.name].history
            hist.append((now, v))
            while len(hist) > 1 and hist[0][0] < now - rule.window_s:
                hist.pop(0)
            t0, v0 = hist[0]
            if now <= t0:
                return None
            return (v - v0) / (now - t0)
        # p<NN> quantile
        return self._quantile(rule.metric, int(rule.mode[1:]) / 100.0)

    # -- evaluation ----------------------------------------------------
    def evaluate(self, now: float) -> List[dict]:
        """Tick every rule; returns the alerts newly recorded."""
        new: List[dict] = []
        for rule in self.rules:
            st = self._state[rule.name]
            value = self._rule_value(rule, now)
            if value is None:
                continue
            cond = _OPS[rule.op](value, rule.threshold)
            if cond and not st.firing:
                if st.pending_since is None:
                    st.pending_since = now
                if now - st.pending_since >= rule.for_s:
                    st.firing = True
                    new.append(self._record(rule, now, value, "firing"))
            elif not cond:
                st.pending_since = None
                if st.firing:
                    st.firing = False
                    new.append(self._record(rule, now, value, "resolved"))
        return new

    def _record(self, rule: AlertRule, now: float, value: float,
                state: str) -> dict:
        alert = {"t": now, "rule": rule.name, "state": state,
                 "severity": rule.severity, "metric": rule.metric,
                 "mode": rule.mode, "op": rule.op, "value": value,
                 "threshold": rule.threshold,
                 "description": rule.description}
        self.alerts.append(alert)
        if self.trace is not None:
            self.trace.instant("health", rule.name, t=self._trace_t0 + now,
                               state=state, severity=rule.severity,
                               value=float(value),
                               threshold=rule.threshold)
        return alert

    # -- queries / export ---------------------------------------------
    def active(self) -> List[str]:
        return sorted(n for n, st in self._state.items() if st.firing)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {"firing": 0, "resolved": 0}
        for a in self.alerts:
            out[a["state"]] = out.get(a["state"], 0) + 1
            key = f"{a['state']}:{a['rule']}"
            out[key] = out.get(key, 0) + 1
        return out

    def fired(self, rule_name: str) -> bool:
        return any(a["rule"] == rule_name and a["state"] == "firing"
                   for a in self.alerts)

    def close(self, now: float) -> None:
        """Final evaluation tick (end of run)."""
        self.evaluate(now)

    def export_jsonl(self, path: str) -> int:
        """Write one JSON object per alert; returns the alert count."""
        with open(path, "w") as f:
            for a in self.alerts:
                json.dump(a, f, sort_keys=True)
                f.write("\n")
        return len(self.alerts)


def alerts_from_events(events) -> List[dict]:
    """Rebuild the alert history from normalized trace events (the
    ``health`` instants) — the perf_report path when no alerts.jsonl is
    at hand."""
    out = []
    for ev in events:
        if ev["kind"] == "instant" and ev["track"] == "health":
            a = {"t": ev["t"], "rule": ev["name"]}
            a.update(ev["args"])
            out.append(a)
    return out
