"""Observability layer (``repro/obs``): tracing, metrics, block traces, attribution.

``TraceRecorder`` (``obs/trace.py``) records spans / instants /
counters on the modeled clock with Chrome ``trace_event`` export;
``MetricsRegistry`` (``obs/metrics.py``) holds counters / gauges /
histograms with JSON snapshots and a Prometheus-text exporter;
``BlockTraceCollector`` (``obs/block_trace.py``) captures every KV
block tier transition in the replay format the replacement-policy lab
consumes; ``TimeLedger`` (``obs/ledger.py``) attributes every modeled
second and gCO2 gram into exclusive categories under a conservation
invariant; the span profiler (``obs/profile.py``) rolls traces into
self/total flamegraph trees; ``HealthMonitor`` (``obs/health.py``)
evaluates alert rules on modeled-clock metric snapshots. All of it is
opt-in and free on the modeled clock — see ``docs/OBSERVABILITY.md``.
"""
from repro_torch.obs.block_trace import (BlockAccessEvent,
                                         BlockTraceCollector,
                                         read_block_trace)
from repro_torch.obs.health import (AlertRule, HealthMonitor,
                                    alerts_from_events, default_rules,
                                    load_rules)
from repro_torch.obs.ledger import TimeLedger, reconstruct
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, PeriodicSnapshotter)
from repro_torch.obs.profile import (build_tree, collapsed_stacks,
                                     dispatch_groups, events_from_chrome,
                                     events_from_recorder, hottest_requests,
                                     profile_summary, write_collapsed)
from repro_torch.obs.trace import TraceEvent, TraceRecorder

__all__ = [
    "AlertRule", "BlockAccessEvent", "BlockTraceCollector", "Counter",
    "Gauge", "HealthMonitor", "Histogram", "MetricsRegistry",
    "PeriodicSnapshotter", "TimeLedger", "TraceEvent", "TraceRecorder",
    "alerts_from_events", "build_tree", "collapsed_stacks",
    "default_rules", "dispatch_groups", "events_from_chrome",
    "events_from_recorder", "hottest_requests", "load_rules",
    "profile_summary", "read_block_trace", "reconstruct",
    "write_collapsed",
]
