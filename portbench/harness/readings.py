"""What the metric readers (``metrics/<name>.py``) share: a run's
records, and the sums they take over them."""
from __future__ import annotations

import statistics
from typing import Callable, Optional, Sequence

from portbench.cost import peaks as PK

#: names of the device operations of each kernel the timed path launches
KERNELS = {
    "qmatmul": ("qmm_", "sum_splits", "sum_tiers"),
    "flash_decode": ("flash_decode",),
    "flash_attention": ("prefill_attention",),
}


class Run:
    """A finished run as the readers see it: ``kind`` ("decode" or
    "prefill"), ``cfg``, ``traffic``, ``items`` (a dict a step or request:
    "start", "issued", "done" on the host's clock, "rows", "pos" or
    "tokens", "phase"), ``seconds`` (the window's length), ``trace`` (a
    ``harness.trace.Trace`` or None), ``setup_s``, ``peaks``."""

    def __init__(self, kind, cfg, traffic, window, trace, setup_s, peaks):
        self.kind, self.cfg, self.traffic = kind, cfg, traffic
        self.items, self.seconds = window.items, window.seconds
        self.trace, self.setup_s, self.peaks = trace, setup_s, peaks

    def clean(self):
        """The items before any profiler session."""
        return [it for it in self.items if it["phase"] == "clean"]

    def traced(self):
        """The items of the device session."""
        return [it for it in self.items if it["phase"] == "device"]


def p95(values: Sequence[float]) -> float:
    """The 95th percentile (``statistics.quantiles``' exclusive method)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=100)[94]


def share_of_roofline(run: Run, kernel: str,
                      cost: Callable[[dict], tuple]) -> Optional[float]:
    """Percent: the roofline time of the traced items' calls of ``kernel``
    (``cost(item)`` gives one layer's call's (flops, bytes)) over the
    device time of its operations in the trace."""
    items = run.traced()
    if run.trace is None or not items:
        return None
    dev_s, n = run.trace.kernel_time(*KERNELS[kernel])
    if not n:
        return None
    bound = sum(PK.roofline_s(*cost(it), run.peaks) for it in items)
    return 100.0 * run.cfg["layers"] * bound / dev_s


def step_share(run: Run, cost: Callable[[dict], tuple]) -> Optional[float]:
    """Percent: the clean items' whole-step roofline time over their wall
    time on the host's clock."""
    items = run.clean()
    if not items:
        return None
    bound = sum(PK.roofline_s(*cost(it), run.peaks) for it in items)
    return 100.0 * bound / sum(it["done"] - it["start"] for it in items)


def idle_share(run: Run) -> Optional[float]:
    """Percent of the traced stretch with no operation on the device."""
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
