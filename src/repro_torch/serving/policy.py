"""Pluggable scheduling policies for the continuous-batch scheduler.

A :class:`SchedulingPolicy` answers three questions each scheduler
iteration, all on the modeled clock (seconds, rebased to the run origin):

* ``admission_order(waiting, now)`` — in what order should waiting
  (queued or preempted) requests be considered for admission?
* ``may_start(req, now)`` — may this request start (or resume) *now*, or
  should it be held back? Policies that hold work also implement
  ``holdoff_until`` so the scheduler can advance an idle clock to the
  moment the answer may change instead of spinning.
* ``victim_order(active)`` — under KV memory pressure, in what order
  should active requests be preempted? (first element = first victim)

Three policies:

* :class:`FCFSPolicy` — PR-1 behaviour: arrival order, LIFO preemption,
  preempted requests resume before new work starts.
* :class:`SLOAwarePolicy` — earliest-deadline-first over each request's
  TTFT deadline (``arrival + slo.ttft_s``); preempts the request with the
  most completion-deadline slack first. Requests without an SLO sort
  after all SLO-carrying traffic (GreenLLM-style best-effort tier).
* :class:`CarbonAwarePolicy` — EDF ordering, plus an admission gate fed
  by a :class:`~repro_torch.core.carbon.CarbonIntensityTrace`: *deferrable*
  requests (``slo.deferrable``, e.g. the batch class) wait for a grid
  window at or below ``threshold_g_kwh`` — but never past the point
  where their completion deadline would become unreachable (EcoServe's
  carbon-aware admission with an SLO guardrail).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.carbon import CarbonIntensityTrace
from repro_torch.serving.request import RequestState, ServingRequest


class SchedulingPolicy:
    """Interface + FCFS-neutral defaults. Subclass and override."""

    name = "base"

    def admission_order(self, waiting: List[ServingRequest],
                        now: float) -> List[ServingRequest]:
        """Waiting requests in the order admission should consider them."""
        return list(waiting)

    def may_start(self, req: ServingRequest, now: float) -> bool:
        """Gate: may ``req`` start/resume at modeled time ``now``?"""
        return True

    def holdoff_until(self, req: ServingRequest,
                      now: float) -> Optional[float]:
        """When an idle scheduler should re-ask ``may_start`` for a held
        request. None means 'not holding it'."""
        return None

    def victim_order(self,
                     active: List[ServingRequest]) -> List[ServingRequest]:
        """Preemption order under KV pressure (first = first victim)."""
        return list(reversed(active))            # LIFO: youngest first


class FCFSPolicy(SchedulingPolicy):
    """Arrival order; preempted requests resume before new admissions."""

    name = "fcfs"

    def admission_order(self, waiting, now):
        return sorted(waiting, key=lambda r: (
            r.state is not RequestState.PREEMPTED, r.arrival_s, r.rid))


def _edf_key(r: ServingRequest):
    """TTFT deadline; SLO-less requests sort last, FIFO among themselves."""
    d = r.ttft_deadline_s
    return (d is None, d if d is not None else r.arrival_s, r.rid)


class SLOAwarePolicy(SchedulingPolicy):
    """Earliest-deadline-first admission + max-slack-first preemption."""

    name = "slo"

    def admission_order(self, waiting, now):
        return sorted(waiting, key=_edf_key)

    def victim_order(self, active):
        # preempt the request that can best afford it: largest remaining
        # completion-deadline slack first; SLO-less before any SLO class
        def slack(r: ServingRequest):
            d = r.deadline_s
            return (0, 0.0, -r.rid) if d is None else (1, -d, -r.rid)
        return sorted(active, key=slack)


class CarbonAwarePolicy(SLOAwarePolicy):
    """EDF plus carbon-gated admission of deferrable work.

    ``threshold_g_kwh`` — grid intensity at or below which deferrable
    requests may start. ``slack_margin_s`` — modeled seconds of headroom
    kept between the forced-start time and the completion deadline (a
    rough bound on prefill + decode service time, so deferral never turns
    into an SLO violation by itself).
    """

    name = "carbon"

    def __init__(self, trace: CarbonIntensityTrace, *,
                 threshold_g_kwh: float = 300.0,
                 slack_margin_s: float = 60.0):
        self.trace = trace
        self.threshold = threshold_g_kwh
        self.slack_margin_s = slack_margin_s

    def _forced_start(self, req: ServingRequest) -> float:
        """Latest start that still leaves ``slack_margin_s`` before the
        completion deadline."""
        return req.deadline_s - self.slack_margin_s

    def _deferrable(self, req: ServingRequest) -> bool:
        # once prefill started, finishing it is cheaper than holding KV
        return (req.slo is not None and req.slo.deferrable
                and req.prompt_done == 0)

    def may_start(self, req, now):
        if not self._deferrable(req):
            return True
        if now >= self._forced_start(req):
            return True                          # out of slack: run now
        if self.trace.intensity_at(now) <= self.threshold:
            return True                          # already clean: go
        # dirty now — hold only if a clean window exists before the
        # forced start; a grid that never improves is no reason to wait
        return self.trace.next_window_below(
            now, self.threshold,
            horizon_s=self._forced_start(req) - now) is None

    def holdoff_until(self, req, now):
        if self.may_start(req, now):
            return None
        window = self.trace.next_window_below(
            now, self.threshold, horizon_s=self._forced_start(req) - now)
        forced = self._forced_start(req)
        return min(window, forced) if window is not None else forced


def make_policy(name: str, *, trace: Optional[CarbonIntensityTrace] = None,
                threshold_g_kwh: float = 300.0) -> SchedulingPolicy:
    """CLI/benchmark factory: ``fcfs`` | ``slo`` | ``carbon``."""
    if name == "fcfs":
        return FCFSPolicy()
    if name == "slo":
        return SLOAwarePolicy()
    if name == "carbon":
        return CarbonAwarePolicy(trace or CarbonIntensityTrace.constant(),
                                 threshold_g_kwh=threshold_g_kwh)
    raise ValueError(f"unknown policy {name!r}")
