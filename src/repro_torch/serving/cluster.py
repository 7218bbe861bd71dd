"""Fleet-scale serving: replicas + a prefix-aware cluster router.

Everything below this module is one scheduler on one modeled device; the
paper's sustainability pitch — serving LLMs on fleets of old,
carbon-cheap GPUs — only pays off at cluster scale. This module adds the
two abstractions that unlock it (docs/CLUSTER.md):

* :class:`Replica` — one complete serving instance: an
  :class:`~repro_torch.core.engine.M2CacheEngine`, a
  :class:`~repro_torch.serving.scheduler.ContinuousBatchScheduler`, a tiered
  KV cache, a radix prefix tree and a per-run
  :class:`~repro_torch.core.carbon.CarbonAccountant`, all instance state (no
  module-level globals — two replicas never share a clock, a cache or a
  tree). Replicas may be heterogeneous: each carries its own
  ``device_name`` (the carbon/TDP model) and its own — possibly
  phase-shifted — :class:`~repro_torch.core.carbon.CarbonIntensityTrace`
  modeling the grid region it runs in.

* :class:`ClusterRouter` — the front end. Routing is **two-phase**: all
  arrivals are routed in time order first (phase 1), then each
  replica's scheduler serves its assigned sub-trace serially (phase 2).
  Each replica run is therefore *literally* a single-replica serial run
  of its events — per-replica token streams are byte-identical to
  running the same sub-trace on one replica alone, by construction
  (regression-tested). Placement is **prefix-aware**: the router keeps a
  :class:`ShadowRadixIndex` per replica — a block-granular token-prefix
  trie mirroring what that replica's radix tree will hold — and routes
  same-prefix requests to the replica that already owns their blocks,
  turning N per-replica prefix caches into one cluster-wide asset.
  Balancing policies (``ROUTER_POLICIES``): ``round-robin``,
  ``least-loaded`` (trailing-window assigned-token estimate),
  ``prefix`` (affinity first, least-loaded fallback) and ``carbon``
  (affinity first, then — within a load-imbalance bound — the replica
  whose grid slice is cleanest *right now*). A
  :class:`CarbonAutoscaler` drains/parks replicas against a diurnal
  intensity trace: a drained replica receives no new assignments, its
  in-flight work finishes, and its parked window bills deep-idle power
  through the horizon like any idle single-replica server.

Observability: pass one shared :class:`~repro_torch.obs.TraceRecorder`; each
replica's events land on ``<name>:``-prefixed tracks via
:class:`ReplicaTraceView` (safe because replicas run serially) and the
router emits a decision instant per request on the ``router`` track at
the event's cluster-origin arrival time.

What this does *not* model — inter-replica network KV transfer, router
queueing, cross-replica interference — is written down in
docs/LIMITATIONS.md.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Sequence

from repro_torch.core import carbon as carbon_mod
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                     ServingReport)
from repro_torch.serving.schema import validate_cluster_summary
from repro_torch.serving.workload import ArrivalEvent, requests_from_trace

#: pluggable balancing policies of :class:`ClusterRouter`
ROUTER_POLICIES = ("round-robin", "least-loaded", "prefix", "carbon")


def shifted_trace(trace: carbon_mod.CarbonIntensityTrace,
                  shift_s: float) -> carbon_mod.CarbonIntensityTrace:
    """Phase-shift a periodic grid-intensity trace by ``shift_s``
    seconds: the returned trace at time ``t`` reads the base trace at
    ``t + shift_s``. This is how a cluster models replicas in different
    grid regions — same diurnal shape, offset solar peaks — which is
    exactly the asymmetry the ``carbon`` router policy exploits."""
    if not shift_s:
        return trace
    if not trace.period_s:
        raise ValueError("shifted_trace needs a periodic trace "
                         "(period_s set)")
    period = trace.period_s
    s = shift_s % period
    pts = sorted({round((bp - s) % period, 9)
                  for bp in trace.times} | {0.0})
    values = [trace.intensity_at(t + s) for t in pts]
    return carbon_mod.CarbonIntensityTrace(pts, values, period_s=period)


class ShadowRadixIndex:
    """The router's block-granular approximation of one replica's radix
    tree.

    At routing time the replica has not run yet (two-phase simulation) —
    and in a real cluster the router would not see the worker's tree
    synchronously either — so the router maintains its own token-prefix
    trie per replica, updated at *assignment* time with the blocks the
    routed prompt will donate. Like the real
    :class:`~repro_torch.serving.prefix_cache.PrefixCache` it works in whole
    ``block_tokens`` units and can match at most one block short of the
    prompt length (the last token's KV is never servable from cache).
    It is an optimistic shadow: capacity evictions and failed inserts on
    the replica are not mirrored, so a shadow hit is an upper bound on
    the replica's real hit — mis-estimates cost modeled prefill time,
    never correctness."""

    def __init__(self, block_tokens: int = 16):
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        self.block_tokens = int(block_tokens)
        self._root: Dict[tuple, dict] = {}
        self.blocks = 0                 # distinct blocks indexed

    def _block_path(self, tokens: Sequence[int]) -> List[tuple]:
        bt = self.block_tokens
        usable = (len(tokens) - 1) // bt if len(tokens) else 0
        return [tuple(int(t) for t in tokens[i * bt:(i + 1) * bt])
                for i in range(usable)]

    def insert(self, tokens: Sequence[int]) -> int:
        """Index the prompt's full blocks; returns newly-added blocks."""
        node, added = self._root, 0
        for blk in self._block_path(tokens):
            child = node.get(blk)
            if child is None:
                child = node[blk] = {}
                added += 1
            node = child
        self.blocks += added
        return added

    def match_tokens(self, tokens: Sequence[int]) -> int:
        """Longest indexed prefix of ``tokens``, in tokens (block-
        granular, like the real tree's hit_tokens)."""
        node, hit = self._root, 0
        for blk in self._block_path(tokens):
            child = node.get(blk)
            if child is None:
                break
            hit += len(blk)
            node = child
        return hit


class ReplicaTraceView:
    """Per-replica view of a shared :class:`~repro_torch.obs.TraceRecorder`.

    Every scheduler wants to own the recorder (``set_default_clock`` in
    its constructor) and emits on generic tracks (``sched``, ``kv``,
    ``carbon``); with N replicas sharing one recorder their events
    would interleave indistinguishably and the last replica's clock
    would win. This proxy keeps the *per-replica* default clock local
    and prefixes every track with ``<replica>:`` so one trace file
    carries N cleanly-separated timelines. Correct because replicas run
    serially (two-phase simulation): no concurrent emission ever
    races on the shared ring."""

    def __init__(self, recorder, name: str):
        self._rec = recorder
        self._name = str(name)
        self._clock = None

    def set_default_clock(self, clock):
        self._clock = clock

    def _t(self, t: Optional[float]) -> float:
        if t is not None:
            return float(t)
        return float(self._clock()) if self._clock is not None else 0.0

    def _track(self, track: str) -> str:
        return f"{self._name}:{track}"

    def span_begin(self, track, name, t=None, **args) -> int:
        return self._rec.span_begin(self._track(track), name,
                                    t=self._t(t), **args)

    def span_end(self, sid, t=None, **args):
        return self._rec.span_end(sid, t=self._t(t), **args)

    def span(self, track, name, t0, t1, **args):
        return self._rec.span(self._track(track), name, t0, t1, **args)

    def instant(self, track, name, t=None, **args):
        return self._rec.instant(self._track(track), name,
                                 t=self._t(t), **args)

    def counter(self, track, name, t=None, **values):
        return self._rec.counter(self._track(track), name,
                                 t=self._t(t), **values)

    @property
    def dropped_events(self) -> int:
        return self._rec.dropped_events

    def __getattr__(self, item):
        # stats(), total_events, export_chrome, ... — the shared ring's
        return getattr(self._rec, item)


class Replica:
    """One serving instance: engine + scheduler + tiered cache + radix
    tree + carbon accounting, with no module-level state.

    ``engine`` must be a dedicated :class:`M2CacheEngine` (its modeled
    clock, cache hierarchy and SSD directory are all per-instance, so
    replicas are fully isolated). ``carbon_trace`` is this replica's
    grid region (see :func:`shifted_trace`); it feeds both the
    scheduler's accountant and the router's ``carbon`` policy.
    ``trace`` is the *shared* cluster recorder — it is wrapped in a
    :class:`ReplicaTraceView` here. Remaining keyword arguments go to
    :class:`ContinuousBatchScheduler`; ``prefix_caching`` defaults on
    (prefix-aware routing is pointless without the tree)."""

    def __init__(self, name: str, engine, *,
                 carbon_trace: Optional[
                     carbon_mod.CarbonIntensityTrace] = None,
                 trace=None, **scheduler_kwargs):
        self.name = str(name)
        self.engine = engine
        self.carbon_trace = carbon_trace \
            or carbon_mod.CarbonIntensityTrace.constant()
        self.trace_view = ReplicaTraceView(trace, self.name) \
            if trace is not None else None
        scheduler_kwargs.setdefault("prefix_caching", True)
        self.scheduler = ContinuousBatchScheduler(
            engine, carbon_trace=self.carbon_trace,
            trace=self.trace_view, **scheduler_kwargs)
        self.events: List[ArrivalEvent] = []
        self.report: Optional[ServingReport] = None
        # drain/park windows: [t0, t1]; t1 is None while still drained
        self.drain_windows: List[List[Optional[float]]] = []

    @property
    def device_name(self) -> str:
        return self.engine.device_name

    # -- drain / park (autoscaling) ------------------------------------
    @property
    def drained(self) -> bool:
        return bool(self.drain_windows) \
            and self.drain_windows[-1][1] is None

    def drain(self, t: float):
        """Stop accepting new assignments from ``t`` on (in-flight work
        finishes; the parked window bills deep-idle power)."""
        if not self.drained:
            self.drain_windows.append([float(t), None])

    def undrain(self, t: float):
        if self.drained:
            self.drain_windows[-1][1] = float(t)

    def drained_at(self, t: float) -> bool:
        return any(t0 <= t and (t1 is None or t < t1)
                   for t0, t1 in self.drain_windows)

    # -- assignment + execution ----------------------------------------
    def assign(self, event: ArrivalEvent):
        self.events.append(event)

    def assigned_tokens(self) -> int:
        return sum(e.prompt_len + e.max_new_tokens for e in self.events)

    def run(self, *, vocab_size: Optional[int] = None,
            horizon_s: Optional[float] = None,
            seed: int = 0) -> ServingReport:
        """Serve this replica's assigned sub-trace to completion —
        exactly a serial single-replica run of those events."""
        events = sorted(self.events, key=lambda e: e.arrival_s)
        reqs = requests_from_trace(events, vocab_size=vocab_size,
                                   seed=seed)
        self.report = self.scheduler.run(reqs, horizon_s=horizon_s)
        return self.report

    def tokens(self) -> Dict[int, list]:
        """rid -> generated token stream (entries are None on analytic
        engines, which carry no real logits)."""
        if self.report is None:
            return {}
        return {r.rid: list(r.session.tokens)
                for r in self.report.requests}


class CarbonAutoscaler:
    """Carbon-driven replica count: the dirtier the grid, the fewer
    replicas stay active (EcoServe's provisioning angle).

    ``target(t, n)`` maps the cluster trace's intensity at ``t`` to an
    active-replica count: everything at/below ``clean_g_kwh`` keeps all
    ``n`` active, everything at/above ``dirty_g_kwh`` parks down to
    ``min_replicas``, and the band between interpolates linearly. The
    router consults it at every arrival and drains/undrains the replica
    list's tail, so the "which replicas park" order is deterministic."""

    def __init__(self, trace: carbon_mod.CarbonIntensityTrace, *,
                 min_replicas: int = 1, clean_g_kwh: float = 250.0,
                 dirty_g_kwh: float = 600.0):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if dirty_g_kwh <= clean_g_kwh:
            raise ValueError("dirty_g_kwh must exceed clean_g_kwh")
        self.trace = trace
        self.min_replicas = int(min_replicas)
        self.clean_g_kwh = float(clean_g_kwh)
        self.dirty_g_kwh = float(dirty_g_kwh)

    def target(self, t: float, n_replicas: int) -> int:
        g = self.trace.intensity_at(t)
        if g >= self.dirty_g_kwh:
            k = self.min_replicas
        elif g <= self.clean_g_kwh:
            k = n_replicas
        else:
            frac = (self.dirty_g_kwh - g) \
                / (self.dirty_g_kwh - self.clean_g_kwh)
            k = max(self.min_replicas,
                    int(math.ceil(frac * n_replicas)))
        return min(max(k, 1), n_replicas)


class _LoadEstimate:
    """Trailing-window assigned-token load: the router's deterministic
    stand-in for queue depth (replica runs happen after routing, so
    real queue state does not exist yet — mirrors a real router's
    delayed view of worker load)."""

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self._ev: deque = deque()       # (t, tokens)
        self._sum = 0.0

    def add(self, t: float, tokens: int):
        self._ev.append((float(t), float(tokens)))
        self._sum += float(tokens)

    def at(self, t: float) -> float:
        while self._ev and self._ev[0][0] < t - self.window_s:
            _, tok = self._ev.popleft()
            self._sum -= tok
        return self._sum


@dataclasses.dataclass
class ClusterReport:
    """Cluster-level rollup: the per-replica :class:`ServingReport`\\ s
    plus the router's decision and drain records. ``summary()`` is
    schema-validated (``CLUSTER_SUMMARY_REQUIRED`` in
    ``serving/schema.py``) and every aggregate is a plain sum/max over
    the per-replica reports — regression tests hold the two views to
    each other."""
    router: str
    reports: Dict[str, ServingReport]
    decisions: Dict[str, int]
    drains: Dict[str, List[List[Optional[float]]]]
    horizon_s: Optional[float] = None

    def tokens(self) -> Dict[int, list]:
        out: Dict[int, list] = {}
        for rep in self.reports.values():
            for r in rep.requests:
                out[r.rid] = list(r.session.tokens)
        return out

    def slo_summary(self) -> Dict[str, float]:
        """Cluster-wide SLO attainment over every finished request that
        carries an SLO (same semantics as the per-replica one)."""
        with_slo = [r for rep in self.reports.values()
                    for r in rep.requests if r.slo is not None]
        if not with_slo:
            return {}
        n = len(with_slo)
        return {
            "slo_requests": n,
            "slo_attainment":
                sum(bool(r.slo_met()) for r in with_slo) / n,
            "ttft_attainment":
                sum(r.ttft_s <= r.slo.ttft_s for r in with_slo) / n,
            "tpot_attainment":
                sum(r.tpot_s <= r.slo.tpot_s for r in with_slo) / n,
            "deadline_attainment":
                sum(r.latency_s <= r.slo.deadline_s
                    for r in with_slo) / n,
        }

    def summary(self) -> Dict[str, float]:
        reps = list(self.reports.values())
        requests = sum(len(r.requests) for r in reps)
        total_tokens = sum(r.total_tokens for r in reps)
        # replicas simulate independently on parallel modeled clocks
        # over the same arrival timeline, so the cluster span is the
        # slowest replica's span, not the sum
        span = max((r.modeled_span_s for r in reps), default=0.0)
        gco2 = sum(r.carbon["total_g"] for r in reps)
        oce = sum(r.carbon["oce_g"] for r in reps)
        kwh = sum(r.carbon["energy_j"] for r in reps) / 3.6e6
        hit_t = sum(r.prefix_stats.get("prefix_hit_tokens", 0)
                    for r in reps)
        lookup_t = sum(r.prefix_stats.get("prefix_lookup_tokens", 0)
                       for r in reps)
        out = {
            "router": self.router,
            "replicas": len(reps),
            "requests": requests,
            "total_tokens": total_tokens,
            "modeled_span_s": span,
            "tokens_per_s": total_tokens / span if span else 0.0,
            "gco2_total": gco2,
            "gco2_per_request": gco2 / max(requests, 1),
            "cluster_prefix_hit_rate": hit_t / max(lookup_t, 1),
            "affinity_routed": self.decisions.get("affinity_routed", 0),
            "balanced_routed": self.decisions.get("balanced", 0),
            "drains": self.decisions.get("drains", 0),
            # energy-weighted across replicas: the gCO2/kWh the
            # cluster's joules actually paid (drops when the router
            # shifts energy onto cleaner grid slices)
            "mean_intensity_g_kwh": oce / kwh if kwh else 0.0,
        }
        failed = sum(len(r.failed) for r in reps)
        if failed:
            out["failed_requests"] = failed
        out.update(self.slo_summary())
        return validate_cluster_summary(out)


class ClusterRouter:
    """Front-end placement over N :class:`Replica`\\ s.

    Two-phase: :meth:`route` walks the arrival events in time order and
    assigns each to a replica (consulting the autoscaler, the shadow
    radix indices and the load estimates at that event's arrival time);
    :meth:`run` then executes every replica's sub-trace serially and
    rolls the reports up into a :class:`ClusterReport`.

    ``policy`` ∈ ``ROUTER_POLICIES``:

    * ``round-robin`` — cycle the replica list (drained skipped). The
      affinity-blind baseline every benchmark compares against.
    * ``least-loaded`` — smallest trailing-window assigned-token load.
    * ``prefix`` — the replica whose shadow index matches at least
      ``min_affinity_tokens`` of the prompt (ties: least loaded);
      least-loaded fallback when nothing matches.
    * ``carbon`` — prefix affinity first; otherwise, among replicas
      within ``imbalance_tokens`` of the lightest load, the one whose
      grid trace is cleanest at the arrival instant.
    """

    def __init__(self, replicas: Sequence[Replica], *,
                 policy: str = "prefix",
                 block_tokens: Optional[int] = None,
                 min_affinity_tokens: Optional[int] = None,
                 load_window_s: float = 60.0,
                 imbalance_tokens: int = 2048,
                 autoscaler: Optional[CarbonAutoscaler] = None,
                 trace=None):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("need at least one replica")
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r} "
                             f"(expected one of {ROUTER_POLICIES})")
        self.policy = policy
        bt = block_tokens or getattr(
            self.replicas[0].scheduler.kv, "block_tokens", 16)
        self.shadow: Dict[str, ShadowRadixIndex] = {
            r.name: ShadowRadixIndex(bt) for r in self.replicas}
        self.min_affinity_tokens = int(min_affinity_tokens) \
            if min_affinity_tokens is not None else bt
        self._load: Dict[str, _LoadEstimate] = {
            r.name: _LoadEstimate(load_window_s) for r in self.replicas}
        self._order = {r.name: i for i, r in enumerate(self.replicas)}
        self.imbalance_tokens = float(imbalance_tokens)
        self.autoscaler = autoscaler
        self.trace = trace
        self._rr = 0
        self.decisions: Dict[str, int] = {
            "events": 0, "affinity_routed": 0, "balanced": 0,
            "drains": 0, "undrains": 0}

    # -- autoscaling ---------------------------------------------------
    def _autoscale(self, t: float):
        if self.autoscaler is None:
            return
        k = self.autoscaler.target(t, len(self.replicas))
        for i, r in enumerate(self.replicas):
            if i < k and r.drained:
                r.undrain(t)
                self.decisions["undrains"] += 1
                if self.trace is not None:
                    self.trace.instant("router", "undrain", t,
                                       replica=r.name, target=k)
            elif i >= k and not r.drained:
                r.drain(t)
                self.decisions["drains"] += 1
                if self.trace is not None:
                    self.trace.instant("router", "drain", t,
                                       replica=r.name, target=k)

    def _active(self) -> List[Replica]:
        return [r for r in self.replicas if not r.drained]

    # -- placement -----------------------------------------------------
    def _balance(self, active: List[Replica], t: float) -> Replica:
        if self.policy == "round-robin":
            for _ in range(len(self.replicas)):
                r = self.replicas[self._rr % len(self.replicas)]
                self._rr += 1
                if not r.drained:
                    return r
            return active[0]
        loads = [(self._load[r.name].at(t), self._order[r.name], r)
                 for r in active]
        if self.policy == "carbon":
            lo = min(l for l, _, _ in loads)
            cands = [(r.carbon_trace.intensity_at(t), l, o, r)
                     for l, o, r in loads
                     if l <= lo + self.imbalance_tokens]
            return min(cands, key=lambda c: (c[0], c[1], c[2]))[3]
        return min(loads, key=lambda c: (c[0], c[1]))[2]

    def route_one(self, event: ArrivalEvent) -> Replica:
        """Assign one arrival (events must be offered in time order)."""
        t = event.arrival_s
        self._autoscale(t)
        active = self._active()
        chosen, hit = None, 0
        toks = event.prompt_tokens
        if self.policy in ("prefix", "carbon") and toks:
            hits = [(self.shadow[r.name].match_tokens(toks), r)
                    for r in active]
            best = max(h for h, _ in hits)
            if best >= self.min_affinity_tokens:
                tied = [r for h, r in hits if h == best]
                chosen = min(tied, key=lambda r: (
                    self._load[r.name].at(t), self._order[r.name]))
                hit = best
        if chosen is None:
            chosen = self._balance(active, t)
        chosen.assign(event)
        self.decisions["events"] += 1
        self.decisions["affinity_routed" if hit else "balanced"] += 1
        self._load[chosen.name].add(
            t, event.prompt_len + event.max_new_tokens)
        if toks:
            self.shadow[chosen.name].insert(toks)
        if self.trace is not None:
            # router-track timestamps are cluster-origin arrival
            # seconds (replica tracks run on their own engine clocks)
            self.trace.instant(
                "router", "route", t, rid=event.rid,
                replica=chosen.name, hit_tokens=hit,
                load=self._load[chosen.name].at(t), policy=self.policy)
        return chosen

    def route(self, events: Sequence[ArrivalEvent]
              ) -> Dict[str, List[ArrivalEvent]]:
        """Phase 1: place every arrival, in time order."""
        for e in sorted(events, key=lambda e: (e.arrival_s, e.rid)):
            self.route_one(e)
        return {r.name: list(r.events) for r in self.replicas}

    def run(self, events: Sequence[ArrivalEvent], *,
            vocab_size: Optional[int] = None,
            horizon_s: Optional[float] = None,
            seed: int = 0) -> ClusterReport:
        """Phase 1 + phase 2: route everything, then serve each
        replica's sub-trace serially. ``horizon_s`` bills every replica
        (parked ones included) out to a common serving window so
        cluster gCO2 totals compare fairly across router policies."""
        self.route(events)
        reports = {r.name: r.run(vocab_size=vocab_size,
                                 horizon_s=horizon_s, seed=seed)
                   for r in self.replicas}
        return ClusterReport(
            router=self.policy, reports=reports,
            decisions=dict(self.decisions),
            drains={r.name: [list(w) for w in r.drain_windows]
                    for r in self.replicas},
            horizon_s=horizon_s)


def make_cluster(n: int, engine_factory, *,
                 policy: str = "prefix",
                 devices: Optional[Sequence[str]] = None,
                 cluster_trace: Optional[
                     carbon_mod.CarbonIntensityTrace] = None,
                 grid_shifts: Optional[Sequence[float]] = None,
                 autoscale: bool = False,
                 autoscaler_kwargs: Optional[dict] = None,
                 trace=None,
                 **scheduler_kwargs) -> ClusterRouter:
    """Convenience constructor: ``n`` replicas named ``r0..r{n-1}``.

    ``engine_factory(i, device_name)`` must return a fresh engine per
    call (``device_name`` is ``devices[i % len(devices)]`` or None).
    ``grid_shifts`` phase-shifts the (periodic) ``cluster_trace`` per
    replica; ``autoscale`` attaches a :class:`CarbonAutoscaler` driven
    by the *unshifted* cluster trace."""
    if n < 1:
        raise ValueError("need at least one replica")
    base = cluster_trace or carbon_mod.CarbonIntensityTrace.constant()
    replicas = []
    for i in range(n):
        dev = devices[i % len(devices)] if devices else None
        shift = grid_shifts[i % len(grid_shifts)] if grid_shifts else 0.0
        replicas.append(Replica(
            f"r{i}", engine_factory(i, dev),
            carbon_trace=shifted_trace(base, shift), trace=trace,
            **scheduler_kwargs))
    scaler = CarbonAutoscaler(base, **(autoscaler_kwargs or {})) \
        if autoscale else None
    return ClusterRouter(replicas, policy=policy, autoscaler=scaler,
                         trace=trace)


__all__ = [
    "ROUTER_POLICIES", "CarbonAutoscaler", "ClusterReport",
    "ClusterRouter", "Replica", "ReplicaTraceView", "ShadowRadixIndex",
    "make_cluster", "shifted_trace",
]
