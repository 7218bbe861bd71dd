"""Request scheduling for multi-request serving.

Two schedulers:

* :class:`FCFSScheduler` — the original minimal batch-of-prompts queue,
  kept for closed-loop drivers that batch whole `generate()` calls.
* :class:`ContinuousBatchScheduler` — the serving subsystem proper: admits
  trace-driven arrivals under a pluggable :class:`SchedulingPolicy`
  (FCFS / SLO-aware EDF / carbon-aware — ``serving/policy.py``), chunks
  prefill into fixed-token slices interleaved with decode steps, forms a
  fresh decode batch every step (finished requests leave, queued requests
  join without waiting for the batch to drain), and preempts under KV
  memory pressure — including mid-prefill — swapping preempted requests'
  KV through the tiered HBM→DRAM→SSD cache.

Units and clock semantics: every cost — prefill chunks, batched decode,
KV swaps, idle gaps — lands on the engine's modeled transfer clock in
**seconds** (`M2CacheEngine.clock`); request timestamps (`arrival_s`,
`admitted_s`, `first_token_s`, `finish_s`) are rebased to the run's clock
origin, so latencies are plain differences. Carbon is integrated
step-by-step by a :class:`~repro_torch.core.carbon.CarbonAccountant` in
**gCO2**, pricing each iteration's energy (J) at the grid intensity of
that moment, which is what makes carbon-aware deferral visible in
gCO2/request. Byte quantities in reports are real (unscaled) bytes.

The paper caps usable batch size (Deja Vu predictors degrade at large
batch — §5.5.2), so ``max_batch`` defaults stay small.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import carbon as carbon_mod
from repro_torch.serving.faults import KVBlockLostError
from repro_torch.serving.kv_cache import TieredKVCache
from repro_torch.serving.policy import FCFSPolicy, SchedulingPolicy
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import (RequestFailure, RequestState,
                                   ServingRequest)
from repro_torch.serving.schema import validate_summary


# ---------------------------------------------------------------------------
# legacy minimal scheduler (closed-loop batch drivers)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    output: Optional[list] = None
    modeled_s: float = 0.0


class FCFSScheduler:
    def __init__(self, max_batch: int = 2):
        self.max_batch = max_batch
        self._q: deque = deque()

    def submit(self, req: Request):
        self._q.append(req)

    def pending(self) -> int:
        return len(self._q)

    def next_batch(self) -> List[Request]:
        out = []
        while self._q and len(out) < self.max_batch:
            out.append(self._q.popleft())
        return out


# ---------------------------------------------------------------------------
# continuous batching


class RequestQueue:
    """Admission queue: FIFO over arrivals, but preempted requests re-enter
    at the front so they resume before new work starts (no starvation)."""

    def __init__(self):
        self._q: deque = deque()

    def push(self, req: ServingRequest):
        self._q.append(req)

    def push_front(self, req: ServingRequest):
        self._q.appendleft(req)

    def pop(self) -> ServingRequest:
        return self._q.popleft()

    def peek(self) -> ServingRequest:
        return self._q[0]

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


@dataclasses.dataclass
class ServingReport:
    requests: List[ServingRequest]
    modeled_span_s: float
    total_tokens: int
    decode_steps: int
    preemptions: int
    kv_stats: Dict[str, float]
    cache_stats: Dict[str, float]
    carbon: Dict[str, float]
    policy: str = "fcfs"
    prefill_chunks: int = 0
    mid_prefill_preemptions: int = 0
    jit_dispatches: int = 0             # real decode graphs launched
    stall_s: float = 0.0                # weight SSD + KV residency stalls
    overlapped_bytes: float = 0.0       # prefetched bytes that hid in time
    prefill_steps: int = 0              # iterations that ran any prefill
    prefill_dispatches: int = 0         # real prefill graphs launched
    prefix_stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    # fault injection + recovery (docs/RELIABILITY.md): requests whose
    # recovery budget ran out land here as structured failures — the
    # clean-failure contract is that the server finishes the run and the
    # caller reads the reason from the report instead of a stack trace
    failed: List[ServingRequest] = dataclasses.field(default_factory=list)
    recoveries: int = 0                 # re-enqueue + re-prefill events
    fault_stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    def failures(self) -> List[dict]:
        """The structured error slots of failed requests (JSON-ready)."""
        return [r.failure.to_dict() for r in self.failed
                if r.failure is not None]

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / self.modeled_span_s \
            if self.modeled_span_s else 0.0

    def _pct(self, vals, q) -> float:
        return float(np.percentile(vals, q)) if vals else 0.0

    @property
    def latencies(self) -> List[float]:
        return [r.latency_s for r in self.requests
                if r.latency_s is not None]

    def slo_summary(self) -> Dict[str, float]:
        """SLO attainment over finished requests that carry an SLO.

        ``slo_attainment`` is the fraction meeting *all three* bounds
        (TTFT, TPOT, completion deadline); per-class and per-bound
        breakdowns let benchmarks show where a policy wins."""
        with_slo = [r for r in self.requests if r.slo is not None]
        if not with_slo:
            return {}
        n = len(with_slo)
        out = {
            "slo_requests": n,
            "slo_attainment": sum(bool(r.slo_met()) for r in with_slo) / n,
            "ttft_attainment":
                sum(r.ttft_s <= r.slo.ttft_s for r in with_slo) / n,
            "tpot_attainment":
                sum(r.tpot_s <= r.slo.tpot_s for r in with_slo) / n,
            "deadline_attainment":
                sum(r.latency_s <= r.slo.deadline_s for r in with_slo) / n,
        }
        for cls in sorted({r.slo.name for r in with_slo}):
            grp = [r for r in with_slo if r.slo.name == cls]
            out[f"slo_attainment_{cls}"] = \
                sum(bool(r.slo_met()) for r in grp) / len(grp)
        return out

    def summary(self) -> Dict[str, float]:
        lat = self.latencies
        ttft = [r.ttft_s for r in self.requests if r.ttft_s is not None]
        n = max(len(self.requests), 1)
        out = {
            "policy": self.policy,
            "requests": len(self.requests),
            "total_tokens": self.total_tokens,
            "modeled_span_s": self.modeled_span_s,
            "tokens_per_s": self.tokens_per_s,
            "p50_latency_s": self._pct(lat, 50),
            "p99_latency_s": self._pct(lat, 99),
            "p50_ttft_s": self._pct(ttft, 50),
            "p99_ttft_s": self._pct(ttft, 99),
            "decode_steps": self.decode_steps,
            "preemptions": self.preemptions,
            "gco2_per_request": self.carbon["total_g"] / n,
            "gco2_total": self.carbon["total_g"],
            "jit_dispatches_per_step":
                self.jit_dispatches / max(self.decode_steps, 1),
            "prefill_dispatches_per_step":
                self.prefill_dispatches / max(self.prefill_steps, 1),
            "stall_s": self.stall_s,
            "overlapped_bytes": self.overlapped_bytes,
        }
        if self.prefix_stats:
            out["prefix_hit_rate"] = self.prefix_stats["prefix_hit_rate"]
            out["prefix_hit_tokens"] = \
                self.prefix_stats["prefix_hit_tokens"]
        if self.kv_stats.get("kv_quant_enabled"):
            # mixed-precision tiers: bytes the quantized transfers avoided
            # and the SSD capacity stretch (fp16-equivalent bytes behind
            # the spill writes / packed bytes actually written)
            out["kv_transfer_saved_bytes"] = \
                self.kv_stats["kv_transfer_saved_bytes"]
            written = self.kv_stats["kv_ssd_write_bytes"]
            out["kv_ssd_capacity_stretch"] = \
                self.kv_stats["kv_ssd_write_full_bytes"] / written \
                if written else 1.0
        if self.fault_stats or self.failed:
            out["faults_injected"] = \
                float(self.fault_stats.get("faults_injected", 0))
            out["failed_requests"] = len(self.failed)
            out["recovered_requests"] = sum(
                1 for r in self.requests if r.recoveries)
            out["recoveries_total"] = self.recoveries
            out["gco2_recovery_total"] = sum(
                r.gco2_recovery_g for r in self.requests + self.failed)
        out.update(self.slo_summary())
        out["mean_intensity_g_kwh"] = \
            self.carbon["mean_intensity_g_kwh"]
        # the schema module is the single source of truth for these keys
        # (scripts/check_bench.py holds baselines to the same schema) —
        # a renamed key fails here, not silently in a CI gate
        return validate_summary(out)


class ContinuousBatchScheduler:
    """Drives an :class:`M2CacheEngine` step-by-step over an open queue.

    ``policy`` picks admission order, carbon gating and preemption victims
    (default :class:`FCFSPolicy` = PR-1 behaviour). ``prefill_chunk``
    bounds how many prompt tokens one scheduler iteration may prefill per
    request (None = monolithic: the whole prompt in one charge); chunking
    lets decode steps of running requests interleave with a long prompt's
    prefill and allows preemption mid-prefill. ``carbon_trace`` prices
    each iteration's energy at that moment's grid intensity (defaults to
    the paper's constant 820 gCO2/kWh).

    ``prefix_caching=True`` (or an explicit ``prefix_cache``) turns on
    radix-tree KV reuse: admission looks the prompt up before the KV
    budget check (a hit shrinks the blocks the request needs of its
    own), hit-path nodes are locked/pinned and made resident at modeled
    transfer cost, finished prefills donate their prompt blocks back to
    the tree, and ``free`` releases the refs. The tree shares this
    scheduler's :class:`TieredKVCache` — cached prefixes page over the
    same HBM→DRAM→SSD tiers as live request KV.

    ``kv_precision`` (anything ``kv_cache.parse_precision_map`` accepts;
    default None = fp16 everywhere, byte-identical paging) turns on
    mixed-precision KV tiers: demoted blocks are stored quantized per
    tier and all transfer/capacity accounting prices the packed bytes.
    When quantized tiers are on, the prefix cache picks its insert
    precision carbon-aware (clean grid window → int8, dirty → int4) and
    the report grows ``kv_transfer_saved_bytes`` /
    ``kv_ssd_capacity_stretch``.

    Observability (all optional, all free on the modeled clock —
    recording never advances it, so modeled tok/s and generated tokens
    are identical with or without it): ``trace`` (a
    :class:`repro.obs.TraceRecorder`) records per-request phase spans
    (queued → prefill → decode, preemption parks), scheduler decisions,
    KV/prefix/DMA events and per-step carbon counters; ``block_trace``
    (a :class:`repro.obs.BlockTraceCollector`) records every KV block
    tier transition in the replacement-policy-lab replay format;
    ``metrics`` (a :class:`repro.obs.MetricsRegistry`) accumulates
    serving counters/gauges/histograms, with ``snapshotter`` ticked
    once per scheduler iteration on the modeled clock.
    """

    def __init__(self, engine, kv: Optional[TieredKVCache] = None, *,
                 max_batch: int = 8, hbm_kv_gb: float = 0.25,
                 dram_kv_gb: float = 1.0,
                 policy: Optional[SchedulingPolicy] = None,
                 prefill_chunk: Optional[int] = None,
                 carbon_trace: Optional[
                     carbon_mod.CarbonIntensityTrace] = None,
                 kv_prefetch: bool = True,
                 kv_precision=None,
                 prefix_cache: Optional[PrefixCache] = None,
                 prefix_caching: bool = False,
                 prefix_capacity_tokens: int = 65536,
                 prefix_carbon_aware: bool = False,
                 trace=None, metrics=None, block_trace=None,
                 snapshotter=None, ledger=None, health=None,
                 faults=None, max_recoveries: int = 2,
                 prefix_persist_dir: Optional[str] = None,
                 prefix_persist_interval_s: Optional[float] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.engine = engine
        if kv is None:
            import os
            kv = TieredKVCache(
                num_layers=engine.num_layers, d_model=engine.d_model,
                hbm_capacity_bytes=hbm_kv_gb * 2**30,
                dram_capacity_bytes=dram_kv_gb * 2**30,
                ssd_dir=os.path.join(engine._ssd_dir, "kv"), hw=engine.hw,
                bytes_per_token=engine.kv_bytes_per_token(),
                block_tokens=getattr(engine, "kv_block_tokens", 16),
                prefetch=engine.prefetch if kv_prefetch else None,
                store_payloads=getattr(engine, "supports_kv_payloads",
                                       False),
                precision_map=kv_precision)
        self.kv = kv
        # real KV restore across requests needs the cache and the engine
        # to agree on block granularity (block-chunked prefill boundaries
        # must line up with cached block boundaries)
        self._real_restore = kv.store_payloads and \
            kv.block_tokens == getattr(engine, "kv_block_tokens", None)
        # predictive KV promotion only works when the cache carries the
        # shared DMA engine (a caller-supplied kv may not)
        self.kv_prefetch = kv_prefetch and kv.prefetch is not None
        self.max_batch = max_batch
        self.policy = policy or FCFSPolicy()
        self.prefill_chunk = prefill_chunk
        self.carbon_trace = carbon_trace
        if prefix_cache is None and prefix_caching:
            prefix_cache = PrefixCache(
                kv, capacity_tokens=prefix_capacity_tokens,
                carbon_trace=carbon_trace if prefix_carbon_aware else None,
                insert_precision="carbon" if kv.quantized else None)
        self.prefix = prefix_cache
        self._t0 = 0.0                   # run()'s clock origin
        # -- fault injection + graceful degradation (docs/RELIABILITY.md)
        # ``faults`` plugs a seeded FaultInjector into every storage and
        # transfer boundary below; ``max_recoveries`` bounds how many
        # times a request may be re-prefilled after losing a KV block
        # before it fails *cleanly* into ServingReport.failed.
        self.faults = faults
        self.max_recoveries = int(max_recoveries)
        self.prefix_persist_dir = prefix_persist_dir
        self.prefix_persist_interval_s = prefix_persist_interval_s
        self._last_persist = 0.0
        self.prefix_online_saves = 0
        if faults is not None:
            self.kv.attach_faults(faults)
        # -- observability wiring (purely passive: no clock advances) --
        self.trace = trace
        self.metrics = metrics
        self.block_trace = block_trace
        self.snapshotter = snapshotter
        # ``ledger`` (a repro.obs.TimeLedger) attributes every modeled
        # second + gCO2 gram of run() into exclusive categories under a
        # conservation invariant; ``health`` (a repro.obs.HealthMonitor)
        # evaluates alert rules once per iteration on the modeled clock.
        # Both are passive: billing reads clock deltas, never makes them.
        self.ledger = ledger
        self.health = health
        self._iter_bill: Optional[Dict[str, float]] = None
        self._trace_drops_seen = 0
        self._phase_spans: Dict[int, object] = {}  # rid -> open span id
        clk = lambda: self.engine.clock
        # quarantine re-probe timing (kv_cache._maybe_reprobe) runs on
        # the same modeled clock; harmless without faults
        self.kv.set_clock(clk)
        if trace is not None:
            trace.set_default_clock(clk)
            pf = getattr(engine, "prefetch", None)
            if pf is not None:
                pf.attach_trace(trace)
            if self.prefix is not None:
                self.prefix.attach_obs(trace, clk)
        if trace is not None or block_trace is not None:
            self.kv.attach_obs(trace=trace, block_trace=block_trace,
                               clock=clk)
        self._m = None
        if metrics is not None:
            self._m = {
                "tokens": metrics.counter(
                    "serving_tokens_total", "generated tokens"),
                "finished": metrics.counter(
                    "serving_requests_finished_total",
                    "requests served to completion"),
                "preemptions": metrics.counter(
                    "serving_preemptions_total", "KV-pressure preemptions"),
                "gco2": metrics.counter(
                    "serving_gco2_total", "operational carbon (gCO2)"),
                "ttft": metrics.histogram(
                    "serving_ttft_seconds", "time to first token (modeled)"),
                "latency": metrics.histogram(
                    "serving_latency_seconds",
                    "request latency (modeled)"),
                "tpot": metrics.histogram(
                    "serving_tpot_seconds",
                    "mean time per output token (modeled)"),
                "active": metrics.gauge(
                    "serving_active_requests", "requests in the batch"),
                "waiting": metrics.gauge(
                    "serving_waiting_requests", "requests queued/preempted"),
                "hbm_kv": metrics.gauge(
                    "kv_hbm_used_bytes", "KV bytes resident in HBM"),
                "recoveries": metrics.counter(
                    "serving_faults_recoveries_total",
                    "requests re-enqueued after a lost KV block"),
                "failed": metrics.counter(
                    "serving_faults_failed_requests_total",
                    "requests failed after exhausting recoveries"),
                # health-engine feeds (docs/OBSERVABILITY.md)
                "slo_violations": metrics.counter(
                    "serving_slo_violations_total",
                    "finished requests that missed their SLO"),
                "ssd_quarantined": metrics.gauge(
                    "kv_ssd_quarantined",
                    "1 while the SSD circuit breaker is tripped"),
                "dram_overcommit": metrics.gauge(
                    "kv_dram_overcommit_bytes",
                    "DRAM KV bytes beyond capacity (degraded paging)"),
                "prefix_hit_rate": metrics.gauge(
                    "serving_prefix_hit_rate",
                    "lifetime prefix-cache token hit rate"),
                "trace_drops": metrics.counter(
                    "obs_trace_dropped_events_total",
                    "trace events evicted by ring overflow"),
            }
        if faults is not None:
            faults.attach_obs(trace=trace, metrics=metrics)

    # -- per-request phase spans (queued → prefill → decode → finish) ----
    def _obs_phase_begin(self, r: ServingRequest, name: str):
        if self.trace is not None:
            self._phase_spans[r.rid] = self.trace.span_begin(
                f"req:{r.rid}", name)

    def _obs_phase_end(self, r: ServingRequest, **args):
        sid = self._phase_spans.pop(r.rid, None)
        if sid is not None:
            self.trace.span_end(sid, **args)

    # ------------------------------------------------------------------
    def _dram_gb(self) -> float:
        """Current resident DRAM (weights + KV) in GiB, for carbon."""
        eng = self.engine
        weights = eng.manager.dram.used_bytes if eng.manager else \
            eng.num_layers * eng._layer_bytes_fp16()
        return (weights + self.kv.dram.used_bytes) / 2**30

    # -- time-ledger billing (docs/OBSERVABILITY.md) -------------------
    # Every clock advance in run() is billed to exactly one exclusive
    # ledger category from the *measured* clock delta, so the category
    # sums reproduce the span by construction and any future
    # instrumentation gap shows up as conservation residue.

    def _retrans_s(self) -> float:
        pf = getattr(self.engine, "prefetch", None)
        return pf.stats.retransfer_s if pf is not None else 0.0

    def _bill_time(self, cat: str, dt: float):
        if self.ledger is None or dt <= 0.0:
            return
        self.ledger.bill(cat, dt)
        if self._iter_bill is not None:
            self._iter_bill[cat] = self._iter_bill.get(cat, 0.0) + dt

    def _bill_region(self, cat: str, t0: float, r0: float):
        """Bill the clock delta since ``t0`` to ``cat``, carving out any
        synchronous DMA retransfer (retransfer_s delta since ``r0``)
        that happened inside the region."""
        if self.ledger is None:
            return
        dt = self.engine.clock - t0
        rt = min(max(self._retrans_s() - r0, 0.0), dt)
        self._bill_time("dma_retransfer", rt)
        self._bill_time(cat, dt - rt)

    def _bill_step(self, phase: str, step_dt: float, retrans_s: float,
                   stall_s: float, disp: list, fallback_batch: int,
                   recovery_frac: float = 0.0):
        """Decompose one engine step's clock delta: DMA retransfer,
        weight-stream stall, recovery re-prefill share, then the compute
        remainder split across dispatch groups (``phase_compute/b<N>``)
        proportional to each group's stall-free span."""
        if self.ledger is None:
            return
        rt = min(max(retrans_s, 0.0), step_dt)
        stall = min(max(stall_s, 0.0), step_dt)
        weight = max(stall - rt, 0.0)
        self._bill_time("dma_retransfer", rt)
        self._bill_time("weight_stall", weight)
        rem = max(step_dt - rt - weight, 0.0)
        rec = rem * min(max(recovery_frac, 0.0), 1.0)
        self._bill_time("recovery_reprefill", rec)
        rem -= rec
        if rem <= 0.0:
            return
        weights = [(d["batch"],
                    max(d["t1"] - d["t0"] - d["stall_s"], 0.0))
                   for d in disp]
        tot = sum(w for _, w in weights)
        if tot <= 0.0:
            self._bill_time(f"{phase}_compute/b{fallback_batch}", rem)
            return
        for b, w in weights:
            self._bill_time(f"{phase}_compute/b{b}", rem * w / tot)

    def _drain_dispatches(self, phase: str) -> list:
        """Pop the manager's per-dispatch cost records, re-emitting them
        as ``engine`` dispatch spans so the profiler (live or offline)
        can break groups into kernel-launch vs HBM-read vs compute."""
        mgr = getattr(self.engine, "manager", None)
        if mgr is None:
            return []
        disp = mgr.drain_dispatch_log()
        if self.trace is not None:
            for d in disp:
                self.trace.span("engine", "dispatch", d["t0"], d["t1"],
                                phase=phase, batch=d["batch"],
                                compute_s=d["compute_s"],
                                hbm_load_s=d["hbm_load_s"],
                                hbm_read_s=d["hbm_read_s"],
                                kernel_launch_s=d["kernel_launch_s"],
                                stall_s=d["stall_s"])
        return disp

    def _admit(self, req: ServingRequest, active: List[ServingRequest]):
        """Admit (or resume) one request into the active set."""
        eng, kv = self.engine, self.kv
        protect = [r.rid for r in active] + [req.rid]
        if req.state is RequestState.PREEMPTED:
            # resume: KV swaps back in (or, if prefetched ahead, pays only
            # the residual in-flight stall); prefill continues where it
            # stopped. Held prefix nodes re-pin and come resident too.
            if self.prefix is not None:
                self.prefix.resume(req.rid)
                for nrid in self.prefix.node_rids(req.rid):
                    eng.advance_clock(
                        kv.ensure_resident(nrid, protect, now=eng.clock))
            eng.advance_clock(
                kv.ensure_resident(req.rid, protect, now=eng.clock))
            if self.trace is not None:
                self._obs_phase_end(req)          # close "preempted"
                self.trace.instant("sched", "resume", rid=req.rid,
                                   mid_prefill=not req.prefilled)
                self._obs_phase_begin(
                    req, "decode" if req.prefilled else "prefill")
        else:
            hit = 0
            prefix_kv = None
            if self.prefix is not None and req.prompt is not None:
                # radix lookup: lock the hit path (refs + HBM pins) and
                # pay its residency transfers — a DRAM/SSD-parked prefix
                # charges PCIe/NVMe seconds instead of prefill compute
                m = self.prefix.lock(req.rid, req.true_prompt(),
                                     now=eng.clock - self._t0)
                hit = m.hit_tokens
                for nrid in self.prefix.node_rids(req.rid):
                    eng.advance_clock(
                        kv.ensure_resident(nrid, protect, now=eng.clock))
                if hit and self._real_restore:
                    # now resident: hand the hit path's actual KV bytes
                    # to the engine, which restores them into the fresh
                    # cache and prefills only the suffix chunks
                    prefix_kv = [p for nrid in
                                 self.prefix.node_rids(req.rid)
                                 for p in kv.payloads_for(nrid)]
            req.session = eng.begin_prefill(
                req.prompt, rid=req.rid, prompt_len=req.prompt_len,
                max_new_tokens=req.max_new_tokens, prefix_hit=hit,
                prefix_kv=prefix_kv)
            # origin = the hit the engine actually accepted (it may clamp
            # a malformed one), so the request's own blocks' token grid
            # always matches the session positions they export/import
            kv.set_origin(req.rid, req.session.prefix_hit)
            kv.register_provider(req.rid, eng.kv_provider(req.session))
            req.prefix_hit = req.session.prefix_hit
            req.prompt_done = req.session.prompt_done
            req.admitted_s = eng.clock - self._t0
            if self.trace is not None:
                # the queue wait as a closed span: arrival → admission
                self.trace.span(f"req:{req.rid}", "queued",
                                self._t0 + req.arrival_s, eng.clock,
                                rid=req.rid)
                self.trace.instant("sched", "admit", rid=req.rid,
                                   prefix_hit=req.prefix_hit)
                self._obs_phase_begin(
                    req, "decode" if req.prefilled else "prefill")
        req.state = RequestState.RUNNING if req.prefilled \
            else RequestState.PREFILLING
        active.append(req)

    # -- fault recovery (docs/RELIABILITY.md) ---------------------------
    def _on_block_lost(self, err: KVBlockLostError, req: ServingRequest,
                       waiting: List[ServingRequest],
                       failed: List[ServingRequest]) -> int:
        """A KV block payload is unrecoverably gone during admission.

        ``err.rid < 0`` names a shared prefix-tree node: the poisoned
        subtree is invalidated (future lookups recompute) and the victim
        request simply re-queues — its own state is intact.  ``err.rid
        >= 0`` names the request's own block: the request is torn down
        and deterministically re-prefilled from its prompt + the tokens
        it already emitted (see :meth:`_recover_request`).  Returns the
        number of recoveries charged (0 or 1)."""
        now = self.engine.clock - self._t0
        if self.trace is not None:
            self.trace.instant("sched", "block_lost", rid=err.rid,
                               bid=err.bid, victim=req.rid,
                               reason=err.reason)
        if err.rid < 0 and self.prefix is not None:
            self.prefix.invalidate(err.rid, now=now)
            # drop the victim's hold on the (now partially gone) hit
            # path; re-admission redoes the lookup against the pruned
            # tree and prefills whatever is no longer served by it
            if req.state is RequestState.PREEMPTED:
                self.prefix.suspend(req.rid)
            else:
                self.prefix.release(req.rid, now=now)
            waiting.append(req)
            return 0
        return self._recover_request(req, waiting, failed, err)

    def _recover_request(self, req: ServingRequest,
                         waiting: List[ServingRequest],
                         failed: List[ServingRequest],
                         err: KVBlockLostError) -> int:
        """Tear down ``req`` and re-enqueue it for a fresh prefill over
        prompt + already-emitted tokens; greedy decode + block-pure
        prefill make the continued stream byte-identical to the
        fault-free run.  After ``max_recoveries`` attempts the request
        fails cleanly into ``failed`` with a structured
        :class:`RequestFailure` — the server never dies."""
        eng = self.engine
        now = eng.clock - self._t0
        emitted = []
        if req.session is not None and getattr(req.session, "tokens",
                                               None) is not None:
            emitted = [int(t) for t in req.session.tokens]
        if self.prefix is not None:
            self.prefix.release(req.rid, now=now)
        self.kv.free(req.rid)
        req.session = None
        req.recoveries += 1
        self._obs_phase_end(req)
        if req.recoveries > self.max_recoveries:
            req.state = RequestState.FAILED
            req.failure = RequestFailure(
                rid=req.rid, reason=err.reason, bid=err.bid,
                recovery_attempts=req.recoveries - 1, t_failed_s=now)
            failed.append(req)
            if self.trace is not None:
                self.trace.instant("sched", "request_failed", rid=req.rid,
                                   reason=err.reason,
                                   attempts=req.recoveries - 1)
            if self._m is not None:
                self._m["failed"].inc()
            return 0
        if req.prompt is not None and emitted:
            # fold the emitted tokens into the prompt: the re-prefill
            # recomputes their KV (block-pure), and they move to
            # ``recovered_prefix`` so final_tokens() stays the full
            # stream and total_tokens doesn't double-count
            base = np.asarray(req.prompt).reshape(-1)[-req.prompt_len:]
            req.prompt = np.concatenate(
                [base, np.asarray(emitted, dtype=base.dtype)])
            req.prompt_len += len(emitted)
            req.recovered_prefix.extend(emitted)
        req._true_prompt = None
        req.prompt_done = 0
        req.prefix_hit = 0
        req.state = RequestState.QUEUED
        if self.trace is not None:
            self.trace.instant("sched", "recover", rid=req.rid,
                               attempt=req.recoveries,
                               replay_tokens=len(emitted))
        if self._m is not None:
            self._m["recoveries"].inc()
        waiting.append(req)
        return 1

    def _persist_tick(self):
        """Crash-consistent periodic online save of the prefix tree:
        every ``prefix_persist_interval_s`` modeled seconds the tree is
        saved as a fresh atomic epoch (write-temp-then-rename), so a
        crash at any moment leaves the latest *complete* epoch
        loadable."""
        if (self.prefix is None or self.prefix_persist_dir is None
                or not self.prefix_persist_interval_s):
            return
        eng = self.engine
        if eng.clock - self._last_persist < self.prefix_persist_interval_s:
            return
        self.prefix.save(self.prefix_persist_dir)
        self.prefix_online_saves += 1
        self._last_persist = eng.clock
        if self.trace is not None:
            self.trace.instant("sched", "prefix_save",
                               epoch=self.prefix_online_saves)

    def _prefill_step(self, active: List[ServingRequest]) -> tuple:
        """One prefill chunk for every PREFILLING request — executed and
        priced as a batched prefill step by the engine (stacked vmapped
        dispatches + dispatch-group weight pricing when the engine's
        ``prefill_bucket`` > 1). Returns (compute seconds, chunks
        charged, stall seconds, overlapped bytes, prefill dispatches,
        {rid: prompt tokens prefilled this step})."""
        eng, kv = self.engine, self.kv
        pf = [r for r in active if r.state is RequestState.PREFILLING]
        if not pf:
            return 0.0, 0, 0.0, 0.0, 0, {}
        t_pf0 = eng.clock
        r_pf0 = self._retrans_s()
        if eng.manager is not None:
            # anything still in the log predates this step (warmup,
            # restores) — keep the drain below step-pure
            eng.manager.dispatch_log.clear()
        before = {r.rid: r.session.prompt_done for r in pf}
        rep = eng.prefill_step([r.session for r in pf],
                               self.prefill_chunk)
        disp = self._drain_dispatches("prefill")
        step_dt = eng.clock - t_pf0
        step_rt = min(max(self._retrans_s() - r_pf0, 0.0), step_dt)
        protect = [r.rid for r in active]
        chunks = 0
        deltas: Dict[int, int] = {}
        for r in pf:
            delta = r.session.prompt_done - before[r.rid]
            if delta > 0:
                dt_ext = kv.extend(r.rid, delta, protect)
                eng.advance_clock(dt_ext)
                self._bill_time("kv_stall", dt_ext)
                chunks += 1
                deltas[r.rid] = delta
                if self.trace is not None:
                    self.trace.instant(f"req:{r.rid}", "prefill_chunk",
                                       tokens=delta,
                                       prompt_done=r.session.prompt_done)
            r.prompt_done = r.session.prompt_done
            if r.prefilled:
                r.state = RequestState.RUNNING
                if self.trace is not None:
                    self._obs_phase_end(r)
                    self._obs_phase_begin(r, "decode")
                if self.prefix is not None and r.prompt is not None:
                    # donate the freshly-computed full prompt blocks to
                    # the radix tree (copy-on-write: ownership moves,
                    # bytes stay put) unless carbon admission says
                    # recompute-later is greener
                    self.prefix.insert(
                        r.rid, r.true_prompt(),
                        prefix_hit=r.prefix_hit,
                        now=eng.clock - self._t0)
        if self.ledger is not None:
            tot_tok = sum(deltas.values())
            rec_tok = sum(deltas.get(r.rid, 0) for r in pf if r.recoveries)
            self._bill_step("prefill", step_dt, step_rt, rep.stall_s,
                            disp, len(pf),
                            rec_tok / tot_tok if tot_tok else 0.0)
        if chunks and self.trace is not None:
            self.trace.span("sched", "prefill_step", t_pf0, eng.clock,
                            requests=len(pf), chunks=chunks,
                            dispatches=rep.jit_dispatches)
        return (rep.compute_s, chunks, rep.stall_s,
                rep.overlapped_bytes, rep.jit_dispatches, deltas)

    def _prefetch_ahead(self, waiting: List[ServingRequest], now: float):
        """Predict the next step's resident set and start promoting it.

        The requests the policy would admit next are the prediction;
        preempted ones among them have KV parked in DRAM/SSD, so their
        blocks are issued on the shared DMA channels *now* — overlapping
        the decode step that is about to run — and the eventual
        ``ensure_resident`` at admission hits warm HBM instead of
        stalling the clock. Promotion is opportunistic (free headroom
        only), so a wrong prediction wastes bus time but never displaces
        running requests' KV; in particular a request waiting on a batch
        *slot* (not on KV space, e.g. under the paper's §5.5.2 batch cap)
        warms up entirely for free."""
        if not self.kv_prefetch or not waiting:
            return
        for req in self.policy.admission_order(waiting,
                                               now)[:self.max_batch]:
            if not self.policy.may_start(req, now):
                continue
            if req.state is RequestState.PREEMPTED:
                self.kv.prefetch_resident(req.rid, now=self.engine.clock)

    def _preempt(self, active: List[ServingRequest],
                 waiting: List[ServingRequest]) -> tuple:
        """Policy-ordered preemption until the KV working set fits its HBM
        budget; PREFILLING requests may be preempted mid-prefill and
        resume from ``prompt_done``. Returns (total, mid-prefill) counts."""
        n = mid = 0
        while self.kv.over_budget() and len(active) > 1:
            victim = self.policy.victim_order(active)[0]
            active.remove(victim)
            dt_sw = self.kv.swap_out(victim.rid)
            self.engine.advance_clock(dt_sw)
            self._bill_time("kv_stall", dt_sw)
            if self.prefix is not None:
                # refs are kept (nodes can't be reclaimed) but the pins
                # drop, so a parked request's prefix may age to DRAM/SSD
                self.prefix.suspend(victim.rid)
            if victim.state is RequestState.PREFILLING:
                mid += 1
            if self.trace is not None:
                self.trace.instant(
                    "sched", "preempt", rid=victim.rid,
                    mid_prefill=victim.state is RequestState.PREFILLING)
                self._obs_phase_end(victim, preempted=True)
                self._obs_phase_begin(victim, "preempted")
            if self._m is not None:
                self._m["preemptions"].inc()
            victim.state = RequestState.PREEMPTED
            victim.preemptions += 1
            waiting.append(victim)
            n += 1
        return n, mid

    def run(self, requests: List[ServingRequest], *,
            horizon_s: Optional[float] = None) -> ServingReport:
        """Serve ``requests`` to completion; returns the run's report.

        ``horizon_s`` (modeled seconds from the run origin) bills the
        server's idle base power out to a fixed serving window even after
        the last request finishes. Policy comparisons need this: a
        carbon-aware policy *shifts* work inside the window, and only a
        common window makes gCO2/request comparable (the server is on
        either way). Latencies and tokens/s are unaffected; if the run
        outlives the horizon, billing simply ends at the true span.
        """
        eng, kv = self.engine, self.kv
        pending = sorted(requests, key=lambda r: r.arrival_s)
        waiting: List[ServingRequest] = []
        active: List[ServingRequest] = []    # PREFILLING + RUNNING
        finished: List[ServingRequest] = []
        failed: List[ServingRequest] = []    # clean structured failures
        recoveries = 0
        i = 0
        clock_start = eng.clock
        # arrival times are trace-relative; rebase all request timestamps
        # to this run's clock origin so latency = finish - arrival holds
        # (the engine clock starts at warmup and accumulates across runs)
        self._t0 = clock_start
        if self.faults is not None:
            # scripted fault windows are run-relative, like arrival_s
            self.faults.set_clock(lambda: self.engine.clock - self._t0)
        self._last_persist = clock_start
        accountant = carbon_mod.CarbonAccountant(
            device_name=eng.device_name, ssd_active=eng.use_ssd,
            trace=self.carbon_trace)
        if self.trace is not None:
            # accountant times are run-relative; counters land on the
            # absolute engine clock like every other trace event
            accountant.attach_trace(self.trace, t0=clock_start)
            if self.health is not None:
                self.health.attach_trace(self.trace, t0=clock_start)
        # prefix counters are lifetime (the tree outlives runs); snapshot
        # so this run's report shows per-run rates, not cumulative ones
        prefix0 = self.prefix.stats() if self.prefix is not None else {}
        decode_steps = 0
        preemptions = 0
        mid_prefill_preemptions = 0
        prefill_chunks = 0
        prefill_steps = 0
        prefill_dispatches = 0
        jit_dispatches = 0
        stall_s = 0.0
        overlapped = 0.0

        while i < len(pending) or waiting or active:
            iter_clock0 = eng.clock
            iter_compute = 0.0
            # per-iteration time bill: the carbon slice below is split
            # across ledger categories in proportion to it
            self._iter_bill = {} if self.ledger is not None else None
            now = eng.clock - clock_start
            while i < len(pending) and pending[i].arrival_s <= now:
                waiting.append(pending[i])
                i += 1
            if not active and not any(self.policy.may_start(r, now)
                                      for r in waiting):
                # idle: jump to the next arrival or the earliest moment a
                # held (carbon-deferred) request may start
                targets = [pending[i].arrival_s] if i < len(pending) else []
                for r in waiting:
                    h = self.policy.holdoff_until(r, now)
                    if h is not None:
                        targets.append(h)
                if not targets:
                    raise RuntimeError(
                        f"policy {self.policy.name!r} holds requests "
                        "without a holdoff_until time")
                dt = max(min(targets) - now, 1e-9)
                t_idle0 = eng.clock
                eng.advance_clock(dt)
                g_idle = accountant.charge(now, dt, 0.0, self._dram_gb(),
                                           active=False)
                if self.ledger is not None:
                    self.ledger.bill("idle", dt)
                    self.ledger.bill_g("idle", g_idle)
                if self.health is not None:
                    self.health.evaluate(eng.clock - clock_start)
                if self.trace is not None:
                    self.trace.span("sched", "idle", t_idle0, eng.clock,
                                    waiting=len(waiting))
                if self.snapshotter is not None:
                    self.snapshotter.tick(eng.clock)
                self._persist_tick()
                continue
            # admit in policy order up to max_batch; stop when the KV
            # budget says no (carbon-held requests are skipped, not
            # blocking the ones behind them). A prefix-cache lookup runs
            # *before* the budget check: hit tokens live in shared radix
            # blocks, so only the suffix needs blocks of the request's
            # own
            t_adm0 = eng.clock
            r_adm0 = self._retrans_s()
            for req in self.policy.admission_order(waiting, now):
                if len(active) >= self.max_batch:
                    break
                if not self.policy.may_start(req, now):
                    continue
                need = max(req.total_tokens, 1)
                if self.prefix is not None and req.prompt is not None:
                    if req.state is RequestState.PREEMPTED:
                        need = req.own_kv_tokens
                    else:
                        need = max(req.total_tokens - self.prefix.match(
                            req.true_prompt()).hit_tokens, 1)
                if not kv.can_admit(need,
                                    [r.rid for r in active]) and active:
                    break
                waiting.remove(req)
                try:
                    self._admit(req, active)
                except KVBlockLostError as e:
                    # a block needed for residency is unrecoverably gone:
                    # route to recovery (re-queue / re-prefill / clean
                    # failure) and keep serving everyone else
                    recoveries += self._on_block_lost(e, req, waiting,
                                                      failed)
            # every clock advance inside admission is a KV residency
            # charge (ensure_resident / restores), net of DMA retransfer
            self._bill_region("kv_stall", t_adm0, r_adm0)
            # one prefill chunk per prefilling request, then resolve KV
            # pressure (possibly preempting mid-prefill), then decode
            comp, chunks, pf_stall, pf_overlap, pf_disp, pf_deltas = \
                self._prefill_step(active)
            iter_compute += comp
            prefill_chunks += chunks
            if chunks:
                prefill_steps += 1
            prefill_dispatches += pf_disp
            stall_s += pf_stall
            overlapped += pf_overlap
            # keep refs to this iteration's prefillers before preemption
            # can move them back to waiting — carbon attribution below
            # still charges them for the work they did this step
            by_rid = {r.rid: r for r in active}
            n, mid = self._preempt(active, waiting)
            preemptions += n
            mid_prefill_preemptions += mid
            running = [r for r in active if r.state is RequestState.RUNNING]
            finished_now: List[ServingRequest] = []
            # issue next step's predicted KV promotions before decoding so
            # the transfers overlap this step's compute on the DMA clock
            self._prefetch_ahead(waiting, eng.clock - clock_start)
            if running:
                t_dec0 = eng.clock
                r_dec0 = self._retrans_s()
                if eng.manager is not None:
                    eng.manager.dispatch_log.clear()
                rep = eng.decode_step([r.session for r in running])
                dec_disp = self._drain_dispatches("decode")
                dec_dt = eng.clock - t_dec0
                self._bill_step(
                    "decode", dec_dt,
                    min(max(self._retrans_s() - r_dec0, 0.0), dec_dt),
                    rep.stall_s, dec_disp, len(running))
                iter_compute += rep.compute_s
                decode_steps += 1
                jit_dispatches += rep.jit_dispatches
                stall_s += rep.stall_s
                overlapped += rep.overlapped_bytes
                for r in running:
                    kv.touch(r.rid)
                    dt_app = kv.append_token(r.rid,
                                             [x.rid for x in active])
                    eng.advance_clock(dt_app)
                    self._bill_time("kv_stall", dt_app)
                    r.generated += 1
                    if r.first_token_s is None:
                        r.first_token_s = eng.clock - clock_start
                        if self.trace is not None:
                            self.trace.instant(f"req:{r.rid}",
                                               "first_token",
                                               ttft_s=r.ttft_s)
                if self.trace is not None:
                    self.trace.span("sched", "decode_step", t_dec0,
                                    eng.clock, batch=len(running))
                if self._m is not None:
                    self._m["tokens"].inc(len(running))
                for r in running:
                    if r.done:
                        r.state = RequestState.FINISHED
                        r.finish_s = eng.clock - clock_start
                        if self.prefix is not None:
                            self.prefix.release(
                                r.rid, now=eng.clock - clock_start)
                        kv.free(r.rid)
                        finished.append(r)
                        active.remove(r)
                        finished_now.append(r)
            slice_g = accountant.charge(iter_clock0 - clock_start,
                                        eng.clock - iter_clock0,
                                        iter_compute, self._dram_gb())
            # split this iteration's carbon across the requests that did
            # work in it, proportional to tokens processed (prefill
            # chunks + one decode token per running request)
            iter_work = [(by_rid[rid], "prefill", d)
                         for rid, d in pf_deltas.items()] \
                + [(r, "decode", 1) for r in running]
            tot = sum(w for _, _, w in iter_work)
            if slice_g > 0.0 and tot > 0:
                for r, phase, w in iter_work:
                    g = slice_g * w / tot
                    r.gco2_g += g
                    if phase == "prefill":
                        r.gco2_prefill_g += g
                        if r.recoveries:
                            # every post-recovery prefill slice is redo
                            # work a fault destroyed — the reliability
                            # tax, reported as gco2_recovery_total
                            r.gco2_recovery_g += g
                    else:
                        r.gco2_decode_g += g
                if self._m is not None:
                    self._m["gco2"].inc(slice_g)
            if self.ledger is not None and slice_g > 0.0:
                # operational carbon follows time: split the slice across
                # this iteration's billed categories by time share
                bill_tot = sum(self._iter_bill.values())
                if bill_tot > 0.0:
                    for cat, dtc in self._iter_bill.items():
                        self.ledger.bill_g(cat, slice_g * dtc / bill_tot)
                else:
                    self.ledger.bill_g("other", slice_g)
            # finish events fire *after* carbon attribution so the
            # instant's gco2_g carries the request's full footprint
            for r in finished_now:
                if self.trace is not None:
                    self._obs_phase_end(r, generated=r.generated)
                    self.trace.instant(f"req:{r.rid}", "finish",
                                       latency_s=r.latency_s,
                                       gco2_g=r.gco2_g)
                if self._m is not None:
                    self._m["finished"].inc()
                    if r.slo is not None and not r.slo_met():
                        self._m["slo_violations"].inc()
                    self._m["ttft"].observe(r.ttft_s)
                    self._m["latency"].observe(r.latency_s)
                    self._m["tpot"].observe(r.tpot_s)
            if self.trace is not None:
                self.trace.counter("sched", "queue", active=len(active),
                                   waiting=len(waiting))
                self.trace.counter("kv", "kv_bytes",
                                   hbm=kv.hbm_used,
                                   dram=kv.dram.used_bytes)
            if self._m is not None:
                self._m["active"].set(len(active))
                self._m["waiting"].set(len(waiting))
                self._m["hbm_kv"].set(kv.hbm_used)
                self._m["ssd_quarantined"].set(
                    1.0 if kv.ssd_quarantined else 0.0)
                self._m["dram_overcommit"].set(
                    max(kv.dram.used_bytes - kv.dram.capacity, 0))
                if self.prefix is not None:
                    pcur = self.prefix.stats()
                    self._m["prefix_hit_rate"].set(
                        pcur["prefix_hit_tokens"]
                        / max(pcur["prefix_lookup_tokens"], 1))
                if self.trace is not None and \
                        self.trace.dropped_events > self._trace_drops_seen:
                    self._m["trace_drops"].inc(
                        self.trace.dropped_events - self._trace_drops_seen)
                    self._trace_drops_seen = self.trace.dropped_events
            if self.health is not None:
                self.health.evaluate(eng.clock - clock_start)
            if self.ledger is not None and self.trace is not None:
                self.ledger.emit(self.trace, eng.clock)
            if self.snapshotter is not None:
                self.snapshotter.tick(eng.clock)
            self._persist_tick()

        span = eng.clock - clock_start
        if horizon_s is not None and horizon_s > span:
            # bill trailing idle (deep-idle power) to the fixed serving
            # window; the engine clock itself stays at the true span
            g_trail = accountant.charge(span, horizon_s - span, 0.0,
                                        self._dram_gb(), active=False)
            if self.ledger is not None:
                self.ledger.bill("trailing_idle", horizon_s - span)
                self.ledger.bill_g("trailing_idle", g_trail)
        total_tokens = sum(r.generated for r in finished)
        carbon = accountant.totals()
        if self.health is not None:
            self.health.close(span)
        if self.ledger is not None:
            # conservation targets: the span (plus any horizon tail,
            # already billed as trailing_idle) and the accountant's
            # operational total; embodied carbon amortises by wall share
            # and is reported separately, never per category
            self.ledger.close(span_s=span, horizon_s=horizon_s,
                              gco2_total_g=carbon["oce_g"],
                              embodied_g=carbon["ece_g"])
            if self.trace is not None:
                self.ledger.emit(self.trace, eng.clock)
        cache_stats = {}
        if eng.manager:
            pre = eng.manager.preloader.stats
            cache_stats = {
                "hbm_hit_ratio": eng.manager.hbm.hit_ratio,
                "dram_hit_ratio": eng.manager.dram.hit_ratio,
                "ssd_bytes_read": int(eng.ssd.bytes_read
                                      * eng._file_byte_scale),
                "weight_preload_stall_s": pre.stall_s,
                "weight_overlapped_bytes": pre.overlapped_bytes,
            }
        kv_stats = kv.stats()
        prefix_stats = {}
        if self.prefix is not None:
            cur = self.prefix.stats()
            gauges = {"prefix_nodes", "prefix_cached_tokens"}
            prefix_stats = {k: v if k in gauges else v - prefix0.get(k, 0)
                            for k, v in cur.items()}
            prefix_stats["prefix_hit_rate"] = \
                prefix_stats["prefix_hit_tokens"] \
                / max(prefix_stats["prefix_lookup_tokens"], 1)
            prefix_stats["prefix_online_saves"] = self.prefix_online_saves
        return ServingReport(
            requests=finished, modeled_span_s=span,
            total_tokens=total_tokens, decode_steps=decode_steps,
            preemptions=preemptions, kv_stats=kv_stats,
            cache_stats=cache_stats, carbon=carbon,
            policy=self.policy.name, prefill_chunks=prefill_chunks,
            mid_prefill_preemptions=mid_prefill_preemptions,
            jit_dispatches=jit_dispatches,
            stall_s=stall_s + kv_stats["kv_stall_s"],
            overlapped_bytes=overlapped
            + kv_stats["kv_prefetch_overlap_bytes"],
            prefill_steps=prefill_steps,
            prefill_dispatches=prefill_dispatches,
            prefix_stats=prefix_stats,
            failed=failed, recoveries=recoveries,
            fault_stats=self.faults.stats()
            if self.faults is not None else {})
