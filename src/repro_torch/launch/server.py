"""Multi-request serving launcher: continuous batching + tiered KV cache
+ pluggable scheduling policies (FCFS / SLO-aware EDF / carbon-aware), on
the card (``repro/launch/server.py``'s single-replica path).

Real tiny model on the GPU (actual decode, modeled clock):
  PYTHONPATH=src python -m repro_torch.launch.server --arch qwen2.5-14b \
      --tiny --requests 6 --rate 2.0 --max-batch 4

The same on the CPU (plain PyTorch versions of the kernels), for any
served config (qwen2.5-14b, qwen2.5-32b, command-r-35b,
mistral-large-123b, internvl2-1b, and the MoE grok-1-314b and
llama4-maverick-400b-a17b):
  PYTHONPATH=src python -m repro_torch.launch.server --arch command-r-35b \
      --tiny --device cpu --requests 4 --max-batch 2 --gen-len 4 6
  PYTHONPATH=src python -m repro_torch.launch.server --arch grok-1-314b \
      --tiny --device cpu

Radix prefix cache on chat-style shared-prefix traffic:
  PYTHONPATH=src python -m repro_torch.launch.server --arch qwen2.5-14b \
      --tiny --workload shared-prefix --prefix-cache --prefix-reuse 0.7 \
      --turns 2 --requests 8 --prefill-chunk 8 --prefill-bucket 8

Paper-scale analytic mode (modeled clock, Poisson arrivals):
  PYTHONPATH=src python -m repro_torch.launch.server \
      --paper-model llama-7b --requests 16 --rate 4.0 --max-batch 8

Every observability output of a run (docs/OBSERVABILITY.md):
  PYTHONPATH=src python -m repro_torch.launch.server --arch qwen2.5-14b \
      --tiny --requests 6 --trace-out run.trace.json --metrics-out run.prom \
      --block-trace-out run.blocks.jsonl --ledger run.ledger.json \
      --health-out run.alerts.jsonl

Fleet-scale: N replicas behind the prefix-aware cluster router, each with
its own engine, scheduler, tiered cache and radix tree; every replica
computes on the one card, and ``--replica-devices`` names the carbon
model's *modeled* accelerators (docs/CLUSTER.md):
  PYTHONPATH=src python -m repro_torch.launch.server \
      --paper-model llama-7b --replicas 3 --router prefix \
      --workload diurnal --requests 24 --carbon-trace diurnal \
      --autoscale --grid-shift spread
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from repro_torch import resolve_device
from repro_torch.configs.base import SERVED
from repro_torch.core.carbon import CarbonIntensityTrace
from repro_torch.core.engine import PAPER_MODELS, M2CacheEngine
from repro_torch.serving import (ROUTER_POLICIES, CarbonAutoscaler,
                                 ClusterRouter, ContinuousBatchScheduler,
                                 Replica, assign_slo_classes, bursty_trace,
                                 diurnal_trace, make_policy, poisson_trace,
                                 requests_from_trace, shared_prefix_trace,
                                 shifted_trace)


def build_engine(args, device_name=None, *, cfg=None, params=None,
                 ssd_dir: Optional[str] = None) -> M2CacheEngine:
    """The engine the arguments describe. ``device_name`` is the carbon
    model's modeled accelerator (``core/carbon.py``'s DEVICES, e.g.
    ``rtx3090``), not a CUDA device: the model computes on
    ``args.device``. ``cfg`` and ``params`` override the config and the
    seeded weights (the params must live on ``args.device``; engines only
    read them, so replicas may share one tree); ``ssd_dir`` keeps the SSD
    tier's bank files in a directory the caller owns."""
    device = resolve_device(args.device)
    common = dict(mode=args.mode, hbm_policy=args.hbm_policy,
                  use_ssd=not args.no_ssd, ssd_dir=ssd_dir,
                  dram_capacity_gb=args.dram_gb, seed=args.seed,
                  batched_decode=not args.no_batched_decode,
                  prefill_bucket=args.prefill_bucket)
    if device_name is not None:
        common["device_name"] = device_name
    if args.paper_model:
        return M2CacheEngine(paper_model=args.paper_model, **common)
    from repro_torch.configs.base import check_served, get_config
    from repro_torch.models import transformer as T
    cfg = cfg if cfg is not None else get_config(args.arch, tiny=args.tiny)
    check_served(cfg)
    if params is None:
        params = T.init_params(cfg, seed=args.seed, device=device)
    return M2CacheEngine(cfg=cfg, params=params, device=device, **common)


def build_trace(args):
    """``--carbon-trace``: 'constant', 'square', 'diurnal' or a CSV path
    of ``time_s,g_per_kwh`` rows on the modeled clock."""
    name = args.carbon_trace
    if name is None or name == "constant":
        return CarbonIntensityTrace.constant()
    if name == "square":
        return CarbonIntensityTrace.square()
    if name == "diurnal":
        return CarbonIntensityTrace.diurnal()
    return CarbonIntensityTrace.from_csv(name)


def parse_slo_mix(spec: str):
    """``interactive:0.5,batch:0.5`` -> {class: weight}."""
    mix = {}
    for part in spec.split(","):
        name, _, w = part.partition(":")
        mix[name.strip()] = float(w) if w else 1.0
    return mix


def build_workload(args, vocab_size=None):
    if args.workload == "bursty":
        events = bursty_trace(args.requests, burst_size=args.burst_size,
                              burst_gap_s=args.burst_gap,
                              rate_in_burst_rps=args.rate, seed=args.seed,
                              prompt_len=tuple(args.prompt_len),
                              gen_len=tuple(args.gen_len))
    elif args.workload == "shared-prefix":
        events = shared_prefix_trace(
            args.requests, rate_rps=args.rate,
            num_groups=args.prefix_groups, prefix_len=args.shared_prefix_len,
            reuse_ratio=args.prefix_reuse, turns=args.turns,
            gen_len=tuple(args.gen_len),
            vocab_size=vocab_size or 50000, seed=args.seed)
    elif args.workload == "diurnal":
        events = diurnal_trace(
            args.requests, period_s=args.period,
            num_groups=args.prefix_groups,
            prefix_len=args.shared_prefix_len,
            reuse_ratio=args.prefix_reuse, gen_len=tuple(args.gen_len),
            vocab_size=vocab_size or 50000, seed=args.seed)
    else:
        events = poisson_trace(args.requests, args.rate, seed=args.seed,
                               prompt_len=tuple(args.prompt_len),
                               gen_len=tuple(args.gen_len))
    if args.slo:
        events = assign_slo_classes(events, parse_slo_mix(args.slo),
                                    seed=args.seed)
    return events


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="a config the port serves: " + ", ".join(SERVED))
    ap.add_argument("--paper-model", default=None,
                    choices=list(PAPER_MODELS) + [None])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mode", default="m2cache",
                    choices=["m2cache", "zero_infinity"])
    ap.add_argument("--hbm-policy", default="atu",
                    choices=["atu", "lru", "none"])
    ap.add_argument("--no-ssd", action="store_true")
    ap.add_argument("--dram-gb", type=float, default=6.0)
    # fleet (docs/CLUSTER.md): >1 replicas serve behind a cluster router
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1 builds a replica fleet behind the cluster "
                         "router: each replica is its own engine + "
                         "scheduler + tiered cache + radix tree + "
                         "carbon accountant, all computing on the one "
                         "card (docs/CLUSTER.md)")
    ap.add_argument("--router", default="prefix",
                    choices=list(ROUTER_POLICIES),
                    help="cluster balancing policy: round-robin | "
                         "least-loaded | prefix (affinity to the "
                         "replica already holding the prompt's blocks) "
                         "| carbon (affinity, then the cleanest grid "
                         "slice within a load-imbalance bound)")
    ap.add_argument("--replica-devices", default=None, metavar="A,B,...",
                    help="comma list of carbon-model device names "
                         "(core/carbon.py's DEVICES), cycled across "
                         "replicas — a heterogeneous fleet of old and "
                         "new GPUs as the carbon model sees it; every "
                         "replica computes on --device (default: every "
                         "replica rtx3090)")
    ap.add_argument("--grid-shift", default=None, metavar="S0,S1,..|spread",
                    help="per-replica phase shift (modeled s) of the "
                         "periodic --carbon-trace, cycled; 'spread' "
                         "offsets replica i by i*period/N — replicas "
                         "in different grid regions, which is what the "
                         "carbon router exploits")
    ap.add_argument("--autoscale", action="store_true",
                    help="carbon-driven replica drain/park: the dirtier "
                         "the (unshifted) grid trace, the fewer "
                         "replicas accept new work; parked replicas "
                         "finish in-flight requests and bill deep-idle "
                         "power")
    ap.add_argument("--horizon", type=float, default=None, metavar="S",
                    help="bill every replica's idle base power out to "
                         "a fixed serving window (modeled s) so gCO2 "
                         "totals compare across router policies")
    # workload
    ap.add_argument("--workload", default="poisson",
                    choices=["poisson", "bursty", "shared-prefix",
                             "diurnal"])
    ap.add_argument("--period", type=float, default=240.0,
                    help="modeled seconds per day cycle (diurnal "
                         "workload; match --carbon-trace diurnal's "
                         "period)")
    ap.add_argument("--prefix-groups", type=int, default=4,
                    help="distinct shared system prompts "
                         "(shared-prefix workload)")
    ap.add_argument("--shared-prefix-len", type=int, default=64,
                    help="shared prefix tokens (shared-prefix workload)")
    ap.add_argument("--prefix-reuse", type=float, default=0.7,
                    help="fraction of conversations opening with a "
                         "shared prefix (shared-prefix workload)")
    ap.add_argument("--turns", type=int, default=1,
                    help="turns per conversation (shared-prefix workload)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate (req/s, modeled clock)")
    ap.add_argument("--burst-size", type=int, default=6)
    ap.add_argument("--burst-gap", type=float, default=30.0,
                    help="silence between bursts (s, bursty workload)")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(16, 48))
    ap.add_argument("--gen-len", type=int, nargs=2, default=(16, 32))
    ap.add_argument("--slo", default=None,
                    help="SLO class mix, e.g. interactive:0.5,batch:0.5 "
                         "(classes from serving/request.py's SLO_CLASSES)")
    # scheduler / policy / KV
    ap.add_argument("--policy", default="fcfs",
                    choices=["fcfs", "slo", "carbon"])
    ap.add_argument("--carbon-trace", default=None,
                    help="constant | square | diurnal | CSV path "
                         "(time_s,g_per_kwh)")
    ap.add_argument("--carbon-threshold", type=float, default=300.0,
                    help="gCO2/kWh at/below which deferrable work starts")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens prefix-charged per scheduler "
                         "iteration (default: whole prompt at once)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--hbm-kv-gb", type=float, default=0.5)
    ap.add_argument("--dram-kv-gb", type=float, default=1.0)
    ap.add_argument("--no-batched-decode", action="store_true",
                    help="legacy one-jit-dispatch-per-session real decode "
                         "(serially priced)")
    ap.add_argument("--no-kv-prefetch", action="store_true",
                    help="disable predictive KV promotion; every resume "
                         "pays the serial swap-in")
    ap.add_argument("--kv-precision", default=None, metavar="MAP",
                    help="per-tier KV storage precision, e.g. "
                         "'hbm:fp16,dram:int8,ssd:int4' (or the 'mixed' "
                         "shorthand for exactly that map). Demoted "
                         "blocks are stored quantized and transfer/"
                         "capacity accounting prices the packed bytes; "
                         "restored KV is no longer bit-exact (see "
                         "docs/SERVING.md for the divergence contract). "
                         "Default: fp16 everywhere")
    ap.add_argument("--no-kv-quant", action="store_true",
                    help="force fp16 on every KV tier (byte-identical "
                         "paging), overriding --kv-precision")
    ap.add_argument("--prefix-cache", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="--prefix-cache enables radix-tree KV prefix "
                         "reuse across requests (--no-prefix-cache "
                         "recomputes every prompt; the default is off "
                         "single-replica, on when --replicas > 1 — the "
                         "router's affinity exists to feed it)")
    ap.add_argument("--prefix-capacity", type=int, default=65536,
                    help="prefix-cache budget in cached tokens")
    ap.add_argument("--prefix-carbon-aware", action="store_true",
                    help="gate prefix-cache inserts on the carbon trace "
                         "(skip caching when recompute-later is greener)")
    ap.add_argument("--prefix-persist", default=None, metavar="DIR",
                    help="persist the radix tree (structure + real KV "
                         "block payloads) to DIR: loaded at startup if "
                         "present (the reloaded subtree starts flash-"
                         "resident, so a restarted server warm-starts "
                         "with a nonzero hit rate), saved at exit")
    ap.add_argument("--prefix-persist-interval", type=float, default=None,
                    metavar="S",
                    help="with --prefix-persist: also save the tree "
                         "online every S modeled seconds as an atomic "
                         "epoch (crash-consistent: a kill at any moment "
                         "leaves the latest complete epoch loadable)")
    ap.add_argument("--prefill-bucket", type=int, default=8,
                    help="max same-width prompts stacked into one vmapped "
                         "prefill dispatch (<=1: per-session prefill)")
    # fault injection / graceful degradation (docs/RELIABILITY.md)
    ap.add_argument("--fault-plan", default=None, metavar="PATH",
                    help="JSON fault plan for the seeded FaultInjector "
                         "(see benchmarks/fault_plans/): inject SSD "
                         "read/write errors, payload corruption and DMA "
                         "stalls/failures at the tier boundaries; the "
                         "server degrades and recovers instead of dying")
    ap.add_argument("--max-recoveries", type=int, default=2,
                    help="re-prefill attempts per request after a lost "
                         "KV block before it fails cleanly into the "
                         "report's failed list")
    # observability
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run "
                         "(open in Perfetto / chrome://tracing): per-"
                         "request phase spans, scheduler decisions, KV "
                         "tier events, DMA transfers, carbon counters")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write serving metrics: Prometheus text format "
                         "(.prom) plus periodic JSONL snapshots at "
                         "PATH.jsonl on the modeled clock")
    ap.add_argument("--metrics-interval", type=float, default=1.0,
                    help="modeled seconds between metric snapshots "
                         "(with --metrics-out)")
    ap.add_argument("--block-trace-out", default=None, metavar="PATH",
                    help="write the KV block-access trace (JSONL replay "
                         "format for the replacement-policy simulator)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="write the modeled-time + gCO2 conservation "
                         "ledger (*.ledger.json): every modeled second "
                         "and every operational gram attributed to one "
                         "exclusive category, with conservation residues "
                         "(docs/OBSERVABILITY.md)")
    ap.add_argument("--health-out", default=None, metavar="PATH",
                    help="evaluate serving health alert rules on the "
                         "modeled clock and write the alert transitions "
                         "as JSONL (*.alerts.jsonl)")
    ap.add_argument("--alert-rules", default=None, metavar="PATH",
                    help="JSON alert-rule file for --health-out "
                         "(default: the built-in serving rule set; "
                         "schema in docs/OBSERVABILITY.md)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the real model computes (cpu: the plain "
                         "PyTorch versions of the kernels)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse, and refuse what the reference refuses, with its messages."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.alert_rules and not args.health_out:
        ap.error("--alert-rules requires --health-out")
    # unset --prefix-cache means off single-replica, on in cluster mode
    prefix_on = (args.prefix_cache if args.prefix_cache is not None
                 else args.replicas > 1)
    if not prefix_on and (args.prefix_carbon_aware
                          or args.prefix_capacity != 65536
                          or args.prefix_persist):
        ap.error("--prefix-carbon-aware/--prefix-capacity/"
                 "--prefix-persist require --prefix-cache")
    if args.prefix_persist_interval and not args.prefix_persist:
        ap.error("--prefix-persist-interval requires --prefix-persist")
    if args.replicas > 1:
        unsupported = [f for f, v in (
            ("--fault-plan", args.fault_plan), ("--ledger", args.ledger),
            ("--health-out", args.health_out),
            ("--metrics-out", args.metrics_out),
            ("--block-trace-out", args.block_trace_out),
            ("--prefix-persist", args.prefix_persist)) if v]
        if unsupported:
            ap.error(f"{', '.join(unsupported)} not supported with "
                     "--replicas > 1 (see docs/CLUSTER.md)")
        if args.grid_shift and not build_trace(args).period_s:
            ap.error("--grid-shift needs a periodic --carbon-trace "
                     "(square or diurnal)")
    elif args.grid_shift or args.autoscale or args.replica_devices \
            or args.horizon is not None:
        ap.error("--grid-shift/--autoscale/--replica-devices/--horizon "
                 "require --replicas > 1")
    args.prefix_on = prefix_on
    return args


def build_replica(args: argparse.Namespace, name: str, device_name,
                  carbon_trace, *, trace=None, cfg=None, params=None,
                  ssd_dir: Optional[str] = None) -> Replica:
    """One replica of the fleet the arguments describe: its own engine
    (``device_name`` as for :func:`build_engine`), scheduler, tiered cache
    and radix tree, on the grid slice ``carbon_trace``; ``trace`` is the
    fleet's shared recorder."""
    eng = build_engine(args, device_name=device_name, cfg=cfg,
                       params=params, ssd_dir=ssd_dir)
    # each replica's scheduling policy reads its *own* grid slice
    policy = make_policy(args.policy, trace=carbon_trace,
                         threshold_g_kwh=args.carbon_threshold)
    return Replica(
        name, eng, carbon_trace=carbon_trace, trace=trace,
        max_batch=args.max_batch, hbm_kv_gb=args.hbm_kv_gb,
        dram_kv_gb=args.dram_kv_gb, policy=policy,
        prefill_chunk=args.prefill_chunk,
        kv_prefetch=not args.no_kv_prefetch,
        kv_precision=None if args.no_kv_quant else args.kv_precision,
        prefix_caching=args.prefix_on,
        prefix_capacity_tokens=args.prefix_capacity,
        prefix_carbon_aware=args.prefix_carbon_aware)


def run_cluster(args: argparse.Namespace, *, cfg=None, params=None,
                ssd_dir: Optional[str] = None):
    """The ``--replicas > 1`` path: N heterogeneous replicas behind the
    prefix-aware cluster router (docs/CLUSTER.md). Routing is two-phase —
    all arrivals placed in time order, then each replica's sub-trace
    served serially — so per-replica token streams are byte-identical to
    serial single-replica runs. Every replica computes on ``args.device``
    and reads the one ``params`` tree; replica ``i`` keeps its SSD bank
    files under ``ssd_dir/r<i>``. Returns (the printed dict, the router)."""
    base_trace = build_trace(args)
    n = args.replicas
    devices = args.replica_devices.split(",") \
        if args.replica_devices else [None]
    if args.grid_shift == "spread":
        shifts = [base_trace.period_s * i / n for i in range(n)]
    elif args.grid_shift:
        shifts = [float(s) for s in args.grid_shift.split(",")]
    else:
        shifts = None
    recorder = None
    if args.trace_out:
        from repro_torch.obs import TraceRecorder
        recorder = TraceRecorder()
    replicas = [build_replica(
        args, f"r{i}", devices[i % len(devices)],
        shifted_trace(base_trace, shifts[i % len(shifts)]) if shifts
        else base_trace, trace=recorder, cfg=cfg, params=params,
        ssd_dir=None if ssd_dir is None else str(Path(ssd_dir) / f"r{i}"))
        for i in range(n)]
    model_cfg = replicas[0].engine.cfg
    vocab = model_cfg.vocab_size if model_cfg is not None else None
    scaler = CarbonAutoscaler(base_trace) if args.autoscale else None
    router = ClusterRouter(replicas, policy=args.router,
                           autoscaler=scaler, trace=recorder)
    events = build_workload(args, vocab)
    report = router.run(events, vocab_size=vocab,
                        horizon_s=args.horizon)
    out = {
        "summary": report.summary(),
        "replicas": {r.name: {"summary": r.report.summary(),
                              "device": r.device_name,
                              "assigned": len(r.events),
                              "drain_windows": r.drain_windows}
                     for r in router.replicas},
        "router": {"policy": args.router,
                   "decisions": report.decisions},
    }
    if recorder is not None:
        recorder.export_chrome(args.trace_out)
        out["obs"] = recorder.stats()
    return out, router


def run(args: argparse.Namespace, *, cfg=None, params=None,
        ssd_dir: Optional[str] = None):
    """Serve the arguments' workload once on one replica, writing the
    observability outputs the arguments ask for. ``cfg``, ``params`` and
    ``ssd_dir`` as for :func:`build_engine`. Returns (the printed dict,
    the ServingReport, the engine, the scheduler)."""
    prefix_on = args.prefix_on
    eng = build_engine(args, cfg=cfg, params=params, ssd_dir=ssd_dir)
    vocab = eng.cfg.vocab_size if eng.cfg is not None else None
    trace = build_workload(args, vocab)
    reqs = requests_from_trace(trace, vocab_size=vocab, seed=args.seed)
    carbon_trace = build_trace(args)
    policy = make_policy(args.policy, trace=carbon_trace,
                         threshold_g_kwh=args.carbon_threshold)
    recorder = metrics = block_trace = snapshotter = None
    if args.trace_out:
        from repro_torch.obs import TraceRecorder
        recorder = TraceRecorder()
    if args.metrics_out:
        from repro_torch.obs import MetricsRegistry, PeriodicSnapshotter
        metrics = MetricsRegistry()
        snapshotter = PeriodicSnapshotter(
            metrics, args.metrics_out + ".jsonl",
            interval_s=args.metrics_interval)
    if args.block_trace_out:
        from repro_torch.obs import BlockTraceCollector
        block_trace = BlockTraceCollector()
    ledger = health = None
    if args.ledger:
        from repro_torch.obs import TimeLedger
        ledger = TimeLedger()
    if args.health_out:
        from repro_torch.obs import HealthMonitor, MetricsRegistry, load_rules
        if metrics is None:
            # rules read live metrics; a private registry serves when no
            # --metrics-out asked for exported ones
            metrics = MetricsRegistry()
        rules = load_rules(args.alert_rules) if args.alert_rules else None
        health = HealthMonitor(metrics, rules)
    injector = None
    if args.fault_plan:
        from repro_torch.serving.faults import FaultInjector
        injector = FaultInjector.from_plan(args.fault_plan)
    sched = ContinuousBatchScheduler(eng, max_batch=args.max_batch,
                                     hbm_kv_gb=args.hbm_kv_gb,
                                     dram_kv_gb=args.dram_kv_gb,
                                     policy=policy,
                                     prefill_chunk=args.prefill_chunk,
                                     carbon_trace=carbon_trace,
                                     kv_prefetch=not args.no_kv_prefetch,
                                     kv_precision=None if args.no_kv_quant
                                     else args.kv_precision,
                                     prefix_caching=prefix_on,
                                     prefix_capacity_tokens=
                                     args.prefix_capacity,
                                     prefix_carbon_aware=
                                     args.prefix_carbon_aware,
                                     trace=recorder, metrics=metrics,
                                     block_trace=block_trace,
                                     snapshotter=snapshotter,
                                     ledger=ledger, health=health,
                                     faults=injector,
                                     max_recoveries=args.max_recoveries,
                                     prefix_persist_dir=args.prefix_persist,
                                     prefix_persist_interval_s=
                                     args.prefix_persist_interval)
    persist = {}
    if args.prefix_persist:
        from repro_torch.serving.prefix_cache import PrefixCache
        if PrefixCache.has_save(args.prefix_persist):
            persist["loaded"] = sched.prefix.load(args.prefix_persist)
    rep = sched.run(reqs)
    if args.prefix_persist:
        persist["saved"] = sched.prefix.save(args.prefix_persist)
    obs = {}
    if recorder is not None:
        recorder.export_chrome(args.trace_out)
        obs.update(recorder.stats())
    if args.metrics_out:
        snapshotter.close(eng.clock)
        metrics.export_prometheus(args.metrics_out)
    if block_trace is not None:
        block_trace.export_jsonl(args.block_trace_out)
        obs.update(block_trace.stats())
    out = {
        "summary": rep.summary(),
        "kv": rep.kv_stats,
        "cache": rep.cache_stats,
        "prefix": rep.prefix_stats,
        "persist": persist,
        "carbon_g": rep.carbon,
    }
    if obs:
        out["obs"] = obs
    if ledger is not None:
        ledger.export(args.ledger)
        out["ledger"] = {"residues": ledger.residues(),
                         "conserved": not ledger.check(),
                         "time_by_family_s": ledger.by_family()}
    if health is not None:
        health.export_jsonl(args.health_out)
        out["health"] = {"alerts": len(health.alerts),
                         "counts": health.counts(),
                         "active": health.active()}
    if injector is not None:
        out["faults"] = injector.stats()
        out["failures"] = rep.failures()
    return out, rep, eng, sched


def main(argv=None):
    args = parse_args(argv)
    if args.replicas > 1:
        out, _ = run_cluster(args)
    else:
        out, _, _, _ = run(args)
    print(json.dumps(out, indent=1, default=float))


if __name__ == "__main__":
    main()
