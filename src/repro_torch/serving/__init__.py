"""Multi-request serving subsystem (``repro/serving``): continuous
batching over the M2Cache hierarchy, with per-request KV state paged across
HBM→DRAM→SSD, chunked + batched prefill, radix-tree prefix caching (KV
reuse across requests, paged over the same tiers) and pluggable FCFS /
SLO-aware / carbon-aware scheduling policies, and a fleet layer
(``cluster.py``): replicas + prefix-aware router + carbon-driven
autoscaling."""
from repro_torch.serving.cluster import (ROUTER_POLICIES, CarbonAutoscaler,
                                         ClusterReport, ClusterRouter,
                                         Replica, ReplicaTraceView,
                                         ShadowRadixIndex, make_cluster,
                                         shifted_trace)
from repro_torch.serving.kv_cache import TieredKVCache
from repro_torch.serving.policy import (CarbonAwarePolicy, FCFSPolicy,
                                        SchedulingPolicy, SLOAwarePolicy,
                                        make_policy)
from repro_torch.serving.prefix_cache import MatchResult, PrefixCache, RadixNode
from repro_torch.serving.request import (SLO_CLASSES, RequestState, ServingRequest,
                                         SLOSpec)
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, FCFSScheduler,
                                           Request, RequestQueue, ServingReport)
from repro_torch.serving.schema import (CLUSTER_SUMMARY_OPTIONAL,
                                        CLUSTER_SUMMARY_REQUIRED,
                                        SUMMARY_OPTIONAL, SUMMARY_REQUIRED,
                                        looks_like_cluster_summary,
                                        looks_like_summary,
                                        validate_cluster_summary,
                                        validate_summary)
from repro_torch.serving.workload import (ArrivalEvent, assign_slo_classes,
                                          bursty_trace, closed_trace,
                                          diurnal_trace, poisson_trace,
                                          requests_from_trace,
                                          shared_prefix_trace)

__all__ = [
    "ArrivalEvent", "CLUSTER_SUMMARY_OPTIONAL", "CLUSTER_SUMMARY_REQUIRED",
    "CarbonAutoscaler", "CarbonAwarePolicy", "ClusterReport",
    "ClusterRouter", "ContinuousBatchScheduler", "FCFSPolicy",
    "FCFSScheduler", "MatchResult", "PrefixCache", "ROUTER_POLICIES",
    "RadixNode", "Replica", "ReplicaTraceView", "Request", "RequestQueue",
    "RequestState", "SLOAwarePolicy", "SLOSpec", "SLO_CLASSES",
    "SUMMARY_OPTIONAL", "SUMMARY_REQUIRED", "SchedulingPolicy",
    "ServingReport", "ServingRequest", "ShadowRadixIndex", "TieredKVCache",
    "assign_slo_classes", "bursty_trace", "closed_trace", "diurnal_trace",
    "looks_like_cluster_summary", "looks_like_summary", "make_cluster",
    "make_policy", "poisson_trace", "requests_from_trace",
    "shared_prefix_trace", "shifted_trace", "validate_cluster_summary",
    "validate_summary",
]
