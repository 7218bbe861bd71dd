"""The ``ServingReport.summary()`` schema — defined once, enforced twice.

Benchmark gates (``scripts/check_bench.py``) reach into committed
``BENCH_*.json`` baselines by dotted key paths; a renamed summary key
used to silently turn a regression gate into a no-op ("missing baseline
→ skip"). This module is the single source of truth for the summary's
key set:

* ``validate_summary`` is called by :meth:`ServingReport.summary`
  itself, so any rename that is not reflected here fails every test and
  benchmark run immediately;
* ``scripts/check_bench.py`` validates every ``summary``-keyed dict in
  the committed baselines against the same schema (and treats a metric
  path missing from a baseline as an error), so a rename that *is*
  reflected here still fails CI until the baselines and metric paths
  are regenerated to match.

``SUMMARY_REQUIRED`` keys appear in every summary. ``SUMMARY_OPTIONAL``
keys appear conditionally (prefix cache attached, SLOs present);
``SUMMARY_OPTIONAL_PREFIXES`` covers the per-SLO-class family.
``CLUSTER_SUMMARY_REQUIRED``/``validate_cluster_summary`` do the same
job for ``ClusterReport.summary()`` (serving/cluster.py) — cluster
summaries are fingerprinted by ``router`` where per-replica summaries
carry ``policy``, so a walker never confuses the two.
"""
from __future__ import annotations

from typing import Dict

SUMMARY_REQUIRED = frozenset({
    "policy", "requests", "total_tokens", "modeled_span_s",
    "tokens_per_s", "p50_latency_s", "p99_latency_s", "p50_ttft_s",
    "p99_ttft_s", "decode_steps", "preemptions", "gco2_per_request",
    "gco2_total", "jit_dispatches_per_step",
    "prefill_dispatches_per_step", "stall_s", "overlapped_bytes",
    "mean_intensity_g_kwh",
})

SUMMARY_OPTIONAL = frozenset({
    # prefix cache attached
    "prefix_hit_rate", "prefix_hit_tokens",
    # requests carried SLOs (ServingReport.slo_summary)
    "slo_requests", "slo_attainment", "ttft_attainment",
    "tpot_attainment", "deadline_attainment",
    # mixed-precision KV tiers on (kv_precision with a quantized tier)
    "kv_transfer_saved_bytes", "kv_ssd_capacity_stretch",
    # fault injection attached or requests failed (docs/RELIABILITY.md)
    "faults_injected", "failed_requests", "recovered_requests",
    "recoveries_total", "gco2_recovery_total",
})

#: key families whose suffix is data-dependent (one per SLO class)
SUMMARY_OPTIONAL_PREFIXES = ("slo_attainment_",)

#: the ClusterReport.summary() schema (serving/cluster.py). Cluster
#: summaries carry ``router`` — deliberately NOT ``policy`` — so the
#: :func:`looks_like_summary` fingerprint never mistakes one for a
#: per-replica summary when validators walk a BENCH artifact.
CLUSTER_SUMMARY_REQUIRED = frozenset({
    "router", "replicas", "requests", "total_tokens", "modeled_span_s",
    "tokens_per_s", "gco2_total", "gco2_per_request",
    "cluster_prefix_hit_rate", "affinity_routed", "balanced_routed",
    "drains", "mean_intensity_g_kwh",
})

CLUSTER_SUMMARY_OPTIONAL = frozenset({
    # requests carried SLOs (ClusterReport.slo_summary)
    "slo_requests", "slo_attainment", "ttft_attainment",
    "tpot_attainment", "deadline_attainment",
    # any replica reported clean structured failures
    "failed_requests",
})


def validate_summary(summary: Dict, *, context: str = "summary") -> Dict:
    """Raise ``ValueError`` on key drift; returns ``summary`` unchanged.

    Drift = a required key missing, or a key present that the schema
    does not know (neither required, optional, nor an allowed-prefix
    family member)."""
    keys = set(summary)
    missing = SUMMARY_REQUIRED - keys
    unknown = {k for k in keys - SUMMARY_REQUIRED - SUMMARY_OPTIONAL
               if not k.startswith(SUMMARY_OPTIONAL_PREFIXES)}
    problems = []
    if missing:
        problems.append(f"missing required keys {sorted(missing)}")
    if unknown:
        problems.append(f"unknown keys {sorted(unknown)} "
                        "(update repro_torch/serving/schema.py)")
    if problems:
        raise ValueError(f"{context}: summary schema drift: "
                         + "; ".join(problems))
    return summary


def looks_like_summary(doc: Dict) -> bool:
    """Cheap fingerprint check used by validators walking arbitrary
    JSON: a dict carrying these keys claims to be a serving summary."""
    return isinstance(doc, dict) and "tokens_per_s" in doc \
        and "policy" in doc


def validate_cluster_summary(summary: Dict, *,
                             context: str = "cluster summary") -> Dict:
    """:func:`validate_summary`'s twin for ``ClusterReport.summary()``:
    raise ``ValueError`` on key drift, return ``summary`` unchanged."""
    keys = set(summary)
    missing = CLUSTER_SUMMARY_REQUIRED - keys
    unknown = {k for k in keys - CLUSTER_SUMMARY_REQUIRED
               - CLUSTER_SUMMARY_OPTIONAL
               if not k.startswith(SUMMARY_OPTIONAL_PREFIXES)}
    problems = []
    if missing:
        problems.append(f"missing required keys {sorted(missing)}")
    if unknown:
        problems.append(f"unknown keys {sorted(unknown)} "
                        "(update repro_torch/serving/schema.py)")
    if problems:
        raise ValueError(f"{context}: cluster summary schema drift: "
                         + "; ".join(problems))
    return summary


def looks_like_cluster_summary(doc: Dict) -> bool:
    """Fingerprint for cluster summaries: ``router`` where per-replica
    summaries carry ``policy``."""
    return isinstance(doc, dict) and "tokens_per_s" in doc \
        and "router" in doc
