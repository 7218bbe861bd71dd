"""Acceptance metrics for lossy serving optimisations (``repro/eval``).

``divergence`` quantifies how far a quantized-KV run drifts from its
full-precision reference — the gate that replaces byte-identity once
mixed-precision tiers are on.
"""
from repro_torch.eval.divergence import (DivergenceReport, compare_logits,
                                         first_divergence,
                                         kv_divergence_probe, topk_overlap)

__all__ = ["DivergenceReport", "compare_logits", "first_divergence",
           "kv_divergence_probe", "topk_overlap"]
