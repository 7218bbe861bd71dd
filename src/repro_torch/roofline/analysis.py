"""Roofline terms of one step on the H100 (``repro/roofline/analysis.py``).

Three terms per (arch x shape x mesh), from :mod:`op_cost`'s per-device
counts:

    compute term    = FLOPs / peak FLOP/s         (the step's type's peak)
    memory term     = bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

The counts are per device already (the op-level trace sees each device's
local shards), so global = per-device x chips. Collective bytes weight an
all-reduce x2 (ring: reduce-scatter + all-gather), the standard wire-byte
approximation; replica-group size corrections ((n-1)/n) are <= 1 and
omitted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.hw import H100_SXM

#: the peak the compute term of an fp32 step divides by: every fp32 product
#: of the port runs with TF32 off (a bf16 step's: ``flops_bf16``)
COMPUTE_PEAK = "flops_fp32"

_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "broadcast": 1.0}


@dataclasses.dataclass
class RooflineTerms:
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_flops_ratio: float
    collectives: Dict[str, dict]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def roofline(cost: dict, *, chips: int, model_flops: float,
             hw=H100_SXM, peak: str = COMPUTE_PEAK) -> RooflineTerms:
    """``cost``: :func:`op_cost.analyze`'s dict (per device); ``peak``:
    the field of ``hw`` the compute term divides by."""
    flops_dev = float(cost["flops"])
    bytes_dev = float(cost["bytes"])
    colls = cost["collectives"]
    coll_dev = float(sum(_WEIGHT[k] * v["bytes"] for k, v in colls.items()))

    compute_s = flops_dev / getattr(hw, peak)
    memory_s = bytes_dev / hw.hbm_bw
    collective_s = coll_dev / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops_dev * chips
    return RooflineTerms(
        chips=chips, flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_dev,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_flops_ratio=(model_flops / total_flops
                            if total_flops else 0.0),
        collectives=colls)


def model_flops_for(cfg, shape) -> float:
    """Analytic 'useful' FLOPs for one step of this (arch, shape).

    train: 6·N_active·tokens (fwd+bwd); prefill: 2·N_active·tokens;
    decode: 2·N_active·batch (one token per sequence).
    """
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
