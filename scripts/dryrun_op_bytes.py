#!/usr/bin/env python3
"""Where one dry-run combination's bytes go, op by op, under this
process's torch (no GPU needed):

    PYTHONPATH=src python3 scripts/dryrun_op_bytes.py \\
        [--arch qwen2.5-14b] [--shape prefill_32k] [--mesh single|2x4]
        [--variant dense|m2] [--tiny]

Traces the step as ``launch/dryrun.run_one`` does (trip-count weighted,
fake tensors on placeholder ranks) and prints one JSON line: the torch
version, the methods of DTensor's ``ShardingPropagator``, the counts of
``roofline/op_cost.py`` (flops, bytes, ops, the DTensor ops it let through
and the ops of DTensor's sharding propagation it left out), every op's
bytes, and the FLOPs of every op and its local input shapes, largest
first. Run it under two torch versions to find the ops whose counts
differ. ``--tiny`` traces the tiny config at the shapes of
``launch/dryrun.TINY_SHAPES`` and ``--mesh 2x4`` on a 2 x 4 mesh of
placeholder ranks, as the CPU parity tests of the counts do
(``tests/_torch_dryrun_parity.py``), so that a gap they find splits by op
in seconds. Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--mesh", default="single",
                    choices=["host", "single", "multi", "2x4"])
    ap.add_argument("--variant", default="dense")
    ap.add_argument("--tiny", action="store_true")
    a = ap.parse_args(argv)
    import torch
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    if a.tiny:
        INPUT_SHAPES.update(D.TINY_SHAPES)
    meshes = dict(D.MESHES, **{"2x4": ((2, 4), ("data", "model"))})
    dm = M.make_placeholder_mesh(*meshes[a.mesh])
    t0 = time.time()
    try:
        cost = D.trip_weighted_cost(a.arch, a.shape, dm,
                                    dict(variant=a.variant), tiny=a.tiny)
    finally:
        M.release_mesh()
    print(json.dumps({
        "torch": torch.__version__, "arch": a.arch, "shape": a.shape,
        "mesh": a.mesh, "variant": a.variant, "tiny": a.tiny,
        "trace_s": time.time() - t0,
        "propagator_methods": sorted(
            n for n in dir(ShardingPropagator) if "propagat" in n),
        **{k: cost[k] for k in ("flops", "bytes", "ops", "dtensor_ops",
                                "propagation_ops", "collectives")},
        "bytes_by_op": dict(sorted(cost["bytes_by_op"].items(),
                                   key=lambda kv: -kv[1])),
        "flops_by_op": dict(sorted(cost["flops_by_op"].items(),
                                   key=lambda kv: -kv[1])),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
