"""Dry run: trace every (arch x input shape x mesh) step, count its cost
per device and write one JSON per combination (resumable)
(``repro/launch/dryrun.py``).

The reference lowers and compiles each step for 256 or 512 placeholder TPU
devices and reads XLA's memory and cost analyses. Here the step's
arguments become DTensors on a ``DeviceMesh`` of placeholder ranks,
distributed by ``build_case``'s ``in_shardings``, and the step runs once
under ``FakeTensorMode`` (nothing is allocated or computed) inside
``implicit_replication()`` (a tensor the step makes is replicated);
``roofline/op_cost.py`` counts the local ops and collectives of one
device. The tensors are fake CPU tensors, so ``kernels/ops.py`` takes its
plain versions, as the reference's dry run lowers its plain jnp model; each
kernel call is counted at its boundary, and the layers are trip-count
weighted (:func:`trip_weighted_cost`). Mesh "host" is the port's target,
one card (1 x 1: its arguments stay plain fake tensors); "single" and
"multi" are the reference's 16 x 16 and 2 x 16 x 16.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      [--arch all|<id>] [--shape all|<name>] [--mesh host|single|multi|both]
      [--variant dense|m2] [--dtype bf16|fp32] [--out build/dryrun]
      [--no-fsdp] ...

The CLI counts the reference's dtype, bf16, by default (its records are of
the same step as the reference's); ``--dtype fp32`` counts the fp32 step.
The FLOPs are the same at both.

Each record keeps the reference's keys, with ``trace_s`` for its
``lower_s``/``compile_s`` and ``hw`` for the card the terms are priced on
(with ``compute_peak``, the peak the compute term divides by: the bf16
tensor peak for a bf16 step, the fp32 one for an fp32 step).
Its memory: ``argument_gb``/``output_gb`` the local bytes of the
arguments and outputs; ``alias_gb`` the donated arguments the step writes
in place and returns; ``temp_gb`` the most bytes the step's own tensors
held at once beyond its outputs. That is eager PyTorch's peak, op by op,
not XLA's, which fuses and reuses buffers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_flatten

from repro_torch import sharding as SH
from repro_torch.configs.base import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                      InputShape, get_config)
from repro_torch.core.hw import H100_SXM
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import build_case
from repro_torch.models.transformer import pattern_split
from repro_torch.roofline import op_cost
from repro_torch.roofline.analysis import (COMPUTE_PEAK, model_flops_for,
                                           roofline)

#: --dtype -> the step's dtype
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
#: mesh name -> (shape, axis names)
MESHES = {"host": ((1, 1), ("data", "model")),
          "single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

#: INPUT_SHAPES cut for the tiny configs (batches divisible by data = 2 of
#: a 2 x 4 mesh)
TINY_SHAPES = {"train_4k": InputShape("train_4k", 32, 4, "train"),
               "prefill_32k": InputShape("prefill_32k", 64, 4, "prefill"),
               "decode_32k": InputShape("decode_32k", 64, 4, "decode"),
               "long_500k": InputShape("long_500k", 96, 1, "decode")}


def _distribute(arg, spec, policy):
    """``arg`` (a tree of meta tensors) as fake DTensors placed by ``spec``
    (a tree of PartitionSpecs); on a mesh of one device, where every
    placement is the whole tensor, as plain fake tensors (DTensor would
    only add its dispatch); a non-tensor leaf (the cache's ``pos``) stays
    as it is."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(arg, dict):
        return {k: _distribute(v, spec[k], policy) for k, v in arg.items()}
    if isinstance(arg, tuple) and hasattr(arg, "_fields"):
        return type(arg)(*(_distribute(a, s, policy)
                           for a, s in zip(arg, spec)))
    if isinstance(arg, (list, tuple)):
        return [_distribute(a, s, policy) for a, s in zip(arg, spec)]
    if not isinstance(arg, torch.Tensor):
        return arg
    with op_cost.fake_mode():
        full = torch.empty(arg.shape, dtype=arg.dtype)
        if policy.mesh.size() == 1:     # one device: its block is the whole
            return full
        t = distribute_tensor(full, policy.mesh, policy.placements(spec),
                              src_data_rank=None)
    assert tuple(t.to_local().shape) == policy.local_shape(arg.shape, spec)
    return t


def _local_bytes(tree) -> int:
    return sum(op_cost._nbytes(t) for t in op_cost._tensors(tree))


def _keys(tree) -> set:
    return {op_cost._storage_key(t).cdata for t in op_cost._tensors(tree)}


def _trace(arch, shape_name, dm, num_layers, kw) -> dict:
    """The step of ``arch`` cut to ``num_layers`` (None: its own depth),
    its args distributed over ``dm``, counted under ``FakeTensorMode``."""
    from torch.distributed.tensor.experimental import implicit_replication
    case = build_case(arch, shape_name, dm, num_layers=num_layers, **kw)
    args = tuple(_distribute(a, s, case.policy)
                 for a, s in zip(case.args, case.in_shardings))
    with implicit_replication():
        cost = op_cost.analyze(case.fn, *args)
    out = op_cost._tensors(cost.pop("out"))
    donated = _keys([args[i] for i in case.donate_argnums])
    cost["out_bytes"] = _local_bytes(out)
    cost["alias_bytes"] = sum(op_cost._nbytes(t) for t in out
                              if op_cost._storage_key(t).cdata in donated)
    return cost


def _extrapolate(c1, c2, reps: int):
    """``c1 + reps x (c2 - c1)`` over every count of two traces."""
    if isinstance(c1, dict):
        return {k: _extrapolate(c1.get(k, 0), c2.get(k, 0), reps)
                for k in set(c1) | set(c2)}
    return c1 + reps * (c2 - c1)


def trip_weighted_cost(arch, shape_name, dm, kw, *, tiny=False) -> dict:
    """The step's counts, trip-count weighted as hlo_cost.py weights the
    reference's layer scan: the layers of one pattern repeat run the same
    ops on the same local shapes, so the step is traced with one repeat
    and with two (each with the remainder layers), and every count is the
    first plus the difference times the repeats beyond it. A config of at
    most two repeats is traced whole."""
    pat, F, rem = pattern_split(get_config(arch, tiny=tiny))
    kw = dict(kw, tiny=tiny)
    if F <= 2:
        return _trace(arch, shape_name, dm, None, kw)
    n = len(pat)
    c1 = _trace(arch, shape_name, dm, n + rem, kw)
    c2 = _trace(arch, shape_name, dm, 2 * n + rem, kw)
    return _extrapolate(c1, c2, F - 1)


def run_one(arch: str, shape_name: str, *, mesh="host",
            variant: str = "dense", fsdp: bool = True,
            pod_fsdp: bool = False, shard_kv_seq=None,
            expert_data_shard: bool = False, kv_quant: bool = False,
            tiny: bool = False, verbose: bool = True,
            dtype=torch.float32) -> dict:
    """One combination's record, counted by :func:`trip_weighted_cost`.
    ``mesh``: a name of :data:`MESHES` (its placeholder mesh is made and
    torn down here) or a ``DeviceMesh`` the caller made. ``dtype``: the
    step's (``build_case``'s); the CLI passes bf16 unless asked."""
    own = isinstance(mesh, str)
    name = mesh
    if own:
        dm = M.make_placeholder_mesh(*MESHES[mesh])
    else:
        dm, name = mesh, "x".join(map(str, mesh.shape))
    kw = dict(variant=variant, fsdp=fsdp, pod_fsdp=pod_fsdp,
              shard_kv_seq=shard_kv_seq, expert_data_shard=expert_data_shard,
              kv_quant=kv_quant, dtype=dtype)
    try:
        cfg = get_config(arch, tiny=tiny)
        shape = INPUT_SHAPES[shape_name]
        t0 = time.time()
        case = build_case(arch, shape_name, dm, tiny=tiny, **kw)
        cost = trip_weighted_cost(arch, shape_name, dm, kw, tiny=tiny)
        t_trace = time.time() - t0
    finally:
        if own:
            M.release_mesh()
    chips = int(dm.size())
    peak = "flops_bf16" if dtype == torch.bfloat16 else COMPUTE_PEAK
    terms = roofline(cost, chips=chips,
                     model_flops=model_flops_for(cfg, shape), peak=peak)
    leaves = tree_flatten(case.args)[0]
    specs = op_cost._tensors(case.in_shardings, keep=SH.PartitionSpec)
    assert len(leaves) == len(specs)
    arg_b = sum(math.prod(case.policy.local_shape(tuple(t.shape), s))
                * t.element_size() for t, s in zip(leaves, specs)
                if isinstance(t, torch.Tensor))
    out_b, alias_b = cost["out_bytes"], cost["alias_bytes"]
    temp_b = max(cost["peak_bytes"] - (out_b - alias_b), 0)
    gb = 2 ** 30
    rec = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": "x".join(map(str, dm.shape)), "chips": chips,
        "fsdp": fsdp, "pod_fsdp": pod_fsdp,
        "expert_data_shard": expert_data_shard,
        "kv_quant": kv_quant,
        "meta": case.meta,
        "status": "ok",
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_gb": arg_b / gb, "output_gb": out_b / gb,
            "temp_gb": temp_b / gb, "alias_gb": alias_b / gb,
            "per_device_gb": (arg_b + out_b + temp_b - alias_b) / gb,
        },
        "cost": {"flops": cost["flops"], "bytes accessed": cost["bytes"],
                 "bytes_by_op": dict(sorted(
                     cost["bytes_by_op"].items(), key=lambda kv: -kv[1])[:12]),
                 "ops": cost["ops"]},
        "roofline": terms.to_json(),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "hw": {**dataclasses.asdict(H100_SXM), "compute_peak": peak},
    }
    if verbose:
        m = rec["memory"]
        print(f"[ok] {arch} × {shape_name} × {name} ({variant}) "
              f"trace={t_trace:.1f}s mem/dev={m['per_device_gb']:.2f}GiB "
              f"bottleneck={terms.bottleneck} "
              f"(c={terms.compute_s*1e3:.1f}ms m={terms.memory_s*1e3:.1f}ms "
              f"coll={terms.collective_s*1e3:.1f}ms)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["host", "single", "multi", "both"])
    ap.add_argument("--variant", default="dense", choices=["dense", "m2"])
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--pod-fsdp", action="store_true")
    ap.add_argument("--expert-data-shard", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for mesh_tag in meshes:
        for arch in archs:
            for shape in shapes:
                fname = os.path.join(
                    args.out,
                    f"{arch}__{shape}__{mesh_tag}__{args.variant}"
                    f"{'' if args.dtype == 'bf16' else '__' + args.dtype}"
                    f"{args.tag}.json")
                if os.path.exists(fname) and not args.force:
                    print(f"[skip] {fname}", flush=True)
                    continue
                try:
                    rec = run_one(arch, shape, mesh=mesh_tag,
                                  variant=args.variant,
                                  fsdp=not args.no_fsdp,
                                  pod_fsdp=args.pod_fsdp,
                                  expert_data_shard=args.expert_data_shard,
                                  kv_quant=args.kv_quant,
                                  dtype=DTYPES[args.dtype])
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "x".join(map(str, MESHES[mesh_tag][0])),
                           "variant": args.variant, "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {arch} × {shape} × {mesh_tag}: "
                          f"{type(e).__name__}: {str(e)[:300]}", flush=True)
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"done; failures={failures}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
