"""The dry run's per-device FLOPs and argument bytes against the
reference's own count: every tiny config x ``test_torch_dryrun.SMALL``'s
four shapes x dense and m2, on a 2 x 4 mesh of placeholder devices and on
one device, both at bf16 (the reference's default).

The reference compiles each step for the same mesh of placeholder CPU
devices (``repro/launch/steps.build_case``) and counts its partitioned
HLO's dots (``repro/roofline/hlo_cost.analyze``), in one subprocess a test
file, started when the file's first case asks and read as its lines come;
the port traces each step in-process (``launch/dryrun.run_one``). The port
gets its placements where GSPMD puts the reference's, never a counter
that differs: each count must equal the reference's, but for the gaps of
``KEPT_GAPS``. On a mismatch the message lists the port's largest products
by op and local shapes and the reference's largest dots.

The test files split the configs so that xdist (``--dist loadfile``)
spreads them: one reference process and its compiles a file."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M

from test_torch_dryrun import SMALL

#: mesh name -> (shape, axis names)
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
VARIANTS = ("dense", "m2")

#: (arch, shape) -> the largest relative gap allowed, (reference - port) /
#: reference, on either mesh, where the port counts less than the
#: reference's HLO and the missing work is no product the port runs.
#: mamba2-370m's train step, 0.14256 % low on both meshes (393,216 of
#: 275,841,024 FLOPs on one device, 49,152 of 34,480,128 on 2 x 4): in the
#: SSD's backward XLA forms as dots the sums that the port's autograd runs
#: as products and reductions (C B^T's gradient summed over the heads, the
#: decays' gradients over the head dim), and its einsum order leaves out
#: one chunk-state product of the port's (states and Y_off on a one-chunk
#: train step)
KEPT_GAPS = {("mamba2-370m", "train_4k"): 0.0015}

#: the reference's count of one tiny step: argv mesh rows and columns, then
#: arch:shape:variant per step; one JSON line each
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, re, jax
    from repro.configs import base
    from repro.launch.steps import build_case
    from repro.roofline import hlo_cost
    for name, seq, batch, kind in json.loads(sys.argv[1]):
        base.INPUT_SHAPES[name] = base.InputShape(name, seq, batch, kind)
    meshes = {}
    for key in sys.argv[2:]:
        mesh_name, arch, shape, variant = key.split(":")
        if mesh_name not in meshes:
            rows, cols = map(int, mesh_name.split("x"))
            meshes[mesh_name] = jax.make_mesh(
                (rows, cols), ("data", "model"),
                axis_types=(jax.sharding.AxisType.Auto,) * 2)
        mesh = meshes[mesh_name]
        case = build_case(arch, shape, mesh, tiny=True, variant=variant)
        with mesh:
            compiled = jax.jit(case.fn, in_shardings=case.in_shardings,
                               out_shardings=case.out_shardings,
                               donate_argnums=case.donate_argnums).lower(
                                   *case.args).compile()
        hlo = compiled.as_text()
        dots = sorted({m.group(1) for m in re.finditer(
            r"=\\s+(\\S+\\[[\\d,]*\\])\\S*\\s+dot\\(", hlo)})
        print(json.dumps({
            "key": key, "flops": hlo_cost.analyze(hlo)["flops"],
            "arg_bytes": compiled.memory_analysis().argument_size_in_bytes,
            "dots": dots[:12]}), flush=True)
""")


def cases(archs):
    """Every (arch, shape, variant, mesh) of ``archs``, as pytest params."""
    return [pytest.param(a, s, v, m, id=f"{a}-{s}-{v}-{m}")
            for a in archs for s in SMALL for v in VARIANTS for m in MESHES]


def _key(arch, shape, variant, mesh):
    return f"{mesh}:{arch}:{shape}:{variant}"


class Reference:
    """The reference's counts of ``archs``' steps, from one subprocess
    that compiles them in :func:`cases`' order."""

    def __init__(self, archs):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
                   JAX_PLATFORMS="cpu")
        shapes = json.dumps([[s.name, s.seq_len, s.global_batch, s.kind]
                             for s in SMALL.values()])
        keys = [_key(*p.values) for p in cases(archs)]
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, shapes, *keys],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=root)
        self.seen = {}

    def count(self, key) -> dict:
        while key not in self.seen:
            line = self.proc.stdout.readline()
            if not line:
                self.proc.wait(timeout=60)
                raise RuntimeError("the reference stopped before " + key
                                   + ":\n" + self.proc.stderr.read()[-3000:])
            rec = json.loads(line)
            self.seen[rec["key"]] = rec
        return self.seen[key]

    def close(self):
        self.proc.kill()
        self.proc.wait(timeout=60)
        self.proc.stdout.close()
        self.proc.stderr.close()


def arg_gap(arch, shape, variant) -> int:
    """The reference's argument bytes a device less the port's, at bf16
    (``memory_analysis().argument_size_in_bytes`` against ``run_one``'s
    ``argument_gb``), where they differ, with the causes: 4 for a decode
    step, the cache's position, an int32 argument in the reference and a
    host int in the port; less the bytes of an MoE layer's predictor
    (``pred_A``, ``pred_B``, replicated) for the m2 variant's serving
    steps (training runs the dense FFN and has none), leaves the
    step never reads, which the reference's ``jax.jit`` drops from its
    arguments (``keep_unused=False``). Every other combination's bytes are
    equal."""
    import math
    from repro_torch.models import transformer as T
    cfg = D.get_config(arch, tiny=True)
    kind = SMALL[shape].kind
    gap = 4 if kind == "decode" else 0
    if variant == "m2" and cfg.num_experts and kind != "train":
        specs = T.model_param_specs(cfg, dtype=torch.bfloat16, m2=True)
        gap -= sum(math.prod(shape_) * dt.itemsize
                   for layer in specs["layers"]
                   for name, (shape_, dt, _) in layer.get("ffn", {}).items()
                   if name.startswith("pred_"))
    return gap


def check(reference, arch, shape, variant, mesh):
    """The port's ``run_one`` count against the reference's, both at bf16
    (the reference's default): FLOPs equal but for ``KEPT_GAPS``, argument
    bytes equal but for :func:`arg_gap`."""
    dm = M.make_placeholder_mesh(*MESHES[mesh])
    try:
        rec = D.run_one(arch, shape, mesh=dm, variant=variant, tiny=True,
                        verbose=False, dtype=torch.bfloat16)
    finally:
        M.release_mesh()
    assert rec["status"] == "ok"
    port = rec["roofline"]["flops_per_device"]
    want = reference.count(_key(arch, shape, variant, mesh))
    args = rec["memory"]["argument_gb"] * 2 ** 30
    assert want["arg_bytes"] - args == arg_gap(arch, shape, variant), (
        f"{arch} {shape} {variant} on {mesh}: arguments {args:,.0f} bytes "
        f"a device, the reference's {want['arg_bytes']:,}")
    gap = KEPT_GAPS.get((arch, shape))
    ok = (port == want["flops"] if gap is None
          else 0 <= (want["flops"] - port) / want["flops"] <= gap)
    if not ok:
        dm = M.make_placeholder_mesh(*MESHES[mesh])
        try:
            by_op = D.trip_weighted_cost(arch, shape, dm, dict(
                variant=variant), tiny=True)["flops_by_op"]
        finally:
            M.release_mesh()
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
        pytest.fail(
            f"{arch} {shape} {variant} on {mesh}: port {port:,.0f} FLOPs a "
            f"device, reference {want['flops']:,.0f} "
            f"({port / want['flops']:.4f} x)\nport, largest by op and local "
            f"shapes:\n" + "\n".join(f"  {n:,.0f} {k}" for k, n in top)
            + "\nreference's dot result shapes:\n  "
            + "\n  ".join(want["dots"]))
