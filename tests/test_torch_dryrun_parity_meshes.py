"""The dry run's per-device FLOPs of one-row steps against the reference's
own count, at full size, on a grid of "data" x "model" meshes of
placeholder devices: where GSPMD splits a one-row step's heads over an idle
"data" axis (``models/common.idle_data``) and where it contracts a
remainder layer's predictor whole (``core/mp_ffn.mp_ffn_apply``'s
``place``).

The reference compiles each step for the same mesh of placeholder CPU
devices and counts its partitioned HLO's dots (``repro/roofline/
hlo_cost.analyze``), all in one subprocess started by the module's first
case and read as its lines come (a full-size one-row step compiles in
about a second); the port traces each step in-process
(``launch/dryrun.run_one``). Every count must be equal."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M

#: "data" x "model" meshes: "data" 2 to 16 with "model" 4 and 16, where
#: the rules' edges lie for both head counts below
GRID = [(2, 4), (4, 4), (8, 4), (16, 4), (4, 16), (8, 16), (16, 16)]
#: (arch, variant, meshes): qwen2.5-14b (40 query heads over 8 kv heads;
#: "model" 8 too) and mamba2-370m (32 SSD heads) on the grid; qwen2.5-14b's
#: m2 step (the same attention, the M2Cache FFN) where its split begins;
#: mistral-large-123b (96 over 8: its groups split too) and recurrentgemma-
#: 2b's m2 step (10 over 1; two remainder layers) where their rules' edges
#: lie; both m2 steps also on 2 x 1, where "model" is one device and
#: GSPMD runs the M2Cache FFN's products on the idle "data" dim
#: (``models/common.model_idle_data``)
STEPS = [("qwen2.5-14b", "dense", GRID + [(2, 8), (8, 8)]),
         ("qwen2.5-14b", "m2", [(2, 1), (2, 4), (4, 4), (16, 16)]),
         ("mamba2-370m", "dense", GRID),
         ("mistral-large-123b", "dense", [(8, 16), (16, 16)]),
         ("recurrentgemma-2b", "m2", [(2, 1), (2, 4), (4, 16), (16, 16)])]
SHAPE = "long_500k"

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    import json, jax
    from repro.launch.steps import build_case
    from repro.roofline import hlo_cost
    for key in sys.argv[1:]:
        arch, variant, rows, cols = key.split(":")
        mesh = jax.make_mesh((int(rows), int(cols)), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        case = build_case(arch, "long_500k", mesh, variant=variant)
        with mesh:
            hlo = jax.jit(case.fn, in_shardings=case.in_shardings,
                          out_shardings=case.out_shardings,
                          donate_argnums=case.donate_argnums).lower(
                              *case.args).compile().as_text()
        flops = hlo_cost.analyze(hlo)["flops"]
        print(json.dumps({"key": key, "flops": flops}), flush=True)
""")


def _key(arch, variant, mesh):
    return f"{arch}:{variant}:{mesh[0]}:{mesh[1]}"


CASES = [pytest.param(a, v, m, id=f"{a}-{v}-{m[0]}x{m[1]}")
         for a, v, meshes in STEPS for m in meshes]


@pytest.fixture(scope="module")
def reference():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu")
    keys = [_key(*p.values) for p in CASES]
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, *keys],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=root)
    seen = {}

    def count(key):
        while key not in seen:
            line = proc.stdout.readline()
            if not line:
                proc.wait(timeout=60)
                raise RuntimeError("the reference stopped before " + key +
                                   ":\n" + proc.stderr.read()[-3000:])
            rec = json.loads(line)
            seen[rec["key"]] = rec["flops"]
        return seen[key]
    yield count
    proc.kill()
    proc.communicate(timeout=60)


@pytest.mark.parametrize("arch,variant,mesh", CASES)
def test_one_row_step_counts_what_the_reference_counts(reference, arch,
                                                       variant, mesh):
    dm = M.make_placeholder_mesh(mesh, ("data", "model"))
    try:
        rec = D.run_one(arch, SHAPE, mesh=dm, variant=variant, verbose=False)
    finally:
        M.release_mesh()
    assert rec["status"] == "ok"
    port = rec["roofline"]["flops_per_device"]
    want = reference(_key(arch, variant, mesh))
    assert port == want, (f"{arch} {variant} on {mesh[0]} x {mesh[1]}: port "
                          f"{port:,.0f}, reference {want:,.0f} "
                          f"({port / want:.4f} x)")
