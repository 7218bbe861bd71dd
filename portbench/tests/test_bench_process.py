"""A run's process: it loads nothing of JAX or of the JAX package, and its
last line holds the contract's keys only, the numbers compared last."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

DRIVE = """
import sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src", {root!r} + "/portbench/tests"]
t0 = time.perf_counter()
import run as R
import bench_tiny as tiny
from portbench.harness import main as M, spec as SP
bench = SP.benchmark()
wl = {wl!r}
cfg = tiny.config(bench["workloads"][[w["name"] for w in bench["workloads"]].index(wl)]["config"])
traffic = tiny.{kind}_traffic()
res = M.drive(cfg, traffic, SP.checks(wl), SP.metrics_of(bench, wl, False),
              2**31 + 9, 0.0, False, "cpu", t0)
print("FORBIDDEN", M.forbidden_modules(), file=sys.stderr)
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}), file=sys.stderr)
R.emit(res)
"""

CELLS = [("qwen14b-decode-192x32k", "decode"),
         ("mistral123b-prefill-512-4k", "prefill")]


@pytest.fixture(scope="module", params=CELLS, ids=[c[0] for c in CELLS])
def ran(request):
    wl, kind = request.param
    code = DRIVE.format(root=str(ROOT), wl=wl, kind=kind)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT / "portbench"), timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p


def test_no_jax_and_no_jax_package(ran):
    err = ran.stderr.splitlines()
    assert "FORBIDDEN []" in err
    top = [ln for ln in err if ln.startswith("TOP ")][0]
    names = eval(top[4:])
    assert "repro_torch" in names
    assert not {"jax", "jaxlib", "flax", "repro"} & set(names)


def test_last_line_has_the_contract_keys_only(ran):
    last = json.loads(ran.stdout.strip().splitlines()[-1])
    assert set(last) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert {"correct", "attempted", "failed", "metrics", "device",
            "checks"} <= set(last)
    assert list(last)[-1] == "checks"
    assert isinstance(last["correct"], bool)
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(last["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    err = ran.stderr.strip().splitlines()
    tail = err[-len(last["checks"]):]
    for line, (name, c) in zip(tail, last["checks"].items()):
        assert line.startswith(f"check {name} ") and "limit" in line
