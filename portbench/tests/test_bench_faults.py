"""A run with its timed path broken underneath: the harness's look for a
card skipped, the rest of the run driven on the CPU at a small size, and
``correct`` comes out false for each fault the cell can have (a step that
leaves its state unchanged, the set taken from half the batch, the
segment's slots skipped by attention, a token altered where it is
produced); a sound run comes out true."""
import pytest

import bench_faults as faults
import bench_tiny as tiny
from portbench.harness import main as M
from portbench.harness import spec as SP
from bench_tiny import TINY

BENCH = SP.benchmark()
CELLS = {"decode": "qwen14b-decode-192x32k",
         "prefill": "mistral123b-prefill-512-4k"}


def run(kind: str, fault=None, seed=31):
    cfg = tiny.config(ffn=2048)
    traffic = tiny.decode_traffic(sessions=8) if kind == "decode" else \
        tiny.prefill_traffic()
    checks = tiny.checks(kind)
    metrics = SP.metrics_of(BENCH, CELLS[kind], False)
    if fault is None:
        return M.drive(cfg, traffic, checks, metrics, seed, 3.0, False,
                       "cpu", 0.0)
    with faults.FAULTS[fault](traffic) as hooks:
        return M.drive(cfg, traffic, checks, metrics, seed, 3.0, False,
                       "cpu", 0.0, hooks=hooks)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_sound_run_is_correct(kind):
    res = run(kind)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind,fault", [(k, f) for k in ("decode", "prefill")
                                        for f in faults.OF_KIND[k]])
def test_fault_is_not_correct(kind, fault):
    res = run(kind, fault)
    assert not res["correct"], res["checks"]
