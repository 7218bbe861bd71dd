"""The control: the reference computed in float8 in the program's place
comes out not correct, while the program passes, at small sizes on the
CPU. (On the card, at the cells' own sizes, ``calibrate.py`` reads both;
``PERF.md`` gives the readings the limits were set from.)"""
import pytest

import bench_tiny as tiny
from bench_tiny import TINY
from portbench.harness import check as C
from portbench.harness import main as M

SEEDS = (21, 22, 23)


def readings(kind: str, seed: int):
    cfg = tiny.config(ffn=2048)
    traffic = tiny.decode_traffic(sessions=8) if kind == "decode" else \
        tiny.prefill_traffic()
    checks = tiny.checks(kind, False)
    runner = M.setup(cfg, traffic, checks, seed, "cpu")
    win = runner.window(600.0, False, limit=8)
    out = M.compare(kind, runner, win, cfg, traffic, checks, seed, "cpu",
                    control=True)
    return {p: o["numbers"] for p, o in out.items()}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_program_passes_and_control_fails(kind, seed):
    got = readings(kind, seed)
    assert C.verdict(got["fp32"], TINY[kind]), got["fp32"]
    assert not C.verdict(got["fp8"], TINY[kind]), got["fp8"]
