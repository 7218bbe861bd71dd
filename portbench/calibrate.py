"""Readings the comparison's limits are set from (``checks/<workload>.json``):
for each seed, the cell set up at its own size, a short window long enough
to serve every sampled step or request, then the numbers the run compares,
of the program ("program") and of the reference computed in float8 in the
program's place ("control"), in one process. With ``--fault`` the window
runs with one of ``tests/bench_faults.py``'s faults planted underneath;
``--draw`` and ``--traffic`` change the configuration's draws or the
traffic mix's numbers (``key=value``) for a look at other data.

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 13 \
        [--steps 48] [--no-control] [--fault <name>] \
        [--draw v_gain=1] [--traffic history_k_std=3]

Prints one JSON line a seed. The benchmark's runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "portbench/tests")]

import torch  # noqa: E402

from portbench.harness import main as M  # noqa: E402
from portbench.harness import spec as SP  # noqa: E402


def readings(cfg, traffic, checks, seed, steps, device, control=True,
             fault=None):
    """{"program": numbers, "control": numbers, ...} of one seed."""
    import bench_faults
    runner = M.setup(cfg, traffic, checks, seed, device, warm=False)
    kind = traffic["kind"]
    limit = steps if kind == "decode" else max(runner.sampled) + 1
    with bench_faults.FAULTS[fault](traffic) if fault else \
            _nothing() as hooks:
        hook = (hooks or {}).get("step" if kind == "decode" else "request")
        win = runner.window(1e9, False, hook, limit=limit)
    out = M.compare(kind, runner, win, cfg, traffic, checks, seed, device,
                    control)
    res = {"seed": seed, "items": len(win.items),
           "program": out["fp32"]["numbers"],
           "program_kv_by_layer": out["fp32"]["kv_by_layer"]}
    if control:
        res["control"] = out["fp8"]["numbers"]
        res["control_kv_by_layer"] = out["fp8"]["kv_by_layer"]
    if fault:
        res["fault"] = fault
    return res


def _numbers(pairs):
    return {k: float(v) for k, v in (p.split("=", 1) for p in pairs)}


class _nothing:
    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=48,
                    help="decode steps of the window")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--draw", nargs="*", default=[])
    ap.add_argument("--traffic", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    bench = SP.benchmark()
    cell = SP.cell(bench, args.workload)
    cfg, traffic = SP.config(bench, cell["config"]), SP.traffic(cell["traffic"])
    checks = SP.checks(cell["name"])
    cfg["draw"] = dict(cfg["draw"], **_numbers(args.draw))
    traffic.update(_numbers(args.traffic))
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = readings(cfg, traffic, checks, seed, args.steps, "cuda",
                       not args.no_control, args.fault)
        res["s"] = time.perf_counter() - t0
        if args.draw or args.traffic:
            res["draw"], res["traffic"] = cfg["draw"], args.traffic
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
