"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(kernels built or loaded from ``build/kernels``, weights drawn from the
seed on the card, warm-up), a measured window of ``--seconds``, then the
comparison with the plain reference that decides ``correct``. The last
line of standard output is the result as one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, a device trace of part of the window read for them.
The numbers compared, each beside its limit, close standard error and
the result line. Exits non-zero, printing no result, without a CUDA card
(or fewer than the cell asks for), or where JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from portbench.harness import main as M  # noqa: E402
from portbench.harness import spec as SP  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = parse(argv)
    bench = SP.benchmark()
    cell = SP.cell(bench, args.workload)
    if not torch.cuda.is_available():
        return fail("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"the cell needs {cell['chips']} card(s), "
                    f"{torch.cuda.device_count()} present")
    torch.cuda.set_device(0)
    trace = bool(args.trace)
    result = M.drive(SP.config(bench, cell["config"]),
                     SP.traffic(cell["traffic"]), SP.checks(cell["name"]),
                     SP.metrics_of(bench, cell["name"], trace), args.seed,
                     args.seconds, trace, "cuda", T_START,
                     chips=cell["chips"])
    found = M.forbidden_modules()
    if found:
        return fail("modules of JAX or the JAX package were loaded: "
                    + ", ".join(found))
    emit(result)
    return 0


def emit(result: dict):
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
