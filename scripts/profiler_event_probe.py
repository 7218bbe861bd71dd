#!/usr/bin/env python3
"""How many kernel events a torch.profiler session keeps, on one GPU:

    python3 scripts/profiler_event_probe.py [--sessions 25]

Each session profiles five calls of one-kernel ``flash_decode`` at
chip_smoke.py's serve row (B = 4, 145 slots, qwen2.5-14b's heads), once
with nothing before the calls and once behind chip_smoke.py's sentinel
spin kernels (``open_session``), first in a fresh process and then after
compiled flex_attention (Inductor) has run in it. Prints one JSON line: the
card's name and power limit and, for each case, how many sessions kept how
many of the five kernel events, and the kernel order of each kind of
session ("S" a sentinel, "f" a flash_decode). Imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 5


def session(fn, sentinels: bool) -> str:
    """One profiler session of REPS calls of ``fn``: the kernels' order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if sentinels:
            cs.open_session()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return "".join("S" if cs.SENTINEL_NAME in e.name else "f"
                   for e in kernels)


def cases(fn, n: int) -> dict:
    out = {}
    for name, sentinels in (("bare", False), ("sentinels", True)):
        orders = [session(fn, sentinels) for _ in range(n)]
        kept = collections.Counter(o.count("f") for o in orders)
        out[name] = {"sessions_by_events_kept": dict(sorted(kept.items())),
                     "orders": sorted(set(orders))}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=25)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    from repro_torch.kernels.flash_decode import flash_decode
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    S, lengths = cs.DECODE_ROWS["flash_decode"]
    q, kc, vc, slots, ln = cs.decode_inputs(randn, dev, S, 8, 5, 128,
                                            lengths, holes=True)
    fd = lambda: flash_decode(q, kc, vc, slots, ln)
    out = {"nvidia_smi": cs.nvidia_smi(), "calls_per_session": REPS,
           "fresh_process": cases(fd, args.sessions)}
    qf, kf, vf = randn(1, 40, 128, 128), randn(1, 8, 128, 128), \
        randn(1, 8, 128, 128)
    flex = cs.flex_softcap(qf, kf, vf, 30.0, cs.MASK_MODS["causal"](None))
    flex()
    torch.cuda.synchronize()
    out["after_inductor"] = cases(fd, args.sessions)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
