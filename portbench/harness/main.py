"""One run of one cell: set-up, the measured window, the comparison with the
reference, the metrics, and the result line.

``drive`` takes the cell's parts as data, so that the tests can hand it a
small configuration on the CPU; ``run.py`` looks for the card first.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench.cost import peaks as PK
from portbench.harness import check as C
from portbench.harness import loops as L
from portbench.harness import program as P
from portbench.harness import readings as RD
from portbench.harness import spec as SP
from portbench.harness import trace as TRC
from portbench.harness import weights as W

#: top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _device_info(device, chips: int) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _peaks(device) -> Optional[Dict]:
    if torch.device(device).type != "cuda":
        return None
    return PK.of(torch.cuda.get_device_name(0))


def compare(kind: str, runner, win: L.Window, cfg: Dict, traffic: Dict,
            checks: Dict, seed: int, device, control: bool = False
            ) -> Dict[str, Dict]:
    """Free the program's state, then hold the window's sample to the
    reference (``harness.check.compare``): {"fp32": {"numbers",
    "kv_by_layer"}} of the program and, with ``control``, "fp8" of the
    reference computed in float8 in its place."""
    if kind == "decode":
        picked = C.sample_steps(win.items, checks["sample"],
                                checks["logit_steps"], seed)
        last = win.items[picked[-1]]["pos"]
        seg = runner.segment_kv(last)
        base = traffic["reset_to"]
        logits = dict(win.held)
        cases = []
        for i in picked:
            it = win.items[i]
            at = it["pos"] - base
            B = it["rows"]
            lg = logits.get(i)
            cases.append(C.Case(
                torch.as_tensor(it["tokens_in"]),
                torch.full((B,), it["pos"], dtype=torch.int64), True,
                {w: seg[w][:, :, at] for w in ("k", "v")}, win.sets[i],
                lg, None if lg is None else torch.arange(B),
                None if lg is None else torch.as_tensor(it["tokens_out"])))
        win.held = win.sets = None
        ctx = C.Context(cfg, traffic, seed, device, seg)
    else:
        cases = []
        for i, it in enumerate(win.items):
            if i not in runner.sampled:
                continue
            ids = torch.as_tensor(runner.prompt(i))
            S = ids.shape[0]
            logits = it.pop("logits")
            n = logits.shape[0]
            # the served token at the last position; elsewhere the token
            # the logits put first
            served = logits.argmax(dim=-1).cpu()
            served[-1] = it["served"]
            cases.append(C.Case(ids, torch.arange(S), False, it.pop("kv"),
                                it.pop("sets"), logits,
                                torch.arange(S - n, S), served))
        ctx = None
    runner.free()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return C.compare(cfg, seed, device, cases, ctx, control)


def setup(cfg: Dict, traffic: Dict, checks: Dict, seed: int, device,
          warm: bool = True):
    """The cell's program ready for its window: params and state built,
    and (``warm``) every shape of the window warmed up."""
    mc = P.model_config(cfg)
    runner = L.KINDS[traffic["kind"]](mc, cfg, traffic, checks, seed, device,
                                      W.served_dtype(cfg))
    if warm:
        runner.warm()
    return runner


def drive(cfg: Dict, traffic: Dict, checks: Dict, metrics: List[Dict],
          seed: int, seconds: float, trace: bool, device, t_start: float,
          chips: int = 1, hooks: Optional[Dict] = None) -> Dict:
    """A whole run; returns the result line's object. ``hooks`` (tests
    only) plant a fault in the timed path: "step" or "request", called
    with (item index, logits, token) and returning the token served."""
    hooks = hooks or {}
    kind = traffic["kind"]
    runner = setup(cfg, traffic, checks, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    hook = {"step_hook": hooks.get("step")} if kind == "decode" else {
        "request_hook": hooks.get("request")}
    win = runner.window(seconds, trace, **hook)
    _sync(device)
    dev = _device_info(device, chips)
    tr = None
    if "device" in win.sessions:
        tr = TRC.Trace(win.sessions["device"], win.sessions.get("host"))
    run = RD.Run(kind, cfg, traffic, win, tr, setup_s, _peaks(device))
    values = {}
    for m in metrics:
        v = SP.reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    attempted = sum(it["rows"] for it in win.items)
    numbers = compare(kind, runner, win, cfg, traffic, checks, seed,
                      device)["fp32"]["numbers"]
    limits = checks["limits"]
    served_ok = all(_in_vocab(it, cfg["vocab"]) for it in win.items)
    result = {"correct": bool(served_ok and C.verdict(numbers, limits)),
              "attempted": attempted, "failed": 0, "metrics": values,
              "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {n: {"value": numbers.get(n), "limit": lim}
                        for n, lim in limits.items()}
    return result


def _in_vocab(item: Dict, vocab: int) -> bool:
    toks = item["tokens_out"] if "tokens_out" in item else [item["served"]]
    return all(0 <= int(t) < vocab for t in toks)
