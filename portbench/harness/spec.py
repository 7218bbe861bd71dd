"""What a run reads, found by the names in ``BENCHMARK.json``: the cell,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its comparison's sample and limits
(``checks/<workload>.json``) and its metrics' readers
(``metrics/<metric>.py``)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: Dict, workload: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def plain(raw: Dict, name: str) -> Dict:
    """A configuration file's model as the harness and the reference take
    it."""
    heads = raw["num_attention_heads"]
    assumed = raw.get("assumed", {})
    m2 = raw["m2cache"]
    return {
        "name": name,
        "layers": raw["num_hidden_layers"], "d": raw["hidden_size"],
        "heads": heads, "kv_heads": raw["num_key_value_heads"],
        "head_dim": raw.get("head_dim") or assumed.get("head_dim")
        or raw["hidden_size"] // heads,
        "ffn": raw["intermediate_size"], "vocab": raw["vocab_size"],
        "rope_theta": float(raw["rope_theta"]), "act": raw["hidden_act"],
        "qkv_bias": bool(raw.get("qkv_bias", assumed.get("qkv_bias",
                                                         False))),
        "dtype": raw["torch_dtype"],
        "m2": {k: m2[k] for k in ("active_ratio", "ratio_fp", "ratio_int8",
                                  "ratio_int4", "predictor_rank")},
        "draw": raw["draw"],
    }


def config(bench: Dict, name: str) -> Dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return plain(load_json(ROOT / entry["file"]), name)


def traffic(name: str) -> Dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def checks(workload: str) -> Dict:
    return load_json(BENCH / "checks" / f"{workload}.json")


def metrics_of(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list it, and those without a list whose end-to-end
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
