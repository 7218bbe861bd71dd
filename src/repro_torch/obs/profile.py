"""Hierarchical span profiler over the TraceRecorder stream.

Rolls a trace — live :class:`~repro_torch.obs.trace.TraceRecorder` events or
an exported Chrome ``trace_event`` JSON — into:

* a per-track **self/total tree**: spans nest by time containment on the
  modeled clock (the recorder's stack discipline guarantees a span's
  children lie inside it), each node carrying total time, self time
  (total minus children) and a call count;
* a **collapsed-stack export** (``track;outer;inner <self-µs>`` lines) —
  the flamegraph interchange format speedscope / inferno consume;
* **per-dispatch-group cost breakdowns** from the scheduler's ``engine``
  dispatch spans: kernel-launch vs HBM weight-read vs compute vs load
  vs weight stall, keyed ``phase/b<batch>``;
* **top-N hottest requests** from the per-request ``req:<rid>`` phase
  tracks (busy = prefill + decode, parked/queued reported separately).

Everything here is read-only over normalized event dicts
(``{"kind", "track", "name", "t", "dur", "args"}``) so the same code
serves the in-process path (:func:`events_from_recorder`) and the
offline ``scripts/perf_report.py`` path (:func:`events_from_chrome`).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

_EPS = 1e-9          # containment slack for float-rounded span edges


# ---------------------------------------------------------------------------
# normalized-event adapters

def events_from_recorder(recorder) -> List[dict]:
    """Normalize a live :class:`TraceRecorder`'s ring into event dicts."""
    return [{"kind": ev.kind, "track": ev.track, "name": ev.name,
             "t": ev.t, "dur": ev.dur, "args": dict(ev.args or {})}
            for ev in recorder.events()]


def events_from_chrome(doc) -> List[dict]:
    """Normalize a Chrome ``trace_event`` document (the dict
    ``TraceRecorder.export_chrome`` writes, or its ``traceEvents``
    list) back into event dicts; µs timestamps become modeled seconds
    and ``tid``s resolve to track names via the ``M`` metadata."""
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    tracks: Dict[int, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tracks[ev["tid"]] = ev["args"]["name"]
    out: List[dict] = []
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("X", "i", "C"):
            continue
        track = tracks.get(ev.get("tid"), str(ev.get("tid")))
        args = dict(ev.get("args") or {})
        args.pop("wall_s", None)
        kind = {"X": "span", "i": "instant", "C": "counter"}[ph]
        out.append({"kind": kind, "track": track, "name": ev["name"],
                    "t": ev["ts"] / 1e6,
                    "dur": ev.get("dur", 0.0) / 1e6 if ph == "X" else 0.0,
                    "args": args})
    return out


# ---------------------------------------------------------------------------
# self/total span tree

def _new_node(name: str) -> dict:
    return {"name": name, "total_s": 0.0, "self_s": 0.0, "count": 0,
            "children": {}}


def build_tree(events: Iterable[dict]) -> Dict[str, dict]:
    """Per-track span tree: ``{track: root_node}`` where every node is
    ``{name, total_s, self_s, count, children}``. Spans nest by time
    containment; self time is total minus the children's totals."""
    by_track: Dict[str, List[dict]] = {}
    for ev in events:
        if ev["kind"] == "span":
            by_track.setdefault(ev["track"], []).append(ev)
    roots: Dict[str, dict] = {}
    for track, spans in by_track.items():
        spans.sort(key=lambda s: (s["t"], -s["dur"]))
        root = roots.setdefault(track, _new_node(track))
        root["count"] = 1
        # stack of (node, t_end) — a span nests under the innermost
        # enclosing open span
        stack: List[tuple] = []
        for s in spans:
            t0, t1 = s["t"], s["t"] + s["dur"]
            while stack and t0 > stack[-1][1] + _EPS:
                stack.pop()
            parent = stack[-1][0] if stack else root
            node = parent["children"].setdefault(s["name"],
                                                 _new_node(s["name"]))
            node["total_s"] += s["dur"]
            node["count"] += 1
            if stack and t1 <= stack[-1][1] + _EPS:
                pass
            stack.append((node, t1))
        _fill_self(root)
        root["total_s"] = sum(c["total_s"]
                              for c in root["children"].values())
        root["self_s"] = 0.0
    return roots


def _fill_self(node: dict) -> None:
    child_total = 0.0
    for child in node["children"].values():
        _fill_self(child)
        child_total += child["total_s"]
    node["self_s"] = max(node["total_s"] - child_total, 0.0)


def collapsed_stacks(tree: Dict[str, dict]) -> List[str]:
    """Flamegraph collapsed-stack lines (``a;b;c <self-µs>``), one per
    tree node with nonzero self time; the track name is the root frame."""
    lines: List[str] = []

    def walk(node: dict, path: List[str]) -> None:
        here = path + [node["name"]]
        us = int(round(node["self_s"] * 1e6))
        if us > 0:
            lines.append(";".join(here) + f" {us}")
        for name in sorted(node["children"]):
            walk(node["children"][name], here)

    for track in sorted(tree):
        for name in sorted(tree[track]["children"]):
            walk(tree[track]["children"][name], [track])
    return lines


def write_collapsed(tree: Dict[str, dict], path: str) -> int:
    """Write the collapsed-stack profile; returns the line count."""
    lines = collapsed_stacks(tree)
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)


# ---------------------------------------------------------------------------
# dispatch groups + hottest requests

def dispatch_groups(events: Iterable[dict]) -> Dict[str, dict]:
    """Aggregate the scheduler's ``engine``/``dispatch`` spans by
    ``phase/b<batch>``: count, span total, and the cost-term sums the
    manager priced (compute vs HBM weight-read vs neuron loads vs
    kernel launch vs weight-stream stall)."""
    out: Dict[str, dict] = {}
    for ev in events:
        if ev["kind"] != "span" or ev["track"] != "engine" \
                or ev["name"] != "dispatch":
            continue
        a = ev["args"]
        key = f"{a.get('phase', '?')}/b{int(a.get('batch', 0))}"
        g = out.setdefault(key, {
            "dispatches": 0, "total_s": 0.0, "compute_s": 0.0,
            "hbm_load_s": 0.0, "hbm_read_s": 0.0,
            "kernel_launch_s": 0.0, "weight_stall_s": 0.0})
        g["dispatches"] += 1
        g["total_s"] += ev["dur"]
        g["compute_s"] += float(a.get("compute_s", 0.0))
        g["hbm_load_s"] += float(a.get("hbm_load_s", 0.0))
        g["hbm_read_s"] += float(a.get("hbm_read_s", 0.0))
        g["kernel_launch_s"] += float(a.get("kernel_launch_s", 0.0))
        g["weight_stall_s"] += float(a.get("stall_s", 0.0))
    return out


def hottest_requests(events: Iterable[dict], n: int = 10) -> List[dict]:
    """Top-``n`` requests by busy time (non-queued, non-parked span
    seconds on their ``req:<rid>`` track), with the per-phase split."""
    per_rid: Dict[str, dict] = {}
    for ev in events:
        if ev["kind"] != "span" or not ev["track"].startswith("req:"):
            continue
        rid = ev["track"].split(":", 1)[1]
        rec = per_rid.setdefault(rid, {"rid": rid, "busy_s": 0.0,
                                       "queued_s": 0.0, "parked_s": 0.0,
                                       "phases": {}})
        ph = rec["phases"]
        ph[ev["name"]] = ph.get(ev["name"], 0.0) + ev["dur"]
        if ev["name"] == "queued":
            rec["queued_s"] += ev["dur"]
        elif ev["name"] == "preempted":
            rec["parked_s"] += ev["dur"]
        else:
            rec["busy_s"] += ev["dur"]
    ranked = sorted(per_rid.values(),
                    key=lambda r: (-r["busy_s"], r["rid"]))
    return ranked[:n]


def profile_summary(events: List[dict], *, top: int = 10,
                    collapsed_path: Optional[str] = None) -> dict:
    """One-call profile: tree stats, dispatch groups, hottest requests
    (and optionally the collapsed-stack file)."""
    tree = build_tree(events)
    out = {
        "tracks": {
            track: {"total_s": node["total_s"],
                    "spans": sum(c["count"]
                                 for c in node["children"].values())}
            for track, node in sorted(tree.items())},
        "dispatch_groups": dispatch_groups(events),
        "hottest_requests": hottest_requests(events, n=top),
    }
    if collapsed_path:
        out["collapsed_lines"] = write_collapsed(tree, collapsed_path)
    return out
