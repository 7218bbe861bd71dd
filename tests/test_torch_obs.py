"""The port's observability layer (``repro_torch.obs``) against the
reference's, on the CPU.

One server run of each package on the tiny SHARED traffic with every
output on (trace, metrics with periodic snapshots, block trace, ledger,
health with a rule file): each artifact equals the reference's field for
field (the Chrome trace without the host-clock ``wall_s``), and so does the
printed JSON, ledger residues included. Inside the port: every request has
its queued, prefill and decode spans, the ledger rebuilt from the trace
alone equals the live one, the block trace reads back, and the outputs
leave the tokens as they are. Then each obs module against its reference
on the same calls."""
import json
from pathlib import Path

import pytest

import repro.obs as jax_obs
import repro_torch.obs as obs
from _torch_tiny import (SHARED, as_json, reference_cli, strip_wall,
                         tiny_model, tokens)
from repro_torch.launch import server

#: files of a run, by output flag
OUTPUTS = {"--trace-out": "run.trace.json", "--metrics-out": "run.prom",
           "--block-trace-out": "run.blocks.jsonl",
           "--ledger": "run.ledger.json", "--health-out": "run.alerts.jsonl"}
#: rules that fire on this traffic, beside the built-in set
EXTRA_RULES = [
    {"name": "hits_low", "metric": "serving_prefix_hit_rate", "op": "<",
     "threshold": 0.9, "mode": "value"},
    {"name": "ttft_p50", "metric": "serving_ttft_seconds", "op": ">",
     "threshold": 0.0, "mode": "p50", "for_s": 0.01},
    {"name": "finish_rate", "metric": "serving_requests_finished_total",
     "op": ">", "threshold": 0.0, "mode": "rate", "window_s": 0.5},
]


def _argv(d: Path):
    rules = d / "rules.json"
    rules.write_text(json.dumps({"rules": [
        r.to_dict() for r in obs.default_rules()] + EXTRA_RULES}))
    argv = list(SHARED) + ["--metrics-interval", "0.05",
                           "--alert-rules", str(rules)]
    for flag, name in OUTPUTS.items():
        argv += [flag, str(d / name)]
    return argv


@pytest.fixture(scope="module")
def model():
    return tiny_model()


@pytest.fixture(scope="module")
def runs(model, tmp_path_factory):
    """(reference dir, its output, port dir, port output, port report)."""
    _, jp, cfg, tp = model
    jdir, tdir = (tmp_path_factory.mktemp(n) for n in ("jax", "torch"))
    theirs, _ = reference_cli(_argv(jdir), jp)
    out, rep, _, _ = server.run(server.parse_args(_argv(tdir)
                                                  + ["--device", "cpu"]),
                                cfg=cfg, params=tp)
    return jdir, theirs, tdir, as_json(out), rep


def _read(path: Path):
    if path.suffix == ".jsonl":
        return [json.loads(line) for line in path.read_text().splitlines()]
    if path.name.endswith(".trace.json"):
        return strip_wall(json.loads(path.read_text()))
    if path.suffix == ".json":
        return json.loads(path.read_text())
    return path.read_text()


@pytest.mark.parametrize("name", sorted(OUTPUTS.values())
                         + ["run.prom.jsonl"])
def test_artifact_equals_reference(runs, name):
    jdir, _, tdir, _, _ = runs
    ours, theirs = _read(tdir / name), _read(jdir / name)
    assert ours == theirs
    assert ours                       # the run wrote something


def test_output_json_equals_reference(runs):
    _, theirs, _, ours, _ = runs
    assert set(ours) == {"summary", "kv", "cache", "prefix", "persist",
                         "carbon_g", "obs", "ledger", "health"}
    assert ours == theirs
    assert ours["ledger"]["conserved"]
    assert ours["obs"]["trace_events"] > 0 and ours["obs"]["block_events"] > 0
    # the extra rules fired: a non-trivial alert stream was compared
    assert ours["health"]["alerts"] >= 3


def test_outputs_leave_the_tokens(model, runs):
    _, _, cfg, tp = model
    _, _, _, on, rep = runs
    off, rep_off, _, _ = server.run(server.parse_args(SHARED + ["--device",
                                                                "cpu"]),
                                    cfg=cfg, params=tp)
    assert tokens(rep) == tokens(rep_off)
    assert as_json(off)["summary"] == on["summary"]


def test_trace_spans_ledger_and_block_trace(runs):
    _, _, tdir, _, rep = runs
    doc = json.loads((tdir / "run.trace.json").read_text())
    events = obs.events_from_chrome(doc)
    spans = {}
    for ev in events:
        if ev["kind"] == "span" and ev["track"].startswith("req:"):
            spans.setdefault(ev["track"], set()).add(ev["name"])
    assert sorted(spans) == sorted(f"req:{r.rid}" for r in rep.requests)
    assert all({"queued", "prefill", "decode"} <= s for s in spans.values())
    live = json.loads((tdir / "run.ledger.json").read_text())
    back = obs.reconstruct(events).summary()
    for key in ("time_s", "gco2_g", "span_s", "horizon_s", "gco2_total_g",
                "residues", "conserved"):
        assert back[key] == live[key], key
    recs = [json.loads(line) for line in
            (tdir / "run.blocks.jsonl").read_text().splitlines()]
    read = [e.to_record() for e in obs.read_block_trace(
        tdir / "run.blocks.jsonl")]
    assert read == recs[1:] and recs[0]["events"] == len(read) > 0


# --- each module on the same calls ------------------------------------------


def _trace(pkg, tmp):
    clock = [0.0]
    tr = pkg.TraceRecorder(capacity=6)
    tr.set_default_clock(lambda: clock[0])
    sid = tr.span_begin("req0", "queued", rid=0)
    clock[0] = 0.25
    tr.span_end(sid, tokens=3)
    tr.span("sched", "decode_step", 0.25, 0.5, rows=2)
    for i in range(5):
        tr.instant("kv", "evict", t=0.5 + i, bid=i)
        tr.counter("carbon", "gco2", t=0.5 + i, g=0.1 * i)
    tr.span_begin("req1", "prefill")
    return (strip_wall(tr.to_chrome()), tr.stats(), tr.open_spans(),
            [e.name for e in tr.events()])


def _metrics(pkg, tmp):
    reg = pkg.MetricsRegistry()
    reg.counter("req_total", "requests").inc(2, cls="batch")
    reg.counter("req_total").inc(cls="interactive")
    g = reg.gauge("kv_bytes", "bytes")
    g.set(10.0, tier="hbm")
    g.inc(5.0, tier="hbm")
    g.dec(1.0, tier="dram")
    h = reg.histogram("ttft_seconds", "ttft", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.7, 20.0):
        h.observe(v, cls="batch")
    snap = pkg.PeriodicSnapshotter(reg, tmp / "m.jsonl", interval_s=0.5)
    for now in (0.0, 0.2, 0.6, 3.1, 3.2, 4.0):
        reg.counter("req_total").inc(cls="batch")
        snap.tick(now)
    snap.close(4.5)
    return (reg.to_prometheus(), reg.snapshot(5.0),
            (tmp / "m.jsonl").read_text(), snap.snapshots, snap.dropped)


def _block_trace(pkg, tmp):
    col = pkg.BlockTraceCollector(capacity=4)
    for i, op in enumerate(("alloc", "touch", "pin", "unpin", "free")):
        col.emit(0.1 * i, op, bid=i % 2, rid=0, tier="hbm", nbytes=16384,
                 tok0=16 * i)
    col.export_jsonl(tmp / "b.jsonl")
    return (col.stats(), len(col), [e.to_record() for e in col.events()],
            (tmp / "b.jsonl").read_text(),
            [e.to_record() for e in pkg.read_block_trace(tmp / "b.jsonl")])


def _ledger(pkg, tmp):
    led = pkg.TimeLedger()
    led.bill("decode_compute/b2", 0.5)
    led.bill("prefill_compute/b1", 0.25)
    led.bill("idle", 1.0)
    led.bill_g("decode_compute/b2", 0.003)
    led.bill_g("idle", 0.001)
    led.close(span_s=1.75, horizon_s=2.0, gco2_total_g=0.0041)
    tr = pkg.TraceRecorder()
    led.emit(tr, 2.0)
    back = pkg.reconstruct(pkg.events_from_recorder(tr))
    led.export(tmp / "l.json")
    return (led.summary(), led.check(), back.summary(),
            (tmp / "l.json").read_text())


def _profile(pkg, tmp, doc):
    events = pkg.events_from_chrome(doc)
    tree = pkg.build_tree(events)
    return (pkg.collapsed_stacks(tree), pkg.dispatch_groups(events),
            pkg.hottest_requests(events, n=3),
            pkg.profile_summary(events, top=3,
                                collapsed_path=str(tmp / "c.txt")),
            (tmp / "c.txt").read_text())


def _health(pkg, tmp):
    reg = pkg.MetricsRegistry()
    rules = [r.to_dict() for r in pkg.default_rules()] + EXTRA_RULES
    (tmp / "r.json").write_text(json.dumps(rules))
    mon = pkg.HealthMonitor(reg, pkg.load_rules(str(tmp / "r.json")))
    tr = pkg.TraceRecorder()
    mon.attach_trace(tr, t0=1.0)
    fin = reg.counter("serving_requests_finished_total")
    for i, now in enumerate((0.0, 0.1, 0.2, 0.4, 0.9, 2.5)):
        fin.inc()
        reg.gauge("serving_prefix_hit_rate").set(0.5 if i < 4 else 0.95)
        reg.histogram("serving_ttft_seconds").observe(0.1 * (i + 1))
        reg.gauge("kv_ssd_quarantined").set(float(i == 3))
        mon.evaluate(now)
    mon.close(3.0)
    mon.export_jsonl(str(tmp / "a.jsonl"))
    return (mon.alerts, mon.counts(), mon.active(), mon.fired("hits_low"),
            (tmp / "a.jsonl").read_text(),
            pkg.alerts_from_events(pkg.events_from_recorder(tr)))


UNITS = {"trace": _trace, "metrics": _metrics, "block_trace": _block_trace,
         "ledger": _ledger, "health": _health}


@pytest.fixture
def dirs(tmp_path):
    """One scratch directory per package."""
    out = {obs: tmp_path / "torch", jax_obs: tmp_path / "jax"}
    for d in out.values():
        d.mkdir()
    return out


@pytest.mark.parametrize("module", sorted(UNITS))
def test_module_equals_reference(module, dirs):
    got, want = (UNITS[module](pkg, dirs[pkg]) for pkg in (obs, jax_obs))
    assert got == want


def test_profile_equals_reference(runs, dirs):
    """The span profiler of each package on the reference's own trace."""
    doc = json.loads((runs[0] / "run.trace.json").read_text())
    got, want = (_profile(pkg, dirs[pkg], doc) for pkg in (obs, jax_obs))
    assert got == want
    assert got[1]                     # dispatch groups were found
