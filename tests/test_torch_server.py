"""The port's server path against the reference's, end to end on the CPU:
``repro_torch.launch.server`` (ContinuousBatchScheduler → M2CacheEngine's
step API → RealModelRunner's row entry points and DecodeBatch →
``forward(mode="prefill_resume"|"decode")``) serves qwen2.5-14b tiny with
the reference's weights and gives its tokens per request, and its summary,
``kv``, ``cache``, ``prefix`` and ``carbon_g`` fields, exactly; last logits
agree within 1e-4. Invariants inside the port: batched decode equals
per-session decode, and the prefix cache on equals off, on tokens. The
parser takes every flag of the reference's and refuses what it refuses,
with the same message."""
import json
import re
import sys

import numpy as np
import pytest
import torch

from _torch_tiny import SHARED, reference_cli, tiny_model
from _torch_tiny import tokens as _tokens
from repro.core.engine import M2CacheEngine as JaxEngine
from repro.launch import server as jax_server
from repro.serving import ArrivalEvent as JaxArrival
from repro.serving import ContinuousBatchScheduler as JaxScheduler
from repro.serving import requests_from_trace as jax_requests
from repro_torch.core.engine import M2CacheEngine
from repro_torch.launch import server
from repro_torch.serving import ArrivalEvent, ContinuousBatchScheduler
from repro_torch.serving import requests_from_trace

#: closed arrivals with KV budgets tight enough to preempt and spill
TIGHT = dict(hbm_kv_gb=0.8e-4, dram_kv_gb=1.6e-5)
TIGHT_LENS = ((18, 16, 12, 19, 14, 10), (6, 10, 8, 7, 9, 6))
OUT_KEYS = ("summary", "kv", "cache", "prefix", "persist", "carbon_g")


def _last_logits(sess):
    if sess._batch is not None:
        return np.asarray(sess._batch.last[sess._row])
    return np.asarray(sess.last[0])


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def _tight_run(Engine, Scheduler, Arrival, make_requests, cfg, params,
               tmp, precision, **kw):
    eng = Engine(cfg=cfg, params=params, dram_capacity_gb=0.5,
                 ssd_dir=str(tmp), **kw)
    events = [Arrival(rid=i, arrival_s=0.0, prompt_len=p, max_new_tokens=g)
              for i, (p, g) in enumerate(zip(*TIGHT_LENS))]
    sched = Scheduler(eng, max_batch=4, kv_precision=precision, **TIGHT)
    return sched.run(make_requests(events, vocab_size=cfg.vocab_size))


@pytest.fixture(scope="module")
def reference(model, tmp_path_factory):
    """The reference's runs, once per module: its server CLI on SHARED with
    these weights, and its scheduler on the tight trace."""
    jcfg, jp, _, _ = model
    out, (rep,) = reference_cli(SHARED, jp)
    tight = {p: _tight_run(JaxEngine, JaxScheduler, JaxArrival, jax_requests,
                           jcfg, jp, tmp_path_factory.mktemp(f"jax{p}"), p)
             for p in (None, "mixed")}
    return out, rep, tight


@pytest.fixture(scope="module")
def port_shared(model):
    _, _, cfg, tp = model
    out, rep, eng, _ = server.run(server.parse_args(SHARED + ["--device",
                                                              "cpu"]),
                                  cfg=cfg, params=tp)
    return json.loads(json.dumps(out, default=float)), rep, eng


def test_server_equals_reference_server(reference, port_shared):
    theirs, jrep, _ = reference
    ours, rep, eng = port_shared
    assert set(ours) == set(theirs) == set(OUT_KEYS)
    for key in OUT_KEYS:
        assert ours[key] == theirs[key], key
    assert _tokens(rep) == _tokens(jrep)
    assert ours["summary"]["prefix_hit_tokens"] > 0
    assert eng.prefix_restored_tokens > 0          # suffix-only prefill ran
    assert eng.prefill_dispatches == jrep.prefill_dispatches > 0
    errs = [np.abs(_last_logits(a.session) - _last_logits(b.session)).max()
            for a, b in zip(sorted(rep.requests, key=lambda r: r.rid),
                            sorted(jrep.requests, key=lambda r: r.rid))]
    assert max(errs) < 1e-4


@pytest.mark.parametrize("precision", [None, "mixed"])
def test_preempted_tiers_equal_reference(model, reference, tmp_path,
                                         precision):
    """KV blocks demoted (device bytes scrubbed), spilled to SSD, quantized
    for the colder tiers and promoted back: the same tokens and stats."""
    _, _, cfg, tp = model
    want = reference[2][precision]
    rep = _tight_run(M2CacheEngine, ContinuousBatchScheduler, ArrivalEvent,
                     requests_from_trace, cfg, tp, tmp_path, precision,
                     device="cpu")
    assert rep.preemptions == want.preemptions > 0
    assert rep.kv_stats["kv_ssd_write_bytes"] > 0
    assert _tokens(rep) == _tokens(want)
    assert rep.summary() == want.summary()
    assert rep.kv_stats == want.kv_stats
    assert rep.cache_stats == want.cache_stats
    assert rep.carbon == want.carbon


def _port_tokens(model, argv):
    _, _, cfg, tp = model
    out, rep, _, _ = server.run(server.parse_args(argv + ["--device", "cpu"]),
                                cfg=cfg, params=tp)
    return out, _tokens(rep)


def test_batched_decode_equals_per_session(model):
    # every conversation arrives at once: up to 4 rows decode together
    burst = SHARED[:SHARED.index("--rate")] + ["--rate", "1e6", "--turns", "1"]
    ours, toks = _port_tokens(model, burst)
    out, serial = _port_tokens(model, burst + ["--no-batched-decode",
                                               "--prefill-bucket", "1"])
    assert serial == toks
    assert out["summary"]["jit_dispatches_per_step"] > \
        ours["summary"]["jit_dispatches_per_step"] == 1.0


def test_prefix_cache_on_equals_off(model, port_shared):
    ours, rep, _ = port_shared
    off = [a for a in SHARED if a != "--prefix-cache"]
    out, toks = _port_tokens(model, off)
    assert toks == _tokens(rep)
    assert ours["summary"]["prefix_hit_tokens"] > 0
    assert "prefix_hit_tokens" not in out["summary"]


def test_unchunked_real_prefill_equals_reference(model, tmp_path):
    """The engine's whole-prompt prefill path (stacked first-chunk prefill,
    ``_prefill_rows``), which the reference keeps for archs whose KV cannot
    be sliced per block: forced on for both engines."""
    jcfg, jp, cfg, tp = model
    reps = []
    for Engine, Scheduler, Arrival, make, c, p, kw in (
            (JaxEngine, JaxScheduler, JaxArrival, jax_requests, jcfg, jp, {}),
            (M2CacheEngine, ContinuousBatchScheduler, ArrivalEvent,
             requests_from_trace, cfg, tp, {"device": "cpu"})):
        eng = Engine(cfg=c, params=p, dram_capacity_gb=0.5,
                     ssd_dir=str(tmp_path / Engine.__module__), **kw)
        eng._chunked_real = False
        eng.supports_kv_payloads = False
        events = [Arrival(rid=i, arrival_s=0.0, prompt_len=12,
                          max_new_tokens=g) for i, g in enumerate((4, 6, 5))]
        sched = Scheduler(eng, max_batch=4, prefill_chunk=4)
        reps.append(sched.run(make(events, vocab_size=c.vocab_size)))
    assert _tokens(reps[1]) == _tokens(reps[0])
    assert reps[1].summary() == reps[0].summary()
    assert reps[1].prefill_dispatches == reps[0].prefill_dispatches == 1


def test_analytic_server_equals_reference(capsys, monkeypatch):
    argv = ["--paper-model", "llama-7b", "--requests", "3", "--rate", "3",
            "--max-batch", "2", "--gen-len", "2", "4", "--prompt-len", "8",
            "16"]
    server.main(argv + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["server"] + argv)
    jax_server.main()
    theirs = json.loads(capsys.readouterr().out)
    assert ours == theirs


#: argument lists the reference's parser refuses: the outputs and options a
#: fleet does not support, --grid-shift on an aperiodic trace, the fleet's
#: own flags on one replica, and options that need another option
REFUSED = {
    "fault_plan_fleet": ["--replicas", "2", "--fault-plan", "plan.json"],
    "ledger_fleet": ["--replicas", "2", "--ledger", "x.ledger.json"],
    "health_fleet": ["--replicas", "2", "--health-out", "x.alerts.jsonl"],
    "metrics_fleet": ["--replicas", "2", "--metrics-out", "x.prom"],
    "block_trace_fleet": ["--replicas", "2", "--block-trace-out", "x.jsonl"],
    "persist_fleet": ["--replicas", "2", "--prefix-persist", "radix"],
    "two_outputs_fleet": ["--replicas", "3", "--ledger", "x", "--metrics-out",
                          "y"],
    "grid_shift_aperiodic": ["--replicas", "2", "--grid-shift", "spread"],
    "grid_shift_one": ["--grid-shift", "spread", "--carbon-trace", "diurnal"],
    "autoscale_one": ["--autoscale"],
    "replica_devices_one": ["--replica-devices", "rtx3090,m40"],
    "horizon_one": ["--horizon", "10"],
    "alert_rules_alone": ["--alert-rules", "rules.json"],
    "persist_without_cache": ["--prefix-persist", "radix"],
}


def _refusal(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["server"] + argv)
    with pytest.raises(SystemExit) as exc:
        main()
    # the usage lines differ by the port's --device; the error line is last
    return exc.value.code, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_equal_reference(case, monkeypatch, capsys):
    """The port's parser refuses exactly what the reference's refuses, with
    the same exit code and message."""
    argv = ["--paper-model", "llama-7b"] + REFUSED[case]
    want = _refusal(jax_server.main, argv, monkeypatch, capsys)
    got = _refusal(lambda: server.parse_args(argv), argv, monkeypatch,
                   capsys)
    assert want[0] == 2 and want[1].startswith("server: error: ")
    assert got == want


def test_parser_takes_every_reference_flag(monkeypatch, capsys):
    """Every option of the reference's server, with its choices and
    defaults; the port adds --device only."""
    monkeypatch.setattr(sys, "argv", ["server", "--help"])
    with pytest.raises(SystemExit):
        jax_server.main()
    theirs = set(re.findall(r"(--[a-z0-9-]+)", capsys.readouterr().out))
    ours = {o for a in server.build_parser()._actions
            for o in a.option_strings if o.startswith("--")}
    assert ours - theirs == {"--device"}
    assert theirs <= ours
    assert vars(server.parse_args([])) == dict(
        vars(server.build_parser().parse_args([])), prefix_on=False)
    assert server.parse_args(["--replicas", "2"]).prefix_on


def test_server_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert server.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        server.main(["--arch", "qwen2.5-14b", "--tiny", "--requests", "1"])
