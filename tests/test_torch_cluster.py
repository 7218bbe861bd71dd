"""The port's fleet layer (``repro_torch.serving.cluster`` and
``launch/server.py::run_cluster``) against the reference's, on the CPU.

A real-tiny fleet of two replicas behind the prefix router, and an
analytic fleet of three behind the carbon router with phase-shifted grid
slices and carbon-driven autoscaling: the printed JSON (and the fleet's
trace, without the host-clock ``wall_s``) equals the reference's. Routing
is two-phase, so each replica's tokens equal a standalone run of its
sub-trace. A radix tree saved by one package's server loads in the
other's, which then serves the next requests as its own tree would."""
import json
import shutil

import pytest

from _torch_tiny import (SHARED, as_json, reference_cli, strip_wall,
                         tiny_model, tokens)
from repro_torch.launch import server
from repro_torch.serving import validate_cluster_summary

FLEET = SHARED + ["--replicas", "2", "--router", "prefix",
                  "--replica-devices", "rtx3090,m40"]
ANALYTIC = ["--paper-model", "llama-7b", "--replicas", "3", "--router",
            "carbon", "--workload", "diurnal", "--requests", "8",
            "--gen-len", "2", "3", "--shared-prefix-len", "16",
            "--carbon-trace", "diurnal", "--grid-shift", "spread",
            "--autoscale", "--horizon", "300"]


@pytest.fixture(scope="module")
def model():
    return tiny_model()


@pytest.fixture(scope="module")
def fleet(model, tmp_path_factory):
    """(reference output, its per-replica reports, port output, router,
    both traces)."""
    _, jp, cfg, tp = model
    d = tmp_path_factory.mktemp("fleet")
    theirs, reports = reference_cli(FLEET + ["--trace-out",
                                             str(d / "jax.json")], jp)
    args = server.parse_args(FLEET + ["--trace-out", str(d / "torch.json"),
                                      "--device", "cpu"])
    out, router = server.run_cluster(args, cfg=cfg, params=tp,
                                     ssd_dir=str(d / "ssd"))
    traces = [strip_wall(json.loads((d / n).read_text()))
              for n in ("torch.json", "jax.json")]
    return theirs, reports, as_json(out), router, traces, args


def test_real_fleet_equals_reference(fleet):
    theirs, reports, ours, router, traces, _ = fleet
    assert ours == theirs
    assert traces[0] == traces[1]
    validate_cluster_summary(ours["summary"])
    assert [r.name for r in router.replicas] == ["r0", "r1"]
    assert [ours["replicas"][n]["device"] for n in ("r0", "r1")] == \
        ["rtx3090", "m40"]
    assert all(len(r.events) > 0 for r in router.replicas)
    assert ours["summary"]["affinity_routed"] > 0
    assert [tokens(r.report) for r in router.replicas] == \
        [tokens(rep) for rep in reports]


def test_replica_equals_standalone_run(model, fleet, tmp_path):
    _, _, cfg, tp = model
    _, _, _, router, _, args = fleet
    for r in router.replicas:
        solo = server.build_replica(args, f"solo-{r.name}", r.device_name,
                                    r.carbon_trace, cfg=cfg, params=tp,
                                    ssd_dir=str(tmp_path / r.name))
        solo.events = list(r.events)
        solo.run(vocab_size=cfg.vocab_size, horizon_s=args.horizon)
        assert solo.tokens() == r.tokens(), r.name
        assert solo.report.summary() == r.report.summary()


def test_analytic_fleet_equals_reference(model, tmp_path):
    theirs, _ = reference_cli(ANALYTIC + ["--trace-out",
                                          str(tmp_path / "jax.json")],
                              model[1])
    out, _ = server.run_cluster(server.parse_args(ANALYTIC + [
        "--trace-out", str(tmp_path / "torch.json"), "--device", "cpu"]))
    assert as_json(out) == theirs
    ours = strip_wall(json.loads((tmp_path / "torch.json").read_text()))
    assert ours == strip_wall(json.loads((tmp_path / "jax.json")
                                          .read_text()))
    assert out["summary"]["drains"] > 0


def test_prefix_tree_loads_across_packages(model, tmp_path):
    """A tree saved with --prefix-persist by either package's server loads
    in the other's; the warm runs on it equal the owner's warm run."""
    _, jp, cfg, tp = model

    def port(argv):
        out, rep, _, _ = server.run(server.parse_args(argv + ["--device",
                                                              "cpu"]),
                                    cfg=cfg, params=tp)
        return as_json(out), tokens(rep)

    def ref(argv):
        out, (rep,) = reference_cli(argv, jp)
        return out, tokens(rep)
    first = SHARED[:SHARED.index("--requests")] + ["--requests", "4"] + \
        SHARED[SHARED.index("--requests") + 2:]
    cold = {"jax": ref, "torch": port}
    for name, serve in cold.items():
        serve(first + ["--prefix-persist", str(tmp_path / name)])
    warm = {}
    for owner in cold:
        for name, serve in cold.items():
            tree = tmp_path / f"{owner}-for-{name}"
            shutil.copytree(tmp_path / owner, tree)
            warm[owner, name] = serve(SHARED + ["--prefix-persist",
                                                str(tree)])
    for owner in cold:
        (o1, t1), (o2, t2) = warm[owner, "jax"], warm[owner, "torch"]
        assert t1 == t2, owner
        assert o1["persist"]["loaded"] == o2["persist"]["loaded"]
        assert o1["summary"] == o2["summary"]
        assert o2["summary"]["prefix_hit_tokens"] > 0
        assert o2["persist"]["loaded"]["nodes"] > 0
