"""Shared pieces of the port's CPU parity tests of the server path: the
qwen2.5-14b tiny weights in both packages (the reference's init, a drawn
predictor ``A``, loaded into torch), and one run of the reference's
server CLI on those weights."""
import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as jax_config
from repro.launch import server as jax_server
from repro.models import transformer as JT
from repro.serving import ContinuousBatchScheduler as JaxScheduler
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config

#: shared-prefix chat traffic with radix prefix reuse, chunked and batched
#: prefill and a continuous decode batch
SHARED = ["--arch", "qwen2.5-14b", "--tiny", "--workload", "shared-prefix",
          "--prefix-cache", "--prefix-reuse", "0.7", "--turns", "2",
          "--requests", "8", "--prefill-chunk", "8", "--prefill-bucket", "8",
          "--gen-len", "3", "6", "--shared-prefix-len", "24", "--max-batch",
          "4", "--dram-gb", "0.5", "--rate", "50"]


def tiny_model():
    """(reference cfg, reference params, port cfg, port params on the CPU)."""
    jcfg = jax_config("qwen2.5-14b", tiny=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32,
                        m2=True)
    pred = jp["layers"]["pattern"][0]["ffn"]["pred"]   # a trained predictor
    pred["A"] = jnp.asarray(np.random.default_rng(21).standard_normal(
        pred["A"].shape).astype(np.float32) / 4.0)
    cfg = get_config("qwen2.5-14b", tiny=True)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def reference_cli(argv, jp):
    """Run ``repro.launch.server`` with ``argv`` on the weights ``jp``.
    Returns (its printed dict, the ServingReport of every scheduler run, in
    order: one, or one per replica)."""
    reports = []
    run = JaxScheduler.run

    def keep(self, reqs, *a, **kw):
        reports.append(run(self, reqs, *a, **kw))
        return reports[-1]
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "init_params", lambda *a, **k: jp)
        mp.setattr(JaxScheduler, "run", keep)
        mp.setattr(sys, "argv", ["server"] + list(argv))
        with contextlib.redirect_stdout(buf):
            jax_server.main()
    return json.loads(buf.getvalue()), reports


def as_json(obj):
    """The dict as the CLI prints it (floats and tuples as JSON has them)."""
    return json.loads(json.dumps(obj, default=float))


def strip_wall(doc):
    """A Chrome trace without the host-clock ``wall_s`` of its events."""
    for ev in doc["traceEvents"]:
        ev.get("args", {}).pop("wall_s", None)
    return doc


def tokens(rep) -> dict:
    return {r.rid: r.final_tokens() for r in rep.requests}
