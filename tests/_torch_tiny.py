"""Shared pieces of the port's CPU parity tests of the server path: a tiny
config's weights in both packages (the reference's init, a drawn predictor
``A`` or, for an MoE config, a drawn router unless the reference's zero one
is asked for, loaded into torch; qwen2.5-14b unless another arch is named),
and one run of the reference's server CLI on those weights."""
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


def shared_argv(arch: str) -> list:
    """SHARED's traffic served by the tiny config of ``arch``."""
    return ["--arch", arch] + SHARED[2:]


def tiny_model(arch: str = "qwen2.5-14b", *, zero_router: bool = False):
    """(reference cfg, reference params, port cfg, port params on the CPU).
    ``zero_router``: keep an MoE config's router at the reference's zero
    init, where every token ties and takes experts 0..k-1."""
    jcfg = jax_config(arch, tiny=True)
    return model_from(jcfg, get_config(arch, tiny=True),
                      zero_router=zero_router)


def model_from(jcfg, cfg, *, zero_router: bool = False):
    """:func:`tiny_model` for any pair of equal configs (the reference's
    ``jcfg``, the port's ``cfg``): the reference's init, then every pattern
    position's and remainder layer's predictor ``A`` drawn (pattern 0 from
    rng 21, as it always was; position i from 21 + i, remainder j from
    31 + j), or an MoE layer's router (an SSD layer has neither)."""
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32,
                        m2=True)
    layers = jp["layers"]
    for seed, layer in ([(21 + i, p) for i, p in enumerate(layers["pattern"])]
                        + [(31 + j, p) for j, p in
                           enumerate(layers["remainder"])]):
        ffn = layer.get("ffn", {})
        if not ffn:                                     # an SSD layer
            continue
        if "pred" in ffn:                               # a trained predictor
            ffn["pred"]["A"] = jnp.asarray(
                np.random.default_rng(seed).standard_normal(
                    ffn["pred"]["A"].shape).astype(np.float32) / 4.0)
        elif not zero_router:                           # a trained router
            ffn["router"] = jnp.asarray(
                np.random.default_rng(seed + 1).standard_normal(
                    ffn["router"].shape).astype(np.float32))
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
