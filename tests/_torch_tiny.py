"""Shared pieces of the port's CPU parity tests: a tiny config's weights in
both packages (the reference's init, a drawn predictor ``A`` or, for an
MoE config, a drawn router unless the reference's zero one is asked for,
loaded into torch; qwen2.5-14b unless another arch is named), one run of
the reference's server CLI on those weights, and train mode's loss and
gradients in both packages (``reference_grads``, ``check_gradients``)."""
import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.data.pipeline import batches as jax_batches
from repro.launch import server as jax_server
from repro.models import transformer as JT
from repro.serving import ContinuousBatchScheduler as JaxScheduler
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs.base import get_config
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map

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


#: family -> the tiny config that stands for it
FAMILIES = {"dense": "qwen2.5-14b", "parallel": "command-r-35b",
            "vlm": "internvl2-1b", "moe": "grok-1-314b",
            "hybrid": "recurrentgemma-2b", "ssm": "mamba2-370m",
            "audio": "musicgen-large"}


def dense_model(arch: str):
    """(reference cfg, its dense params (an MoE router drawn: the init's
    zero router ties every token), port cfg, the port's copy on the CPU,
    one batch of the reference's pipeline as numpy)."""
    jcfg = jax_config(arch, tiny=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32,
                        m2=False)
    for i, layer in enumerate(jp["layers"]["pattern"]):
        if "router" in layer.get("ffn", {}):
            layer["ffn"]["router"] = jnp.asarray(
                np.random.default_rng(22 + i).standard_normal(
                    layer["ffn"]["router"].shape).astype(np.float32))
    cfg = get_config(arch, tiny=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    batch = next(jax_batches(jcfg, batch_size=2, seq_len=16, seed=0))
    return jcfg, jp, cfg, tp, batch


def port_value_and_grad(cfg, params, batch, *, remat: bool):
    """(loss, aux, the gradient tree in the port's layout)."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, aux = T.lm_loss(cfg, params,
                              {k: torch.from_numpy(v) for k, v in
                               batch.items()}, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    by_id = {id(t): g for t, g in zip(leaves, grads)}
    aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
           for k, v in aux.items()}
    return loss.detach(), aux, tree_map(
        lambda t: torch.zeros_like(t) if by_id[id(t)] is None else
        by_id[id(t)], params)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k],
                                                        f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _paths(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def reference_grads(family: str) -> dict:
    """One reference value_and_grad of ``family``'s tiny config, and the
    port's model: {cfg, params, batch, loss, nll, lb, grads}."""
    jcfg, jp, cfg, tp, batch = dense_model(FAMILIES[family])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(jcfg, p, jb, remat=False), has_aux=True))(jp)
    return dict(cfg=cfg, params=tp, batch=batch, loss=float(loss),
                nll=float(aux["nll"]), lb=float(aux["lb_loss"]),
                grads=jax.tree.map(np.asarray, grads))


def check_gradients(family: dict):
    """The port's loss, nll, lb_loss and every gradient leaf against the
    reference's (tests/test_torch_train.py states the tolerances)."""
    cfg = family["cfg"]
    loss, aux, grads = port_value_and_grad(cfg, family["params"],
                                           family["batch"], remat=False)
    assert abs(float(loss) - family["loss"]) <= 1e-6 * family["loss"]
    assert abs(float(aux["nll"]) - family["nll"]) <= 1e-6 * family["nll"]
    if cfg.num_experts:
        assert family["lb"] > 0
        assert abs(float(aux["lb_loss"]) - family["lb"]) <= 1e-6 * family["lb"]
    else:
        assert aux["lb_loss"] == family["lb"] == 0.0
    got, want = _paths(params_to_jax(grads, cfg)), _paths(family["grads"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        err = float(np.abs(got[path] - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-30), (path, err)


def check_remat(family: dict):
    """``remat`` on gives the loss and gradients of ``remat`` off, bit for
    bit."""
    cfg, params, batch = family["cfg"], family["params"], family["batch"]
    l0, _, g0 = port_value_and_grad(cfg, params, batch, remat=False)
    l1, _, g1 = port_value_and_grad(cfg, params, batch, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
