"""Port parity of the trainer (repro_torch.training, data.pipeline,
launch.train) against the JAX package's, on the CPU; and train mode's
gradients for the SSM and audio families (the others:
tests/test_torch_train.py, same tolerances).

Tolerances, held apart as Adam magnifies rounding (where v ~ 0 the step
m / (sqrt(v) + eps) turns a difference of 1e-9 into one of lr):
- ``apply_updates`` on the same gradients: the moments bit for bit, the
  params within 1e-7 + 1e-6 |p| (seen: 1.5e-8, an ulp);
- three ``make_train_step`` steps: loss and grad_norm within 1e-5
  relative (seen 3e-6); after them every parameter within twice the
  learning rates summed (the most two Adam runs can move an element apart),
  and fewer than 1e-3 of the elements farther apart than 1e-5 (seen 4.3e-5
  of them, largest 2.3e-3);
- the pipeline's batches and the checkpoints' values bit for bit."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.data import pipeline as JD
from repro.models import transformer as JT
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline as D
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as O
from repro_torch.training.train_loop import make_train_step
from repro_torch.tree import tree_leaves

from _torch_tiny import (_paths, check_gradients, check_remat, dense_model,
                         reference_grads)

#: the families held here (the others: tests/test_torch_train.py)
SECOND = ["ssm", "audio"]


@pytest.fixture(scope="module", params=SECOND, ids=SECOND)
def family(request):
    return reference_grads(request.param)


def test_loss_and_every_gradient_match(family):
    check_gradients(family)


def test_remat_gives_the_same_gradients(family):
    check_remat(family)


# --- AdamW -------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("start,gscale", [(0, 1e-3), (150, 1.0)],
                         ids=["warmup", "cosine-clipped"])
def test_apply_updates_matches(start, gscale):
    """Two steps from ``start`` on the same numpy gradients, small ones
    (no clip) and large ones (clipped to the global norm)."""
    jcfg, jp, cfg, _, _ = dense_model("qwen2.5-14b")
    rng = np.random.default_rng(start)
    jg = jax.tree.map(lambda a: jnp.asarray(
        (rng.standard_normal(a.shape) * gscale).astype(np.float32)), jp)
    kw = dict(lr=1e-2, warmup_steps=10, total_steps=300)
    js = JO.init_opt_state(jp)._replace(step=jnp.asarray(start, jnp.int32))
    tp = params_from_jax(_np(jp), cfg, "cpu")
    tg = params_from_jax(_np(jg), cfg, "cpu")
    ts = O.init_opt_state(tp)._replace(
        step=torch.tensor(start, dtype=torch.int32))
    for _ in range(2):
        # eager: under jit XLA fuses b * m + (1 - b) * g into an FMA, an
        # ulp away from the two rounded products both packages compute here
        jp, js, jm = JO.apply_updates(jp, jg, js, JO.AdamWConfig(**kw))
        tp, ts, tm = O.apply_updates(tp, tg, ts, O.AdamWConfig(**kw), cfg)
        assert float(tm["lr"]) == float(jm["lr"])
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
    assert int(ts.step) == int(js.step) == start + 2
    for tree, want in ((ts.m, js.m), (ts.v, js.v)):
        got, want = _paths(params_to_jax(tree, cfg)), _paths(_np(want))
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    got, want = _paths(params_to_jax(tp, cfg)), _paths(_np(jp))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_decay_follows_the_reference_layout():
    """The reference decays leaves of two axes or more: its stacked
    pattern layers' norms and biases, not ``final_norm`` or a remainder
    layer's 1-D leaves."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b", tiny=True),
                              num_layers=5)          # 1 repeat + 2 remainder
    params = T.init_params(cfg, device="cpu", m2=False)
    nd = O.reference_ndims(params, cfg)
    leaves = tree_leaves(params)
    by = {id(t): n for t, n in zip(leaves, nd)}
    pat, F, _ = T.pattern_split(cfg)
    assert by[id(params["final_norm"])] == 1
    assert by[id(params["layers"][0]["norm1"])] == 2
    assert by[id(params["layers"][F * len(pat)]["norm1"])] == 1


# --- the train step ----------------------------------------------------------


@pytest.fixture(scope="module")
def three_steps():
    """Three steps of each package's train step on the same params and the
    reference pipeline's batches."""
    jcfg, jp, cfg, tp, _ = dense_model("qwen2.5-14b")
    kw = dict(lr=3e-3, total_steps=3, warmup_steps=1)
    jstep = jax.jit(jax_train_step(jcfg, JO.AdamWConfig(**kw), remat=True))
    tstep = make_train_step(cfg, O.AdamWConfig(**kw), remat=True)
    js, ts = JO.init_opt_state(jp), O.init_opt_state(tp)
    jm_all, tm_all = [], []
    for _, b in zip(range(3), JD.batches(jcfg, batch_size=2, seq_len=16,
                                         seed=0)):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        jm_all.append({k: float(v) for k, v in jm.items()})
        tm_all.append({k: float(v) for k, v in tm.items()})
    return dict(cfg=cfg, jp=_np(jp), tp=tp, jm=jm_all, tm=tm_all)


def test_three_train_steps_match(three_steps):
    jm, tm = three_steps["jm"], three_steps["tm"]
    for j, t in zip(jm, tm):
        assert t.keys() == j.keys()
        for k in ("loss", "nll", "grad_norm"):
            assert t[k] == pytest.approx(j[k], rel=1e-5), k
        assert t["lr"] == j["lr"] and t["lb_loss"] == j["lb_loss"] == 0.0
    assert tm[-1]["loss"] < tm[0]["loss"]
    got = _paths(params_to_jax(three_steps["tp"], three_steps["cfg"]))
    want = _paths(three_steps["jp"])
    diff = np.concatenate([np.abs(got[k] - w).ravel()
                           for k, w in want.items()])
    assert diff.max() <= 2 * sum(t["lr"] for t in tm)
    assert (diff > 1e-5).mean() < 1e-3


# --- the pipeline ------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "internvl2-1b",
                                  "musicgen-large"])
def test_batches_byte_equal(arch):
    jcfg, cfg = jax_config(arch, tiny=True), get_config(arch, tiny=True)
    want = list(JD.batches(jcfg, batch_size=2, seq_len=24, seed=3,
                           num_batches=3))
    got = list(D.batches(cfg, batch_size=2, seq_len=24, seed=3,
                         num_batches=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes()


def test_file_corpus_byte_equal(tmp_path):
    path = tmp_path / "tokens.npy"
    np.save(path, np.arange(1000, dtype=np.int32) % 97)
    cfg, jcfg = get_config("qwen2.5-14b", tiny=True), \
        jax_config("qwen2.5-14b", tiny=True)
    got = next(D.batches(cfg, batch_size=2, seq_len=16,
                         corpus=D.FileCorpus(str(path))))
    want = next(JD.batches(jcfg, batch_size=2, seq_len=16,
                           corpus=JD.FileCorpus(str(path))))
    assert got["tokens"].tobytes() == want["tokens"].tobytes()


# --- checkpoints -------------------------------------------------------------


def _reference_shapes(jcfg, m2: bool):
    """The reference's param tree as shapes (traced, not computed)."""
    return jax.eval_shape(lambda: JT.init_params(
        jax.random.PRNGKey(0), jcfg, dtype=jnp.float32, m2=m2))


@pytest.mark.parametrize("m2", [False, True], ids=["dense", "m2"])
def test_checkpoints_cross_load(tmp_path, m2):
    """Saved by each package, loaded by the other, compared value for value.
    Every leaf holds its own draws (so a leaf out of order cannot hide) in
    the reference's tree, whose structure, shapes and dtypes are held to
    the reference's ``init_params``; one pattern repeat and two remainder
    layers."""
    jcfg = dataclasses.replace(jax_config("recurrentgemma-2b", tiny=True),
                               num_layers=5)
    cfg = dataclasses.replace(get_config("recurrentgemma-2b", tiny=True),
                              num_layers=5)
    rng = np.random.default_rng(1)

    def draw(a):
        if a.dtype == np.int8:
            return rng.integers(-128, 128, a.shape).astype(np.int8)
        return rng.standard_normal(a.shape).astype(a.dtype)
    template = T.init_params(cfg, device="cpu", m2=m2)
    jp = jax.tree.map(draw, params_to_jax(template, cfg))
    shapes = _reference_shapes(jcfg, m2)
    assert jax.tree.structure(jp) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(jp), jax.tree.leaves(shapes)):
        assert (a.shape, a.dtype) == (s.shape, s.dtype)
    f32 = lambda a: rng.standard_normal(a.shape).astype(np.float32)
    js = JO.AdamWState(np.asarray(3, np.int32), jax.tree.map(f32, jp),
                       jax.tree.map(f32, jp))
    JC.save(str(tmp_path / "ref"), jp, js, {"by": "reference"})
    params, opt, meta = C.load(str(tmp_path / "ref"), template,
                               O.init_opt_state(template), cfg=cfg)
    assert meta == {"by": "reference"}
    for got, want in ((params, jp), (opt.m, js.m), (opt.v, js.v)):
        got, want = _paths(params_to_jax(got, cfg)), _paths(want)
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(opt.step) == 3

    C.save(str(tmp_path / "port"), params, opt, {"by": "port"}, cfg=cfg)
    jback, jopt, meta = JC.load(str(tmp_path / "port"), shapes,
                                jax.eval_shape(JO.init_opt_state, shapes))
    assert meta == {"by": "port"}
    for got, want in ((jback, jp), (jopt, js)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --- the launcher ------------------------------------------------------------


def test_launch_train_on_cpu(tmp_path, three_steps, capsys):
    hist = tmp_path / "h.json"
    launch_train.main(["--arch", "qwen2.5-14b", "--tiny", "--steps", "12",
                       "--batch", "2", "--seq", "16", "--lr", "3e-3",
                       "--device", "cpu", "--history", str(hist),
                       "--save", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "final loss:" in out
    history = json.loads(hist.read_text())
    assert [h["step"] for h in history] == [0, 10, 11]
    assert set(history[0]) == set(three_steps["jm"][0]) | {"step", "wall"}
    assert history[-1]["loss"] < history[0]["loss"]
    # the reference reads the checkpoint
    shapes = _reference_shapes(jax_config("qwen2.5-14b", tiny=True), False)
    _, _, meta = JC.load(str(tmp_path / "ck"), shapes)
    assert meta == {"arch": "qwen2.5-14b", "tiny": True, "steps": 12}
