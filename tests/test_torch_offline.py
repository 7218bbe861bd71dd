"""Port parity of M2Cache's offline half: the dequantizers, the predictor's
training (repro_torch.core.predictor), the masked dense FFN oracle
(core.mp_ffn.mp_ffn_reference) and Algorithm 1's ratio search
(core.ratio_search) against the JAX package's, on the CPU.

Tolerances: the dequantizers, ``candidate_ratios``, ``memory_cost``, the
masks, the recall's hits and the search's feasibility are exact (the
recall's fp32 mean of them to 1e-6); fp32 results that sum in
another order are held at 1e-5 relative (``uq_est``, the FFN oracle, the
predictor's losses), and so are A and B after 200 momentum-SGD steps of
``train_predictor`` (with 1e-6 absolute; they moved 2.5e-7 at most)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mp_ffn as JM
from repro.core import predictor as JP
from repro.core import quantize as JQ
from repro.core import ratio_search as JR
from repro_torch.core import mp_ffn as M
from repro_torch.core import predictor as P
from repro_torch.core import quantize as Q
from repro_torch.core import ratio_search as R

from _torch_tiny import tiny_model

GEN_LEN = 3
BUDGET = 0.25


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


# --- dequantizers ------------------------------------------------------------


@pytest.mark.parametrize("axis,shape", [(0, (64, 40)), (1, (40, 64))])
def test_dequantizers_exact(axis, shape):
    w = np.random.default_rng(axis).standard_normal(shape).astype(np.float32)
    q8, s8 = JQ.quantize_int8(jnp.asarray(w), axis)
    q4, s4 = JQ.quantize_int4(jnp.asarray(w), axis)
    np.testing.assert_array_equal(
        Q.dequantize_int8(_t(q8), _t(s8), axis).numpy(),
        np.asarray(JQ.dequantize_int8(q8, s8, axis)))
    np.testing.assert_array_equal(
        Q.dequantize_int4(_t(q4), _t(s4), axis).numpy(),
        np.asarray(JQ.dequantize_int4(q4, s4, axis)))


# --- the predictor's offline half --------------------------------------------


@pytest.fixture(scope="module")
def layer():
    """One FFN layer of the tiny config, probes, the reference's initial
    predictor (its jax.random draws, carried over as numpy) and the
    reference's trained predictor from them."""
    rng = np.random.default_rng(7)
    d, f, r = 64, 96, 8
    wg = (rng.standard_normal((d, f)) / 8).astype(np.float32)
    wu = (rng.standard_normal((d, f)) / 8).astype(np.float32)
    xs = rng.standard_normal((48, d)).astype(np.float32)
    A0, B0 = JP.init_predictor(jax.random.PRNGKey(3), d, f, r)
    A, B, loss = JP.train_predictor(jnp.asarray(xs), jnp.asarray(wg),
                                    jnp.asarray(wu), act_name="silu",
                                    A0=A0, B0=B0, steps=200, lr=1e-2)
    return dict(wg=wg, wu=wu, xs=xs, A0=np.asarray(A0), B0=np.asarray(B0),
                A=np.asarray(A), B=np.asarray(B), loss=float(loss))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_true_neuron_magnitude_matches(layer, act):
    want = np.asarray(JP.true_neuron_magnitude(
        jnp.asarray(layer["xs"]), jnp.asarray(layer["wg"]),
        jnp.asarray(layer["wu"]), act))
    got = P.true_neuron_magnitude(_t(layer["xs"]), _t(layer["wg"]),
                                  _t(layer["wu"]), act).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,k", [((40,), 7), ((3, 5, 40), 12),
                                     ((2, 40), 0), ((6,), 9)])
def test_topk_mask_matches_with_ties_and_signed_zeros(shape, k):
    rng = np.random.default_rng(len(shape) + k)
    levels = np.array([1.0, 0.5, 0.0, -0.0, 0.0, -0.0, -1.0], np.float32)
    scores = levels[rng.integers(0, len(levels), shape)]
    want = np.asarray(JP.topk_mask(jnp.asarray(scores), k))
    got = P.topk_mask(_t(scores), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_init_predictor_scales_as_the_reference():
    """jax.random cannot be reproduced: the port draws from its generator,
    scaled as the reference scales (std 1/sqrt(d) and 1/sqrt(rank))."""
    d, f, r = 256, 512, 16
    JA, JB = JP.init_predictor(jax.random.PRNGKey(0), d, f, r)
    g = torch.Generator().manual_seed(0)
    A, B = P.init_predictor(d, f, r, generator=g)
    assert (A.shape, B.shape) == (JA.shape, JB.shape)
    assert A.dtype == B.dtype == torch.float32
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(A, torch.randn(d, r, generator=g2) / d ** 0.5)
    for got, want, n in ((A, JA, d), (B, JB, r)):
        assert abs(float(got.std()) * n ** 0.5 - 1) < 0.05
        assert abs(float(np.std(np.asarray(want))) * n ** 0.5 - 1) < 0.05


def test_train_predictor_matches(layer):
    A, B, loss = P.train_predictor(
        _t(layer["xs"]), _t(layer["wg"]), _t(layer["wu"]), act_name="silu",
        A0=_t(layer["A0"]), B0=_t(layer["B0"]), steps=200, lr=1e-2)
    np.testing.assert_allclose(A.numpy(), layer["A"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(B.numpy(), layer["B"], rtol=1e-5, atol=1e-6)
    assert _rel(float(loss), layer["loss"]) < 1e-5
    # one step: the loss of the starting predictor, within 1e-5
    _, _, l0 = P.train_predictor(
        _t(layer["xs"]), _t(layer["wg"]), _t(layer["wu"]), act_name="silu",
        A0=_t(layer["A0"]), B0=_t(layer["B0"]), steps=1)
    _, _, j0 = JP.train_predictor(
        jnp.asarray(layer["xs"]), jnp.asarray(layer["wg"]),
        jnp.asarray(layer["wu"]), act_name="silu",
        A0=jnp.asarray(layer["A0"]), B0=jnp.asarray(layer["B0"]), steps=1)
    assert _rel(float(l0), float(j0)) < 1e-5
    # training recovers more of the true top-k than the draw did
    args = (_t(layer["xs"]), _t(layer["wg"]), _t(layer["wu"]))
    before = P.predictor_recall(_t(layer["A0"]), _t(layer["B0"]), *args,
                                act_name="silu", k=24)
    after = P.predictor_recall(A, B, *args, act_name="silu", k=24)
    assert float(after) > float(before)


@pytest.mark.parametrize("which", ["initial", "trained"])
def test_predictor_recall_equal(layer, which):
    A, B = (layer["A0"], layer["B0"]) if which == "initial" else \
        (layer["A"], layer["B"])
    for k in (1, 24, 96):
        want = float(JP.predictor_recall(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(layer["xs"]),
            jnp.asarray(layer["wg"]), jnp.asarray(layer["wu"]),
            act_name="silu", k=k))
        got = float(P.predictor_recall(
            _t(A), _t(B), _t(layer["xs"]), _t(layer["wg"]), _t(layer["wu"]),
            act_name="silu", k=k))
        # the same hits per sample; the mean over them rounds in fp32
        assert got == pytest.approx(want, rel=1e-6, abs=0), (k, got, want)


@pytest.fixture(scope="module")
def tiny():
    """The tiny qwen2.5-14b in both packages (the reference's init, A
    drawn), built once."""
    return tiny_model()


# --- the masked dense FFN oracle ---------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5), (1, 1)])
def test_mp_ffn_reference_matches(tiny, shape):
    jcfg, jp, cfg, tp = tiny
    jl, tl = jp["layers"]["pattern"][0], tp["layers"][0]
    b = jl["ffn"]["banks"]
    x = np.random.default_rng(3).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    pred = {k: v[0] for k, v in jl["ffn"]["pred"].items()}
    want = np.asarray(JM.mp_ffn_reference(jcfg, b["wg_fp"][0], b["wu_fp"][0],
                                          b["wd_fp"][0], pred,
                                          jnp.asarray(x)))
    tb = tl["ffn"]["banks"]
    got = M.mp_ffn_reference(cfg, tb["wg_fp"].T, tb["wu_fp"].T, tb["wd_fp"],
                             tl["ffn"]["pred"], _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


# --- Algorithm 1 -------------------------------------------------------------


def test_candidates_and_costs_equal(tiny):
    jcfg, _, cfg, _ = tiny
    assert R.candidate_ratios() == JR.candidate_ratios()
    for args in ((0.5, 2), (0.1, 4)):
        assert R.candidate_ratios(*args) == JR.candidate_ratios(*args)
    for r in JR.candidate_ratios():
        assert R.memory_cost(cfg, r) == JR.memory_cost(jcfg, r)


@pytest.fixture(scope="module")
def searched(tiny):
    """The reference's search (its table's uq at every candidate under the
    budget) and its uq_est at the candidates over it, on the tiny model."""
    jcfg, jp, cfg, tp = tiny
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    res = JR.search(jcfg, jp, jnp.asarray(prompts), memory_budget=BUDGET,
                    gen_len=GEN_LEN)
    uq = {}
    for row in res.table:
        r = row["ratio"]
        uq[r] = row["uq"] if row["feasible"] else JR.uq_est(
            dataclasses.replace(jcfg, m2_ratio_fp16=r[0], m2_ratio_int8=r[1],
                                m2_ratio_int4=r[2]), jp, jnp.asarray(prompts),
            gen_len=GEN_LEN)
    return dict(res=res, uq=uq, cfg=cfg, params=tp, prompts=prompts)


def test_uq_est_at_every_candidate(searched):
    cfg = searched["cfg"]
    assert len(searched["uq"]) == 8
    for r, want in searched["uq"].items():
        cand = dataclasses.replace(cfg, m2_ratio_fp16=r[0], m2_ratio_int8=r[1],
                                   m2_ratio_int4=r[2])
        got = R.uq_est(cand, searched["params"], searched["prompts"],
                       gen_len=GEN_LEN)
        assert _rel(got, want) < 1e-5, (r, got, want)


def test_search_table_matches(searched):
    want = searched["res"]
    got = R.search(searched["cfg"], searched["params"], searched["prompts"],
                   memory_budget=BUDGET, gen_len=GEN_LEN)
    assert got.best_ratio == want.best_ratio
    assert _rel(got.best_uq, want.best_uq) < 1e-5
    assert [r["ratio"] for r in got.table] == [r["ratio"] for r in want.table]
    assert [r["feasible"] for r in got.table] == \
        [r["feasible"] for r in want.table]
    assert [r["mem_cost"] for r in got.table] == \
        [r["mem_cost"] for r in want.table]
    assert not got.table[-3]["feasible"]             # (1, 0, 0)
    for g, w in zip(got.table, want.table):
        if w["feasible"]:
            assert _rel(g["uq"], w["uq"]) < 1e-5
        else:
            assert g["uq"] == w["uq"] == float("inf")
