"""Port parity: the predictor's top-k order and the sparse mixed-precision
FFN (repro_torch.core.{predictor,mp_ffn} vs repro.core.{predictor,mp_ffn}).

The active set must be *exactly* the reference's, order included: rank
decides each neuron's precision tier. ``y`` is held at 1e-5 (fp32 sums in
another order)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import mp_ffn as JM
from repro.core import predictor as JP
from repro.core.quantize import build_neuron_banks
from repro_torch.configs.base import get_config
from repro_torch.core import mp_ffn as M
from repro_torch.core import predictor as P
from repro_torch.core.quantize import to_neuron_major


def _topk_both(scores: np.ndarray, k: int):
    want = np.asarray(JP.shared_topk_indices(jnp.asarray(scores), k))
    got = P.shared_topk_indices(torch.from_numpy(scores), k).numpy()
    return got, want


@pytest.mark.parametrize("seed,shape,k", [(0, (2, 3, 50), 12), (1, (64,), 64),
                                          (2, (4, 1, 512), 154),
                                          (3, (1, 7, 33), 1)])
def test_shared_topk_matches_reference(seed, shape, k):
    scores = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    got, want = _topk_both(scores, k)
    np.testing.assert_array_equal(got, want)


def test_shared_topk_all_equal_scores_is_identity_prefix():
    # the reference's zero-initialised predictor gives all-zero scores
    got, want = _topk_both(np.zeros((2, 5, 512), np.float32), 154)
    np.testing.assert_array_equal(want, np.arange(154))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_topk_planted_ties_break_by_lowest_index(seed):
    rng = np.random.default_rng(seed)
    levels = np.array([3.0, 1.0, 1.0, 0.5, -2.0], np.float32)
    scores = levels[rng.integers(0, len(levels), (1, 40))]
    got, want = _topk_both(scores, 25)
    np.testing.assert_array_equal(got, want)
    # within each tied value the ids ascend
    flat = scores[0]
    for v in np.unique(flat):
        sel = got[flat[got] == v]
        assert np.all(np.diff(sel) > 0)


def test_predictor_scores_allclose():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    A = rng.standard_normal((32, 8)).astype(np.float32)
    B = rng.standard_normal((8, 40)).astype(np.float32)
    want = np.asarray(JP.predictor_scores(*map(jnp.asarray, (x, A, B))))
    got = P.predictor_scores(*map(torch.from_numpy, (x, A, B))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [8, 30, 512, 13824, 11008])
@pytest.mark.parametrize("tiny", [True, False])
def test_tier_sizes_match(f, tiny):
    cfg = get_config("qwen2.5-14b", tiny=tiny)
    assert M.tier_sizes(f, cfg) == JM.tier_sizes(
        f, jax_config("qwen2.5-14b", tiny=tiny))


def _port_banks(banks):
    """The reference's banks in the port's layout (gate, up neuron-major)."""
    return to_neuron_major({k: torch.from_numpy(v) for k, v in banks.items()})


def _layer(seed, d, f, r, random_a: bool):
    rng = np.random.default_rng(seed)
    wg = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    banks = {k: np.array(v) for k, v in build_neuron_banks(
        jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd)).items()}
    A = (rng.standard_normal((d, r)) / np.sqrt(d)).astype(np.float32) \
        if random_a else np.zeros((d, r), np.float32)
    B = (rng.standard_normal((r, f)) / np.sqrt(r)).astype(np.float32)
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    return banks, {"A": A, "B": B}, x


@pytest.mark.parametrize("random_a", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_mp_ffn_apply_matches_reference(random_a, seed):
    cfg = get_config("qwen2.5-14b", tiny=True)
    jcfg = jax_config("qwen2.5-14b", tiny=True)
    banks, pred, x = _layer(seed, cfg.d_model, cfg.d_ff,
                            cfg.m2_predictor_rank, random_a)
    jy, jinfo = JM.mp_ffn_apply(
        jcfg, {k: jnp.asarray(v) for k, v in banks.items()},
        {k: jnp.asarray(v) for k, v in pred.items()}, jnp.asarray(x))
    ty, tinfo = M.mp_ffn_apply(
        cfg, _port_banks(banks),
        {k: torch.from_numpy(v) for k, v in pred.items()}, torch.from_numpy(x))
    want_idx = np.asarray(jinfo["active_idx"])
    np.testing.assert_array_equal(tinfo["active_idx"].numpy(), want_idx)
    if not random_a:
        np.testing.assert_array_equal(want_idx, np.arange(len(want_idx)))
    else:
        assert not np.array_equal(want_idx, np.arange(len(want_idx)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert tinfo["bytes_weights"] == jinfo["bytes_weights"]
    assert tinfo["sizes"] == jinfo["sizes"]


def test_mp_ffn_apply_other_ratios():
    cfg = dataclasses.replace(get_config("qwen2.5-14b", tiny=True),
                              m2_active_ratio=0.5, m2_ratio_fp16=0.1,
                              m2_ratio_int8=0.6)
    jcfg = dataclasses.replace(jax_config("qwen2.5-14b", tiny=True),
                               m2_active_ratio=0.5, m2_ratio_fp16=0.1,
                               m2_ratio_int8=0.6)
    banks, pred, x = _layer(7, cfg.d_model, cfg.d_ff, cfg.m2_predictor_rank,
                            True)
    jy, jinfo = JM.mp_ffn_apply(
        jcfg, {k: jnp.asarray(v) for k, v in banks.items()},
        {k: jnp.asarray(v) for k, v in pred.items()}, jnp.asarray(x))
    ty, tinfo = M.mp_ffn_apply(
        cfg, _port_banks(banks),
        {k: torch.from_numpy(v) for k, v in pred.items()}, torch.from_numpy(x))
    np.testing.assert_array_equal(tinfo["active_idx"].numpy(),
                                  np.asarray(jinfo["active_idx"]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
