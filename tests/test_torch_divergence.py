"""The port's KV-divergence probe (``repro_torch.eval``) against the
reference's on the CPU: qwen2.5-14b tiny with the reference's weights, the
reference's probes (seeds 0-3, 24-token prompts from
``numpy.random.default_rng(seed)``, 8 teacher-forced decode steps, top-5),
for int8 and int4. Overlaps, first divergent step and token match rate are
equal; logit differences agree within 1e-4. The means are the reference's
own measured numbers (int4 0.91875), not its 0.95 acceptance constant,
which the reference itself misses on this model."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.eval import divergence as JD
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.eval import divergence as D

SEEDS = range(4)
EXACT = ("steps", "k", "topk_overlap_mean", "topk_overlap_min",
         "first_token_divergence", "token_match_rate")
#: the reference's probe means on this tree (ROADMAP.md, queue 3)
MEANS = {"int8": 0.99375, "int4": 0.91875}


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("qwen2.5-14b", tiny=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32,
                        m2=True)
    cfg = get_config("qwen2.5-14b", tiny=True)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def _prompt(cfg, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                24).tolist()


@pytest.fixture(scope="module")
def probes(model):
    jcfg, jp, cfg, tp = model
    out = {}
    for prec in MEANS:
        for seed in SEEDS:
            prompt = _prompt(cfg, seed)
            out[prec, seed] = (
                D.kv_divergence_probe(cfg, tp, prompt, gen_len=8,
                                      precision=prec, k=5, device="cpu"),
                JD.kv_divergence_probe(jcfg, jp, prompt, gen_len=8,
                                       precision=prec, k=5))
    return out


@pytest.mark.parametrize("prec", sorted(MEANS))
@pytest.mark.parametrize("seed", SEEDS)
def test_probe_equals_reference(probes, prec, seed):
    ours, theirs = (r.to_dict() for r in probes[prec, seed])
    for key in EXACT:
        assert ours[key] == theirs[key], key
    for key in ("max_abs_diff", "mean_abs_diff"):
        assert abs(ours[key] - theirs[key]) <= 1e-4, key
    assert np.isfinite(ours["max_abs_diff"]) and ours["max_abs_diff"] > 0


@pytest.mark.parametrize("prec", sorted(MEANS))
def test_probe_means_are_the_reference_numbers(probes, prec):
    mean = float(np.mean([probes[prec, s][0].topk_overlap_mean
                          for s in SEEDS]))
    assert mean == MEANS[prec]


def test_fp16_is_lossless_and_metrics_equal_reference(model):
    _, _, cfg, tp = model
    rep = D.kv_divergence_probe(cfg, tp, _prompt(cfg, 0), gen_len=3,
                                precision="fp16", device="cpu")
    assert rep.max_abs_diff == 0.0 and rep.token_match_rate == 1.0
    rng = np.random.default_rng(5)
    ref = [rng.standard_normal(50).astype(np.float32) for _ in range(4)]
    test = [r + rng.standard_normal(50).astype(np.float32) * s
            for r, s in zip(ref, (0.0, 0.3, 1.0, 3.0))]
    assert D.compare_logits(ref, test, k=5).to_dict() == \
        JD.compare_logits(ref, test, k=5).to_dict()
    for a, b in (([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 5, 3]),
                 ([1, 2], [1, 2, 3]), ([], [])):
        assert D.first_divergence(a, b) == JD.first_divergence(a, b)
    assert D.topk_overlap(ref[0], test[3], 5) == \
        JD.topk_overlap(ref[0], test[3], 5)


def test_probe_defaults_to_cuda_and_checks_the_params(model, monkeypatch):
    _, _, cfg, tp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.kv_divergence_probe(cfg, tp, [1, 2, 3])
    meta = dict(tp, embed=tp["embed"].to("meta"))
    with pytest.raises(ValueError, match="params live on"):
        D.kv_divergence_probe(cfg, meta, [1, 2, 3], device="cpu")
