"""Port parity end to end: RealModelRunner and M2CacheEngine
(repro_torch.core.engine*) against the reference engine on qwen2.5-14b tiny
(greedy tokens, per-layer active sets, modeled clock and cache stats all
exactly equal), the analytic and ZeRO-Inference modes, and the serve CLI
on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as jax_config
from repro.core.engine import M2CacheEngine as JaxEngine
from repro.core.engine_model import RealModelRunner as JaxRunner
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.core.engine import M2CacheEngine
from repro_torch.core.engine_model import RealModelRunner


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen2.5-14b", tiny=True)
    cfg = get_config("qwen2.5-14b", tiny=True)
    out = {}
    for random_a in (False, True):
        jp = JT.init_params(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32,
                            m2=True)
        if random_a:
            pred = jp["layers"]["pattern"][0]["ffn"]["pred"]
            A = np.random.default_rng(21).standard_normal(pred["A"].shape)
            pred["A"] = jnp.asarray(A.astype(np.float32) / 4.0)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        out[random_a] = (jcfg, jp, cfg, tp)
    return out


def _prompts(seed, B=2, S=12):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("random_a", [False, True])
def test_runner_generate_tokens_and_active_sets_equal(models, random_a):
    jcfg, jp, cfg, tp = models[random_a]
    prompts, gen = _prompts(22), 5
    jtok, jidx = JaxRunner(jcfg, jp, max_seq=12 + gen + 1).generate(prompts,
                                                                    gen)
    runner = RealModelRunner(cfg, tp, max_seq=12 + gen + 1, device="cpu")
    ttok, tidx = runner.generate(prompts, gen)
    np.testing.assert_array_equal(ttok, jtok)
    assert len(tidx) == len(jidx) == gen
    for js, ts in zip(jidx, tidx):
        assert len(ts) == len(js) == cfg.num_layers
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b, a)
    assert runner.last_logits.shape == (2, cfg.vocab_size)
    assert len(runner.wall_s["decode"]) == gen


@pytest.mark.parametrize("random_a", [False, True])
def test_engine_real_mode_matches_reference(models, random_a, tmp_path):
    jcfg, jp, cfg, tp = models[random_a]
    prompts = _prompts(23)
    jr = JaxEngine(cfg=jcfg, params=jp, dram_capacity_gb=0.5,
                   ssd_dir=str(tmp_path / "jax")).generate(prompts, gen_len=4)
    eng = M2CacheEngine(cfg=cfg, params=tp, dram_capacity_gb=0.5,
                        ssd_dir=str(tmp_path / "torch"), device="cpu")
    tr = eng.generate(prompts, gen_len=4)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    assert tr.modeled_s == jr.modeled_s
    assert tr.cache_stats == jr.cache_stats
    assert tr.carbon == jr.carbon
    assert tr.tokens_per_s == jr.tokens_per_s
    # the SSD tier holds the same bank files, byte for byte
    for name in ("wg_i4", "wd_i8", "wu_fp"):
        a = (tmp_path / "jax" / f"L0001.{name}.bin").read_bytes()
        b = (tmp_path / "torch" / f"L0001.{name}.bin").read_bytes()
        assert a == b, name


@pytest.mark.parametrize("paper_model,mode,policy", [
    ("llama-7b", "m2cache", "atu"), ("llama-13b", "m2cache", "lru"),
    ("llama-7b", "m2cache", "none"), ("llama-13b", "zero_infinity", "atu")])
def test_engine_analytic_modes_match_reference(paper_model, mode, policy,
                                               tmp_path):
    kw = dict(paper_model=paper_model, mode=mode, hbm_policy=policy,
              dram_capacity_gb=6.0, seed=3)
    jr = JaxEngine(ssd_dir=str(tmp_path / "jax"), **kw).generate(gen_len=6)
    tr = M2CacheEngine(ssd_dir=str(tmp_path / "torch"), **kw).generate(
        gen_len=6)
    assert tr.modeled_s == jr.modeled_s
    assert tr.cache_stats == jr.cache_stats
    assert tr.carbon == jr.carbon


def test_engine_no_ssd_matches_reference(models, tmp_path):
    jcfg, jp, cfg, tp = models[True]
    prompts = _prompts(24, B=1, S=6)
    jr = JaxEngine(cfg=jcfg, params=jp, use_ssd=False, dram_capacity_gb=0.5,
                   ssd_dir=str(tmp_path / "jax")).generate(prompts, gen_len=3)
    tr = M2CacheEngine(cfg=cfg, params=tp, use_ssd=False,
                       dram_capacity_gb=0.5, ssd_dir=str(tmp_path / "torch"),
                       device="cpu").generate(prompts, gen_len=3)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    assert tr.modeled_s == jr.modeled_s


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "qwen2.5-14b", "--tiny", "--device", "cpu",
          "--gen-len", "3", "--prompt-len", "5", "--batch", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["tokens_per_s_modeled"] > 0
    assert set(out) == {"tokens_per_s_modeled", "modeled_s", "wall_s",
                        "cache", "carbon_g"}
    assert out["cache"]["ssd_bytes_read"] > 0


def test_serve_cli_analytic_matches_reference_cli(capsys, monkeypatch):
    from repro.launch import serve as jax_serve
    from repro_torch.launch.serve import main
    argv = ["--paper-model", "llama-13b", "--gen-len", "4"]
    main(argv + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jax_serve.main()
    theirs = json.loads(capsys.readouterr().out)
    for key in ("tokens_per_s_modeled", "modeled_s", "cache", "carbon_g"):
        assert ours[key] == theirs[key], key


def test_serve_run_returns_engine_and_tokens():
    from repro_torch.launch.serve import build_parser, run
    args = build_parser().parse_args(["--arch", "qwen2.5-14b", "--tiny",
                                      "--device", "cpu", "--gen-len", "2"])
    summary, res, eng = run(args)
    assert res.tokens.shape == (1, 2)
    assert eng.runner is not None and eng.device.type == "cpu"
    assert summary["modeled_s"] == res.modeled_s
