"""The generator: one seed gives one schedule; every seed gives the mix's
set of sizes; the port receives only tokens."""
import numpy as np
import pytest
import torch

import bench_tiny as tiny
from portbench.harness import main as M
from portbench.harness import spec as SP
from portbench.harness import traffic as TR

SEEDS = (0, 12, 2**31 + 3, 3 * 2**40 + 1, -5)


@pytest.mark.parametrize("name", ["prefill-512-4k", "prefill-2k-8k"])
def test_prompt_lengths_span_the_mix(name):
    t = SP.traffic(name)
    sizes = TR.prompt_lengths(t)
    assert len(sizes) == t["sizes"] and sizes == sorted(sizes)
    assert sizes[0] == t["min_tokens"] and sizes[-1] == t["max_tokens"]
    ratios = np.diff(np.log(sizes))
    assert np.allclose(ratios, ratios.mean(), atol=2e-3)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_seed_one_schedule(seed):
    t = SP.traffic("prefill-512-4k")
    a = [TR.prompt(t, 32768, seed, i) for i in range(40)]
    b = [TR.prompt(t, 32768, seed, i) for i in range(40)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    d = SP.traffic("decode-192x32k")
    assert np.array_equal(TR.first_tokens(d, 152064, seed),
                          TR.first_tokens(d, 152064, seed))


def test_seeds_reorder_the_same_sizes():
    t = SP.traffic("prefill-2k-8k")
    n = t["sizes"]
    orders = []
    for seed in SEEDS:
        lens = [TR.prompt_length(t, seed, i) for i in range(2 * n)]
        assert sorted(lens[:n]) == sorted(lens[n:]) == TR.prompt_lengths(t)
        orders.append(lens)
    assert len({tuple(o) for o in orders}) == len(SEEDS)
    ids = [TR.prompt(t, 152064, s, 0) for s in SEEDS[:2]]
    assert not np.array_equal(ids[0][:100], ids[1][:100])


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_the_port_receives_only_tokens(kind, monkeypatch):
    """Every call into the port's model takes the token ids, its own cache
    and the serving mode: no length, schedule or seed."""
    from repro_torch.models import transformer as T
    seen = []
    real = T.forward

    def spy(cfg, params, tokens, **kw):
        seen.append((tokens.dtype, tuple(tokens.shape), sorted(kw)))
        return real(cfg, params, tokens, **kw)
    monkeypatch.setattr(T, "forward", spy)
    cfg = tiny.config()
    traffic = tiny.decode_traffic() if kind == "decode" else \
        tiny.prefill_traffic()
    checks = {"sample": 2, "logit_steps": 1, "logit_positions": 1}
    runner = M.setup(cfg, traffic, checks, 4, "cpu")
    runner.window(60.0, False, limit=3)
    assert seen
    for dtype, shape, keys in seen:
        assert dtype == torch.int32 and len(shape) == 2
        assert keys == ["cache", "m2", "mode"]
    if kind == "decode":
        assert all(shape == (4, 1) for _, shape, _ in seen)
