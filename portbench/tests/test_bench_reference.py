"""The plain reference against the port on small configurations on the CPU,
in float32: a whole-prompt prefill's K/V, sets and last logits, and decode
steps followed from the program's cache (``harness.check``)."""
import pytest
import torch

import bench_tiny as tiny
from portbench.harness import check as C
from portbench.harness import main as M
from portbench.harness import program as P
from portbench.harness import traffic as TR

CONFIGS = ("qwen2.5-14b-2l-bf16", "mistral-large-123b-11l-bf16")
EXACT = 1e-5


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_matches_port(name):
    cfg = tiny.config(name, dtype="float32")
    seed = 2**31 + 11
    mc = P.model_config(cfg)
    params = P.build_params(cfg, seed, "cpu", torch.float32)
    cases = []
    for i, n in enumerate((5, 37)):
        ids = torch.as_tensor(TR.rng(seed, i).integers(0, cfg["vocab"], n))
        logits, cache, sets = P.prefill(mc, params, ids[None].int(),
                                        torch.float32)
        cases.append(C.Case(ids, torch.arange(n), False,
                            {w: P.layer_kv(cache, w)[:, 0]
                             for w in ("k", "v")}, sets, logits,
                            torch.arange(n), logits.argmax(dim=-1)))
    nums = C.compare(cfg, seed, "cpu", cases)["fp32"]["numbers"]
    assert all(v < EXACT for v in nums.values()), nums


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_steps_match_port(name):
    cfg = tiny.config(name, dtype="float32")
    traffic = tiny.decode_traffic(history=60, slots=64, reset_to=60)
    seed = 7
    checks = tiny.checks("decode", False)
    runner = M.setup(cfg, traffic, checks, seed, "cpu")
    win = runner.window(60.0, False, limit=7)     # past a return to 60
    assert [it["pos"] for it in win.items] == [60, 61, 62, 63, 60, 61, 62]
    nums = M.compare("decode", runner, win, cfg, traffic, checks, seed,
                     "cpu")["fp32"]["numbers"]
    assert all(v < EXACT for v in nums.values()), nums


def test_set_gap_reads_swaps_by_their_scores():
    scores = torch.tensor([5.0, 4.0, 3.0, 2.9, 1.0, 0.0])
    sizes = {"k": 3, "fp": 1, "int8": 1, "int4": 1}
    assert C.set_gap(scores, torch.tensor([0, 1, 2]), sizes) == 0.0
    swapped = C.set_gap(scores, torch.tensor([0, 1, 3]), sizes)
    assert swapped == pytest.approx(0.1 / float(scores.std()))
    assert C.set_gap(scores, torch.tensor([0, 0, 1]), sizes) == float("inf")


def test_sample_takes_the_last_segment_and_its_ends():
    steps = [{"segment": 0}] * 5 + [{"segment": 1}] * 20
    picked = C.sample_steps(steps, 5, 2, seed=3)
    assert len(picked) == 5 and picked[0] == 5 and picked[-2:] == [23, 24]


def test_sample_of_requests_holds_the_longest():
    t = tiny.prefill_traffic(sizes=8)
    for seed in range(5):
        picked = C.sample_requests(t, 3, seed)
        lengths = [TR.prompt_length(t, seed, i) for i in range(8)]
        assert len(picked) == 3 and lengths.index(max(lengths)) in picked
