"""The prefill attention kernels' plan and argument checks, on the CPU.

``kernels/flash_attention._plan`` (whole prompt) and
``kernels/chunk_attention._plan`` (a chunk at an offset) set a block's
heads, query sub-tiles and key split. They take one row's shape (and the
card's SM count) and nothing else, so a row's bits on the card do not
depend on the rows beside it or on where its chunk starts. The wrappers are
run here up to the launch, with the launch replaced by a recorder, to show
that B and pos0 never reach it. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""
import inspect
import math

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import chunk_attention as ca
from repro_torch.kernels import flash_attention as fa

SHAPES = [  # (S, Skv, Hq, Hkv, D): main paths, tiny config, ragged G
    (128, 128, 40, 8, 128), (16, 256, 40, 8, 128), (16, 2048, 40, 8, 128),
    (2048, 2048, 40, 8, 128), (12, 12, 8, 2, 32), (8, 64, 8, 2, 32),
    (77, 77, 10, 2, 128), (70, 70, 4, 4, 32), (50, 50, 16, 1, 64),
    (16, 45, 8, 2, 64), (1, 1, 64, 8, 128), (512, 4096, 64, 8, 128)]


def test_plans_take_one_rows_shape_only():
    assert list(inspect.signature(fa._plan).parameters) == ["S", "Hq", "Hkv",
                                                            "D", "sms"]
    assert list(inspect.signature(ca._plan).parameters) == [
        "S", "Skv", "Hq", "Hkv", "D", "sms"]


def test_main_path_plans():
    # a 128-token row is 8 query tiles x 8 KV heads, one wave: paired
    assert fa._plan(128, 40, 8, 128, 132) == fa.Plan(5, 1, 0, True)
    # a 2048-token row fills the card 8 times over: not paired
    assert fa._plan(2048, 40, 8, 128, 132) == fa.Plan(5, 1, 0, False)
    assert ca._plan(16, 256, 40, 8, 128, 132) == fa.Plan(5, 1, 32)
    # a longer buffer takes wider ranges: at most MAX_RANGES of them
    assert ca._plan(16, 2048, 40, 8, 128, 132) == fa.Plan(5, 1, 128)
    # enough blocks without a split: none
    assert ca._plan(512, 4096, 40, 8, 128, 132).split == 0


@pytest.mark.parametrize("S,Skv,Hq,Hkv,D", SHAPES)
def test_plan_covers_every_head_within_a_block(S, Skv, Hq, Hkv, D):
    G = Hq // Hkv
    for plan in (fa._plan(S, Hq, Hkv, D, 132),
                 ca._plan(S, Skv, Hq, Hkv, D, 132)):
        hb, qsub = plan.heads_per_block, plan.qsub
        assert 1 <= hb * qsub <= fa.MAX_WARPS
        groups = math.ceil(G / hb)
        assert (groups - 1) * hb < G <= groups * hb
        # head groups are as even as the warp limit allows
        assert groups == math.ceil(G / fa.MAX_WARPS)
        assert qsub == 1 or 16 * (qsub - 1) < S
    whole = fa._plan(S, Hq, Hkv, D, 132)
    q_tiles = math.ceil(S / (16 * whole.qsub))
    assert whole.split == 0
    assert whole.pair == (q_tiles > 1 and q_tiles * Hkv * groups <= 132)
    assert not ca._plan(S, Skv, Hq, Hkv, D, 132).pair
    split = ca._plan(S, Skv, Hq, Hkv, D, 132).split
    assert split % fa.BKV == 0
    if split:
        assert split < Skv and math.ceil(Skv / split) <= ca.MAX_RANGES


def _record_launches(monkeypatch, module):
    """Replace the launch by a recorder of its plan arguments; everything
    before it (checks, plan, scratch) runs as on the card."""
    calls = []

    def fake(*args):
        calls.append(args[:-1])             # all but the stream
        return 0
    monkeypatch.setattr(module, "_kernel", lambda bf16=False: fake)
    monkeypatch.setattr(module, "check_inputs", lambda *a: None)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _Stream)
    return calls


def test_chunk_plan_is_the_same_for_any_batch_and_any_pos0(monkeypatch):
    calls = _record_launches(monkeypatch, ca)
    monkeypatch.setattr(ca, "_counts", {})
    for B, pos0 in ((1, [0]), (1, [240]), (4, [0, 48, 96, 112]),
                    (4, [240, 0, 7, 100])):
        q = torch.zeros(B, 16, 40, 128)
        kv = torch.zeros(B, 256, 8, 128)
        ca.chunk_attention(q, kv, kv, torch.tensor(pos0, dtype=torch.int32))
    assert [c[-3:] for c in calls] == [(5, 1, 32)] * 4   # hb, qsub, split


def test_whole_prompt_plan_is_the_same_for_any_batch(monkeypatch):
    calls = _record_launches(monkeypatch, fa)
    for B in (1, 4, 7):
        q = torch.zeros(B, 128, 40, 128)
        kv = torch.zeros(B, 128, 8, 128)
        fa.flash_attention(q, kv, kv)
    assert [c[-3:] for c in calls] == [(5, 1, 1)] * 3    # hb, qsub, pair


def _chunk(**kw):
    """chunk_attention on CPU tensors of a small chunk, with ``kw``
    replacing any of q, k, v, pos0."""
    args = [torch.zeros(2, 16, 8, 32), torch.zeros(2, 40, 2, 32),
            torch.zeros(2, 40, 2, 32), torch.zeros(2, dtype=torch.int32)]
    for i, name in enumerate(("q", "k", "v", "pos0")):
        if name in kw:
            args[i] = kw[name]
    return ca.chunk_attention(*args)


def _whole(**kw):
    """flash_attention on CPU tensors of a small prompt, with ``kw``
    replacing any of q, k, v (and giving the window)."""
    args = [torch.zeros(2, 16, 8, 32), torch.zeros(2, 16, 2, 32),
            torch.zeros(2, 16, 2, 32)]
    for i, name in enumerate(("q", "k", "v")):
        if name in kw:
            args[i] = kw[name]
    return fa.flash_attention(*args, window=kw.get("window", 0))


@pytest.mark.parametrize("form", ["whole", "chunk"])
@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("head_dim", r"head dim 48 not in \(32, 64, 128(, 256)?\)"),
    ("heads", "not a multiple"),
    ("kv_shape", "do not match"),
    ("non_contiguous", "contiguous"),
    ("dtype", "float32"),
])
def test_wrappers_raise_and_never_fall_back(form, case, match):
    """On CPU tensors, wrong shapes, head dims outside (32, 64, 128) (and
    256 for the whole prompt), a non-contiguous or non-fp32 input the
    wrappers raise: no plain-version fallback (that lives in
    kernels/ops.py, for CPU tensors only)."""
    fn = _whole if form == "whole" else _chunk
    skv = 16 if form == "whole" else 40
    kw = {"cpu": {},
          "head_dim": {"q": torch.zeros(2, 16, 8, 48),
                       "k": torch.zeros(2, skv, 2, 48),
                       "v": torch.zeros(2, skv, 2, 48)},
          "heads": {"q": torch.zeros(2, 16, 7, 32)},
          "kv_shape": {"v": torch.zeros(2, skv, 4, 32)},
          "non_contiguous": {"q": torch.zeros(2, 8, 16, 32).transpose(1, 2)},
          "dtype": {"k": torch.zeros(2, skv, 2, 32, dtype=torch.float64)},
          }[case]
    with pytest.raises(ValueError, match=match):
        fn(**kw)


def test_chunk_wrapper_checks_pos0_and_length():
    with pytest.raises(ValueError, match="pos0"):
        _chunk(pos0=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="pos0"):
        _chunk(pos0=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):
        _whole(window=-1)
    with pytest.raises(ValueError, match="16 queries over a buffer of 8"):
        _chunk(k=torch.zeros(2, 8, 2, 32), v=torch.zeros(2, 8, 2, 32))


def test_head_dim_256_plans_two_blocks_of_five_heads():
    """recurrentgemma-2b (G = 10 over one KV head of 256): the shared
    memory holds 5 warps of Q rows beside the K/V ring at D = 256, so G =
    10 plans as two blocks of 5 heads, one 16-row sub-tile each, as it does
    at D = 128; the chunk form does not take D = 256 and says so."""
    assert [fa.max_warps(D) for D in (32, 64, 128, 256)] == [8, 8, 8, 5]
    for D in (128, 256):
        for S in (128, 2176):
            plan = fa._plan(S, 10, 1, D, 132)
            assert (plan.heads_per_block, plan.qsub, plan.split) == (5, 1, 0)
    assert fa._plan(128, 10, 1, 256, 132).pair
    assert not fa._plan(2176, 10, 1, 256, 132).pair
    with pytest.raises(ValueError, match=r"head dim 256 not in \(32, 64, "
                                         r"128\)"):
        _chunk(q=torch.zeros(2, 16, 10, 256), k=torch.zeros(2, 40, 1, 256),
               v=torch.zeros(2, 40, 1, 256))
    with pytest.raises(ValueError, match="CUDA"):
        _whole(q=torch.zeros(2, 16, 10, 256), k=torch.zeros(2, 16, 1, 256),
               v=torch.zeros(2, 16, 1, 256))


def test_bf16_plans_take_one_rows_shape_only():
    assert list(inspect.signature(fa._plan_bf16).parameters) == [
        "S", "Hq", "Hkv", "D", "sms"]
    assert list(inspect.signature(ca._plan_bf16).parameters) == [
        "S", "Skv", "Hq", "Hkv", "D", "sms"]


def test_bf16_plans_are_the_same_for_any_batch_and_any_pos0(monkeypatch):
    """The bf16 wrappers run up to the launch with bf16 tensors: B and pos0
    never reach the plan."""
    bf = torch.bfloat16
    calls = _record_launches(monkeypatch, ca)
    monkeypatch.setattr(ca, "_counts", {})
    for B, pos0 in ((1, [0]), (1, [240]), (4, [0, 48, 96, 112]),
                    (4, [240, 0, 7, 100])):
        q = torch.zeros(B, 16, 40, 128, dtype=bf)
        kv = torch.zeros(B, 256, 8, 128, dtype=bf)
        ca.chunk_attention(q, kv, kv, torch.tensor(pos0, dtype=torch.int32))
    assert [c[-3:] for c in calls] == [(5, 1, 32)] * 4   # hb, qsub, split
    calls = _record_launches(monkeypatch, fa)
    for B in (1, 4, 7):
        q = torch.zeros(B, 128, 10, 256, dtype=bf)
        kv = torch.zeros(B, 128, 1, 256, dtype=bf)
        fa.flash_attention(q, kv, kv)
    assert [c[-3:] for c in calls] == [(5, 1, 1)] * 3    # hb, qsub, pair


@pytest.mark.parametrize("G", range(1, 17))
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_bf16_plans_cover_every_head_and_fit_shared_memory(D, G):
    """The bf16 kernel's plans (whole prompt; the chunk form at D <= 128)
    for G = 1..16 query heads a KV head: every head in one block of its KV
    head, at most MAX_WARPS warps, and the block's shared memory as the
    kernel reckons it (``smem_bytes``: the bf16 tiles, or the split's
    combine) within the card's 227 KB."""
    Hkv = 2
    plans = [fa._plan_bf16(S, G * Hkv, Hkv, D, 132) for S in (16, 128, 2048)]
    if D in fa.CHUNK_HEAD_DIMS:
        plans += [ca._plan_bf16(S, Skv, G * Hkv, Hkv, D, 132)
                  for S, Skv in ((16, 256), (16, 2048), (512, 4096))]
    for plan in plans:
        hb, qsub = plan.heads_per_block, plan.qsub
        warps = hb * qsub
        assert 1 <= warps <= fa.max_warps(D, bf16=True) <= fa.MAX_WARPS
        groups = math.ceil(G / hb)
        assert (groups - 1) * hb < G <= groups * hb
        assert fa.smem_bytes(D, warps, bf16=True) <= fa.SMEM_BYTES < 232448


def test_head_dim_256_bf16_plan_takes_eight_warps():
    """The bf16 tiles leave room for 8 warps at D = 256, where the fp32
    form takes 5: G = 8 runs in one block of 8 heads at bf16 and in two of
    4 at fp32; G = 10 plans the same at both (two blocks of 5)."""
    assert [fa.max_warps(D, bf16=True) for D in fa.HEAD_DIMS] == [8] * 4
    assert fa._plan_bf16(128, 8, 1, 256, 132)[:2] == (8, 1)
    assert fa._plan(128, 8, 1, 256, 132)[:2] == (4, 1)
    for S in (128, 2176):
        assert fa._plan_bf16(S, 10, 1, 256, 132) == fa._plan(S, 10, 1, 256,
                                                              132)
