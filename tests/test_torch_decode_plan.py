"""The decode attention kernel's plan, its wrapper's checks and the decode
step's mask, on the CPU.

``kernels/flash_decode._plan`` sets the slots a block takes (its range)
and the depth of its copy ring from one row's shape and the card's SM
count, and nothing else, so a row's bits on the card do not depend on the
rows beside it. The wrapper is run here up to the launch, with the launch
replaced by a recorder, to show that B and the lengths never reach the
plan. ``models/transformer.forward(mode="decode")`` builds the slot mask
once (``decode_slots``) and every layer shares it; the forward still
equals the reference. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""
import ctypes
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import transformer as T


def test_plan_takes_one_rows_shape_only():
    assert list(inspect.signature(fd._plan).parameters) == [
        "S", "Hkv", "G", "D", "sms", "dtype"]


def test_main_path_plans():
    # serve decode: a 145-slot cache in 5 ranges of one tile, a ring of one
    assert fd._plan(145, 8, 5, 128, 132) == fd.Plan(32, 1)
    assert fd.ranges(145, 32) == 5
    # the server's 128-slot bucket: 4 ranges of one tile
    assert fd._plan(128, 8, 5, 128, 132) == fd.Plan(32, 1)
    # 4 K slots: 16 ranges of 8 tiles; 32 K: 16 of 64 tiles, so that one
    # row alone puts a block on 128 of the 132 SMs, one wave
    assert fd._plan(4096, 8, 5, 128, 132) == fd.Plan(256, 3)
    assert fd._plan(32768, 8, 5, 128, 132) == fd.Plan(2048, 3)
    assert fd.ranges(4096, 256) == fd.ranges(32768, 2048) == 16


@pytest.mark.parametrize("S", [1, 37, 145, 1000, 4096, 32768, 200000])
@pytest.mark.parametrize("Hkv", [1, 2, 8])
def test_ranges_cover_the_buffer_in_order(S, Hkv):
    plan = fd._plan(S, Hkv, 5, 128, 132)
    R = plan.range_slots
    assert R % fd.TILE == 0 and fd.TILE <= R <= fd.MAX_RANGE_TILES * fd.TILE
    n = fd.ranges(S, R)
    assert 1 <= n <= fd.MAX_RANGES
    bounds = [(r * R, min(S, (r + 1) * R)) for r in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    assert all(a < b for a, b in bounds)
    assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))
    # no range is wider than the buffer rounded up to a tile
    tiles = math.ceil(S / fd.TILE)
    assert R <= fd.TILE * tiles
    # one row's blocks fit one wave, and a long row nearly fills it (whole
    # tiles a range cost the rest), or has a range per tile, or the longest
    # ranges
    if R < fd.MAX_RANGE_TILES * fd.TILE:
        assert n * Hkv <= 132
        if S >= 4096:
            assert n * Hkv >= 0.85 * 132 or n == tiles
    # the ring: no deeper than STAGES or a range's tiles; one stage only
    # for one-tile ranges
    per = R // fd.TILE
    assert plan.stages == max(min(fd.STAGES, per), min(2, per))


def test_plan_knob_sets_the_range():
    saved = fd.RANGE_SLOTS
    try:
        fd.RANGE_SLOTS = 256
        assert fd._plan(4096, 8, 5, 128, 132).range_slots == 256
        # never wider than the buffer's tiles
        assert fd._plan(145, 8, 5, 128, 132).range_slots == 160
    finally:
        fd.RANGE_SLOTS = saved


def _record_launches(monkeypatch):
    """Replace the launch by a recorder of its arguments; everything before
    it (checks but the device's, plan, scratch) runs as on the card."""
    calls = []

    def fake(*args):
        calls.append(args[:-1])             # all but the stream
        return 0
    monkeypatch.setattr(fd, "_kernel", lambda: fake)
    monkeypatch.setattr(fd, "_on_device", lambda *a: None)
    monkeypatch.setattr(fd, "_scratch_cache", {})
    monkeypatch.setattr(build, "sm_count", lambda device: 132)

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _Stream)
    return calls


@pytest.mark.parametrize("S,want", [(145, (32, 1)), (4096, (256, 3))])
def test_plan_is_the_same_for_any_batch_and_any_lengths(monkeypatch, S, want):
    calls = _record_launches(monkeypatch)
    rng = np.random.default_rng(0)
    for B in (1, 4, 3):
        q = torch.zeros(B, 8, 5, 128)
        kv = torch.zeros(B, S, 8, 128)
        slots = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
        lengths = torch.from_numpy(rng.integers(0, S, B).astype(np.int32))
        fd.flash_decode(q, kv, kv, slots, lengths)
    # (B, S, Hkv, G, D, range, stages, head groups, scale, softcap) of each
    # launch
    assert [c[10:] for c in calls] == [
        (B, S, 8, 5, 128, *want, 1, 1 / math.sqrt(128), 0.0)
        for B in (1, 4, 3)]
    # partials are sized for the batch, from the same range
    n = fd.ranges(S, want[0])
    if n > 1:
        assert calls[1][7] >= 4 * 8 * n * 5 * 130
        assert calls[1][9] >= 4 * 8


def _decode(**kw):
    """flash_decode on CPU tensors of a small decode step, with ``kw``
    replacing any of q, k, v, slots, lengths."""
    args = {"q": torch.zeros(2, 2, 4, 32), "k": torch.zeros(2, 40, 2, 32),
            "v": torch.zeros(2, 40, 2, 32),
            "slots": torch.zeros(2, 40, dtype=torch.int32),
            "lengths": torch.zeros(2, dtype=torch.int32)}
    args.update(kw)
    return fd.flash_decode(*args.values())


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("q_dtype", "float32"),
    ("v_dtype", "float32"),
    ("non_contiguous", "contiguous"),
    ("kv_shape", "do not match"),
    ("q_dim", "4-D"),
    ("head_dim", r"head dim 48 not in \(32, 64, 128, 256\)"),
    ("heads", "G=9"),
    ("slots_dtype", "slot_positions"),
    ("slots_shape", "slot_positions"),
    ("lengths_dtype", "lengths"),
    ("lengths_shape", "lengths"),
    ("device", "on cpu"),
])
def test_wrapper_raises_and_never_falls_back(case, match):
    """On CPU tensors, a wrong dtype, shape or layout, or inputs on two
    devices, the wrapper raises: no plain-version fallback (that lives in
    kernels/ops.py, for CPU tensors only)."""
    kw = {"cpu": {},
          "q_dtype": {"q": torch.zeros(2, 2, 4, 32, dtype=torch.float64)},
          "v_dtype": {"v": torch.zeros(2, 40, 2, 32, dtype=torch.float16)},
          "non_contiguous": {"k": torch.zeros(2, 2, 40, 32).transpose(1, 2)},
          "kv_shape": {"v": torch.zeros(2, 40, 4, 32)},
          "q_dim": {"q": torch.zeros(2, 8, 32)},
          "head_dim": {"q": torch.zeros(2, 2, 4, 48),
                       "k": torch.zeros(2, 40, 2, 48),
                       "v": torch.zeros(2, 40, 2, 48)},
          "heads": {"q": torch.zeros(2, 2, 9, 32)},
          "slots_dtype": {"slots": torch.zeros(2, 40, dtype=torch.int64)},
          "slots_shape": {"slots": torch.zeros(2, 39, dtype=torch.int32)},
          "lengths_dtype": {"lengths": torch.zeros(2)},
          "lengths_shape": {"lengths": torch.zeros(1, dtype=torch.int32)},
          "device": {"lengths": torch.zeros(2, dtype=torch.int32,
                                            device="meta")},
          }[case]
    with pytest.raises(ValueError, match=match):
        _decode(**kw)


# --- query heads spread over head groups (G up to 16) -------------------

#: (Hkv, G) of every registered config: qwen2.5 G = 5, internvl2-1b 7,
#: command-r-35b 8, mistral-large-123b 12
ARCH_HEADS = {5: 8, 7: 2, 8: 8, 12: 8}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", sorted(ARCH_HEADS))
def test_head_group_plan_takes_one_rows_shape(monkeypatch, G, D):
    """Up to 8 query heads take one block, 12 two blocks of 6; the plan of
    every registered G is the same for any B and any lengths, and D does not
    change it."""
    Hkv, S = ARCH_HEADS[G], 145
    plan = fd._plan(S, Hkv, G, D, 132)
    assert plan.groups == (1 if G <= fd.MAX_HEADS else 2)
    assert plan == fd._plan(S, Hkv, G, 192 - D, 132)
    calls = _record_launches(monkeypatch)
    rng = np.random.default_rng(G)
    for B in (1, 4, 3):
        q = torch.zeros(B, Hkv, G, D)
        kv = torch.zeros(B, S, Hkv, D)
        slots = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
        lengths = torch.from_numpy(rng.integers(0, S, B).astype(np.int32))
        fd.flash_decode(q, kv, kv, slots, lengths)
    assert [c[10:] for c in calls] == [
        (B, S, Hkv, G, D, *plan, 1 / math.sqrt(D), 0.0) for B in (1, 4, 3)]
    # a row's head groups fit one wave of the card's SMs
    assert fd.ranges(S, plan.range_slots) * Hkv * plan.groups <= 132


def _emulated_kernel(q, k, v, slots, lengths, writes):
    """A launch that does what csrc/flash_decode.cu does, in float64 from
    the pointers it is given: block (range, y, row) takes head group y, KV
    head y // groups, and query heads y * G/groups .. of the row (q and out
    seen as (B, Hkv * groups, G / groups, D)); a group's ranges are
    combined into its heads' output. ``writes`` counts each head's stores."""
    def launch(*args):
        (B, S, Hkv, G, D, rs, _, groups) = args[10:18]
        hb = G // groups
        out = np.ctypeslib.as_array(
            (ctypes.c_float * (B * Hkv * G * D)).from_address(args[5]))
        out = out.reshape(B, Hkv * groups, hb, D)
        qg = q.double().numpy().reshape(B, Hkv * groups, hb, D)
        n = fd.ranges(S, rs)
        for b in range(B):
            for y in range(Hkv * groups):
                h = y // groups
                kk = k[b, :, h].double().numpy()
                vv = v[b, :, h].double().numpy()
                part = [np.arange(r * rs, min(S, (r + 1) * rs))
                        for r in range(n)]
                cols = np.concatenate(part)
                assert np.array_equal(cols, np.arange(S))
                pos = slots[b].numpy()[cols]
                ok = (pos >= 0) & (pos <= int(lengths[b]))
                sc = qg[b, y] @ kk[cols].T / math.sqrt(D)
                sc = np.where(ok[None], sc, -1e30)
                w = np.exp(sc - sc.max(-1, keepdims=True))
                out[b, y] = (w / w.sum(-1, keepdims=True)) @ vv[cols]
                writes[b, h * G + (y % groups) * hb:
                       h * G + (y % groups + 1) * hb] += 1
        return 0
    return launch


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", sorted(ARCH_HEADS))
def test_head_groups_cover_every_query_head_once(monkeypatch, G, D):
    """The wrapper's launch, emulated block by block as the kernel maps
    head groups, stores each query head of each KV head once and gives the
    plain version's output (within 1e-5: fp32 inputs, float64 sums)."""
    from repro_torch.kernels import ref
    _record_launches(monkeypatch)
    Hkv, S, B = ARCH_HEADS[G], 145, 2
    g = torch.Generator().manual_seed(G * D)
    q = torch.randn(B, Hkv, G, D, generator=g)
    k, v = (torch.randn(B, S, Hkv, D, generator=g) for _ in range(2))
    slots = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    slots[1, 5:9] = -1
    lengths = torch.tensor([S - 1, 100], dtype=torch.int32)
    writes = np.zeros((B, Hkv * G), dtype=int)
    monkeypatch.setattr(fd, "_kernel", lambda: _emulated_kernel(
        q, k, v, slots, lengths, writes))
    got = fd.flash_decode(q, k, v, slots, lengths)
    assert (writes == 1).all()
    torch.testing.assert_close(got, ref.flash_decode_ref(q, k, v, slots,
                                                         lengths),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("G", [9, 11, 13, 17, 24])
def test_g_the_kernel_cannot_take_raises_before_any_launch(monkeypatch, G):
    """A G that does not split evenly into blocks of at most 8 heads, or
    one above 16, raises ValueError from the plan and from the wrapper,
    before a launch."""
    calls = _record_launches(monkeypatch)
    with pytest.raises(ValueError, match=f"G={G}"):
        fd._plan(145, 8, G, 128, 132)
    with pytest.raises(ValueError, match=f"G={G}"):
        fd.flash_decode(torch.zeros(1, 2, G, 64), torch.zeros(1, 40, 2, 64),
                        torch.zeros(1, 40, 2, 64),
                        torch.zeros(1, 40, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32))
    assert calls == []


def test_heads_knob_sets_the_groups(monkeypatch):
    monkeypatch.setattr(fd, "HEADS_PER_BLOCK", 4)
    assert fd._plan(145, 8, 12, 128, 132).groups == 3
    monkeypatch.setattr(fd, "HEADS_PER_BLOCK", 5)
    with pytest.raises(ValueError, match="G=12"):
        fd._plan(145, 8, 12, 128, 132)


# --- the decode step's mask, built once per forward ---------------------


def test_decode_slots_is_the_per_layer_mask_it_replaces():
    pos0 = torch.tensor([0, 5, 15, 9])
    slots, lengths = T.decode_slots(pos0, 16)
    assert slots.dtype == lengths.dtype == torch.int32
    assert slots.is_contiguous() and tuple(slots.shape) == (4, 16)
    kv_pos = torch.arange(16)[None].expand(4, 16)
    valid = kv_pos <= pos0[:, None]
    assert torch.equal(slots, torch.where(valid, kv_pos, -1).to(torch.int32))
    assert torch.equal(lengths, pos0.to(torch.int32))


def test_decode_forward_builds_the_mask_once_and_equals_reference(
        monkeypatch):
    """Two rows at their own positions decode three greedy tokens with
    ``rows=True`` (the server's batch): logits within 1e-4 and active sets
    equal to the reference's one-row decode of each row; the slot mask is
    built once per forward, and every layer gets that one tensor."""
    jcfg = jax_config("qwen2.5-14b", tiny=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32,
                        m2=True)
    pred = jp["layers"]["pattern"][0]["ffn"]["pred"]
    A = np.random.default_rng(11).standard_normal(pred["A"].shape)
    pred["A"] = jnp.asarray(A.astype(np.float32) / np.sqrt(A.shape[1]))
    cfg = get_config("qwen2.5-14b", tiny=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    from repro_torch.core.engine_model import _stack_rows

    rng = np.random.default_rng(12)
    buf = 24
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
               for n in (7, 12)]
    jcs, jls, tcs = [], [], []
    for p in prompts:
        jc = JT.init_cache(jcfg, 1, buf, dtype=jnp.float32)
        jl, jc, _ = JT.forward(jcfg, jp, jnp.asarray(p), cache=jc,
                               mode="prefill", m2=True)
        jcs.append(jc)
        jls.append(jl)
        tc = T.init_cache(cfg, 1, buf, device="cpu")
        T.forward(cfg, tp, torch.from_numpy(p), cache=tc, mode="prefill")
        tcs.append(tc)
    tcache = _stack_rows(tcs)

    built, seen = [], []
    real_slots, real_layer = T.decode_slots, T.attn_layer
    monkeypatch.setattr(T, "decode_slots",
                        lambda *a: built.append(real_slots(*a)) or built[-1])

    def layer(*a, **kw):
        seen.append(kw["slots"])
        return real_layer(*a, **kw)
    monkeypatch.setattr(T, "attn_layer", layer)

    nxt = [np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
           for jl in jls]
    for step in range(3):
        built.clear()
        seen.clear()
        tokens = torch.from_numpy(np.stack([n[0] for n in nxt])[:, None])
        tl, tcache, ta = T.forward(cfg, tp, tokens, cache=tcache,
                                   mode="decode", rows=True)
        assert len(built) == 1 and len(seen) == cfg.num_layers
        assert all(s is built[0] for s in seen)
        for r in range(2):
            jl, jcs[r], ja = JT.forward(jcfg, jp, jnp.asarray(nxt[r][:, None]),
                                        cache=jcs[r], mode="decode", m2=True)
            np.testing.assert_allclose(tl[r:r + 1].numpy(), np.asarray(jl),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(
                ta["active_idx"]["pattern"][0][r].numpy(),
                np.asarray(ja["active_idx"]["pattern"][0]))
            nxt[r] = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(
                np.int32)
            assert int(torch.argmax(tl[r, -1])) == int(nxt[r][0])
    assert tcache["pos"].tolist() == [10, 15]


def test_head_dim_256_caps_the_ring():
    """At D = 256 a 32-slot K+V tile is 66.6 KB: the ring holds 3 tiles in
    a block's shared memory (6 below), and G = 10 takes two head groups of
    5; the rest of the plan is D = 128's."""
    assert [fd.max_stages(D) for D in (32, 64, 128, 256)] == [6, 6, 6, 3]
    for S in (145, 2048, 4096):
        p128, p256 = (fd._plan(S, 1, 10, D, 132) for D in (128, 256))
        assert p256.groups == p128.groups == 2
        assert p256.range_slots == p128.range_slots
        assert p256.stages == min(p128.stages, 3)
    saved = fd.STAGES
    try:
        fd.STAGES = 6
        assert fd._plan(32768, 1, 10, 256, 132).stages == 3
        assert fd._plan(32768, 1, 10, 128, 132).stages == 6
    finally:
        fd.STAGES = saved
    with pytest.raises(ValueError, match="CUDA"):
        _decode(q=torch.zeros(2, 1, 10, 256), k=torch.zeros(2, 40, 1, 256),
                v=torch.zeros(2, 40, 1, 256))


#: (S, Hkv, G, D) of every decode row the paths give the kernel: the serve
#: step and the server's bucket (qwen2.5-14b and its kin, mistral's G = 12,
#: internvl2's G = 7 at D = 64, command-r's G = 8), the 4 K, 32 K and
#: long_500k 8192-slot rows, recurrentgemma-2b's D = 256 (the serve step
#: and the window's 2048-slot ring), musicgen's G = 1 at D = 64
PATH_ROWS = [(145, 8, 5, 128), (128, 8, 5, 128), (145, 8, 12, 128),
             (145, 2, 7, 64), (145, 8, 8, 128), (4096, 8, 5, 128),
             (32768, 8, 5, 128), (8192, 8, 5, 128), (145, 1, 10, 256),
             (2048, 1, 10, 256), (209, 32, 1, 64), (145, 8, 6, 128)]


@pytest.mark.parametrize("S,Hkv,G,D", PATH_ROWS)
@pytest.mark.parametrize("stages", [1, 3, 6])
def test_bf16_plan_is_the_fp32_plan_but_the_ring(S, Hkv, G, D, stages):
    """bf16 K and V: the same ranges and head groups as fp32 (one row's
    shape); the ring is each warp's, in 16-slot steps: ``STAGES_BF16``, no
    deeper than the warp's steps of a range (steps warp, warp + 8, ...) nor
    than ``max_stages(D, bf16)`` (8 warps' steps of K and V beside the
    block's fixed part: 6, 6, 3, 1 at D = 32 to 256), and 1 at least."""
    assert [fd.max_stages(D, torch.bfloat16) for D in (32, 64, 128, 256)] \
        == [6, 6, 3, 1]
    saved = fd.STAGES_BF16
    try:
        fd.STAGES_BF16 = stages
        p32 = fd._plan(S, Hkv, G, D, 132)
        p16 = fd._plan(S, Hkv, G, D, 132, torch.bfloat16)
    finally:
        fd.STAGES_BF16 = saved
    assert (p16.range_slots, p16.groups) == (p32.range_slots, p32.groups)
    steps = math.ceil(p16.range_slots / fd.BF16_STEP / fd.WARPS)
    assert p16.stages == max(1, min(stages, steps,
                                    fd.max_stages(D, torch.bfloat16)))
    assert 1 <= p16.stages <= fd.max_stages(D, torch.bfloat16)


@pytest.mark.parametrize("S", [145, 8192])
def test_bf16_plan_is_the_same_for_any_batch_and_any_lengths(monkeypatch, S):
    """The bf16 entry point gets one row's plan whatever B and the lengths,
    the fp32 plan's range."""
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(fd, "_kernel", lambda bf16=False: (
        lambda *a: calls.append((bf16,) + a[:-1]) or 0))
    rng = np.random.default_rng(1)
    for B in (1, 3):
        q = torch.zeros(B, 8, 5, 128, dtype=torch.bfloat16)
        kv = torch.zeros(B, S, 8, 128, dtype=torch.bfloat16)
        slots = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
        lengths = torch.from_numpy(rng.integers(0, S, B).astype(np.int32))
        fd.flash_decode(q, kv, kv, slots, lengths)
    want = fd._plan(S, 8, 5, 128, 132, torch.bfloat16)
    assert [c[0] for c in calls] == [True, True]
    assert {c[12:] for c in calls} == {
        (S, 8, 5, 128, want.range_slots, want.stages, 1, 1 / math.sqrt(128),
         0.0)}
    assert want.range_slots == fd._plan(S, 8, 5, 128, 132).range_slots
