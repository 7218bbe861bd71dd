"""qmatmul's plan and its bf16 form's, on the CPU.

``kernels/qmatmul._plan`` picks kernel A or B, the tile and the K split
from one row's shape (M, N, K) and the card's SM count; the bf16 form
(``qmm_gathered_bf16``, kernel B on the bf16 tensor cores) takes the same
plan. The wrapper is run here up to the launch, with the launch replaced
by a recorder, for both dtypes and any row count R: each row's plan
arguments are the same, so a row's bits on the card do not depend on the
rows beside it. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""
import inspect

import pytest
import torch

from repro_torch.core.quantize import quantize_int4, quantize_int8
from repro_torch.kernels import build
from repro_torch.kernels import qmatmul as qm


def _record_launches(monkeypatch):
    """The launch replaced by a recorder of its arguments; everything
    before it (checks, plan, scratch) runs as on the card, but for the
    device check."""
    calls = []

    def fake(*args):
        calls.append(args[:-1])             # all but the stream
        return 0
    require = qm._require
    monkeypatch.setattr(qm, "_kernel", lambda bf16=False: fake)
    monkeypatch.setattr(qm, "_require", lambda cond, msg: require(
        cond or msg == "x must be a CUDA tensor", msg))
    monkeypatch.setattr(build, "sm_count", lambda device: 132)

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _Stream)
    return calls


def test_plan_takes_one_rows_shape_only():
    assert list(inspect.signature(qm._plan).parameters) == [
        "M", "N", "K", "layout", "device"]


@pytest.mark.parametrize("prec", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["col", "row"])
@pytest.mark.parametrize("M", [1, 4, 16, 512])
def test_bf16_plan_is_the_fp32_plan_for_any_row_count(monkeypatch, prec,
                                                      layout, M):
    """fp32 and bf16 x, R = 1, 2 and 4 rows of M, 1037 active neurons of
    3000 (d = 512): the shape and plan arguments the C entry points get
    (M, N, K; kernel, tile, splits, k_split) are one and the same, and
    ``_plan``'s of one row."""
    calls = _record_launches(monkeypatch)
    d, f, n = 512, 3000, 1037
    w32 = torch.randn(f, d) / 16
    for dt in (torch.float32, torch.bfloat16):
        w, s = ((w32.to(dt), None) if prec == "fp" else
                quantize_int8(w32, 1) if prec == "int8" else
                quantize_int4(w32, 1))
        for R in (1, 2, 4):
            x = torch.zeros(R, M, d if layout == "col" else n, dtype=dt)
            idx = torch.stack([torch.randperm(f)[:n] for _ in range(R)]).to(
                torch.int32)
            qm.qmatmul_gathered(x, w, s, idx, precision=prec, layout=layout)
    assert len(calls) == 6
    plans = {tuple(c[5:8]) + tuple(c[11:15]) for c in calls}
    N, K = (n, d) if layout == "col" else (d, n)
    kernel, tile, splits, k_split = qm._plan(M, N, K, layout, "cpu")
    assert plans == {(M, N, K, qm.KERNELS[kernel], tile, splits, k_split)}


def _record_ffn_launches(monkeypatch):
    """The small-M bf16 FFN's three C entry points replaced by recorders
    (name, arguments but the stream); checks and plans run as on the card,
    but for the device check."""
    calls = []

    def fake(name):
        def call(*args):
            calls.append((name, args[:-1]))
            return 0
        return call
    require = qm._require
    monkeypatch.setattr(qm, "_ffn_kernels", lambda: (
        fake("glu"), fake("down"), fake("sum")))
    monkeypatch.setattr(qm, "_require", lambda cond, msg: require(
        cond or msg in ("x must be a CUDA tensor",
                        "h must be a CUDA tensor"), msg))
    monkeypatch.setattr(build, "sm_count", lambda device: 132)

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _Stream)
    return calls


def _tier(prec, f, width, dt=torch.bfloat16, seed=0):
    """A tier's neuron-major bank (f, width) for bf16 x and its scale."""
    w = torch.randn(f, width, generator=torch.Generator().manual_seed(seed))
    return ((w.to(dt), None) if prec == "fp" else
            quantize_int8(w, 1) if prec == "int8" else quantize_int4(w, 1))


@pytest.mark.parametrize("M", [1, 4])
def test_glu_grid_and_plan_take_one_rows_shape(monkeypatch, M):
    """The fused GLU of three tiers (1037, 1037 and 2073 active neurons of
    3000, d = 512) over R = 1, 2 and 4 rows of M, one launch each: the
    shape and plan arguments its C entry gets (the tiers' N, M, K, tile, K
    chunk) are one and the same, the col form's ``_plan`` of one row (the
    kernel's grid: ceil(N / 8) blocks a tier and row, a warp a neuron: 130,
    130 and 260 here, 2 waves on 132 SMs at two blocks an SM); one tier
    alone gets its own N and the others' 0."""
    calls = _record_ffn_launches(monkeypatch)
    d, f, ns = 512, 3000, (1037, 1037, 2073)
    tiers = [(p, *_tier(p, f, d, seed=1), *_tier(p, f, d, seed=2))
             for p in ("fp", "int8", "int4")]
    for R in (1, 2, 4):
        x = torch.zeros(R, M, d, dtype=torch.bfloat16)
        args = []
        for (p, wg, sg, wu, su), n in zip(tiers, ns):
            idx = torch.stack([torch.randperm(f)[:n] for _ in range(R)]).to(
                torch.int32)
            args.append((p, wg, wu, sg, su, idx))
        hs = qm.glu_bf16(x, args)
        assert [tuple(h.shape) for h in hs] == [(R, M, n) for n in ns]
        assert all(h.dtype == torch.bfloat16 for h in hs)
        qm.glu_bf16(x, args[2:])
    assert [c[0] for c in calls] == ["glu"] * 6
    assert [c[1][12] for c in calls] == [1, 1, 2, 2, 4, 4]
    assert [list(c[1][6]) for c in calls[:2]] == [list(ns), [0, 0, ns[2]]]
    plans = {tuple(c[1][13:15]) + tuple(c[1][16:18]) for c in calls}
    _, tile, _, k_chunk = qm._plan(M, ns[0], d, "col", "cpu")
    assert plans == {(M, d, tile, k_chunk)}


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("x_fp32", "bf16"), ("m5", "M <= 4"),
    ("act", "fused GLU takes"), ("wu_shape", "one shape"),
    ("width", "does not match"), ("no_scale", "scale"),
    ("fp_scale", "no scale"), ("idx_int64", "int32"),
    ("w_dtype", "weights must be"), ("precision", "at most once"),
    ("order", "in that order"), ("twice", "at most once")])
def test_glu_wrapper_raises_before_any_launch(monkeypatch, case, match):
    calls = []
    monkeypatch.setattr(qm, "_ffn_kernels", lambda: (
        lambda *a: calls.append(a) or 0,) * 3)
    if case != "cpu":
        require = qm._require
        monkeypatch.setattr(qm, "_require", lambda cond, msg: require(
            cond or msg == "x must be a CUDA tensor", msg))
    d, f, n = 64, 200, 38
    prec = "fp" if case in ("fp_scale", "w_dtype", "precision") else "int8"
    wg, sg = _tier(prec, f, d, seed=1)
    wu, su = _tier(prec, f, d, seed=2)
    x = torch.zeros(1, d, dtype=torch.bfloat16)
    idx = torch.randperm(f)[:n].to(torch.int32)
    act = "silu"
    if case == "x_fp32":
        x = x.float()
    elif case == "m5":
        x = torch.zeros(5, d, dtype=torch.bfloat16)
    elif case == "act":
        act = "swish"
    elif case == "wu_shape":
        wu, su = _tier(prec, f + 1, d, seed=2)
    elif case == "width":
        wg, sg = _tier(prec, f, 2 * d, seed=1)
        wu, su = _tier(prec, f, 2 * d, seed=2)
    elif case == "no_scale":
        sg = None
    elif case == "fp_scale":
        sg = torch.ones(f)
    elif case == "idx_int64":
        idx = idx.long()
    elif case == "w_dtype":
        wg, wu = wg.float(), wu.float()
    elif case == "precision":
        prec = "fp8"
    tiers = [(prec, wg, wu, sg, su, idx)]
    if case == "order":
        tiers = tiers + [("fp", *(_tier("fp", f, d)[0],) * 2, None, None,
                          idx)]
    elif case == "twice":
        tiers = tiers * 2
    with pytest.raises(ValueError, match=match):
        qm.glu_bf16(x, tiers, act=act)
    assert calls == []


@pytest.mark.parametrize("R", [None, 1, 4])
def test_ffn_down_plans_each_tier_then_sums_once(monkeypatch, R):
    """The tiers' down products, each kernel A's row form at its own K
    split (``_plan`` of one row), into blocks of partials laid end to end,
    then one sum over (splits of tier 0, of tier 1, of tier 2)."""
    calls = _record_ffn_launches(monkeypatch)
    d, f, sizes = 512, 3000, (1037, 1037, 2073)
    terms = []
    for i, (prec, n) in enumerate(zip(("fp", "int8", "int4"), sizes)):
        w, s = _tier(prec, f, d, seed=i)
        idx = torch.randperm(f)[:n].to(torch.int32)
        idx = idx if R is None else idx[None].repeat(R, 1).contiguous()
        h = torch.zeros((1, n) if R is None else (R, 1, n),
                        dtype=torch.bfloat16)
        terms.append((h, w, s, idx, prec))
    y = qm.ffn_down_bf16(terms)
    rows = 1 if R is None else R
    assert y.shape == ((1, d) if R is None else (R, 1, d))
    assert y.dtype == torch.bfloat16
    assert [c[0] for c in calls] == ["down"] * 3 + ["sum"]
    splits = []
    for (_, args), n in zip(calls, sizes):
        kern, tile, s, k_split = qm._plan(1, d, n, "row", "cpu")
        assert kern == "gemv"
        assert args[4:8] == (rows, 1, d, n) and args[10:13] == (tile, s,
                                                                  k_split)
        splits.append(s)
    assert calls[-1][1][1:6] == (rows, d, *splits)


def test_fused_ffn_path_is_the_composition(monkeypatch):
    """``ops.mp_ffn`` at bf16 and small M, with the kernels' plain versions
    in their place: the fused path (one GLU launch, one down sum) gives the
    composition's bits (gate and up through the col form, the activation
    in PyTorch, down through the row form into a zeroed fp32 output), for
    each activation, with shared and per-row sets."""
    from repro_torch.core.quantize import build_neuron_banks, to_neuron_major
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(3)
    d, f = 64, 96
    banks = to_neuron_major(build_neuron_banks(*(
        (torch.randn(s, generator=g) / 8).to(torch.bfloat16)
        for s in ((d, f), (d, f), (f, d)))))
    sizes = {"fp16": 9, "int8": 11, "int4": 14, "k": 34}
    fused = []

    def glu(x, tiers, *, act):
        fused.append("glu")
        return ref.qmm_glu_ref(x, tiers, act_name=act)

    def down(terms):
        fused.append("down")
        return ref.ffn_down_ref(terms)
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "glu_bf16", glu)
    monkeypatch.setattr(ops, "ffn_down_bf16", down)
    monkeypatch.setattr(ops, "qmatmul_gathered", ref.qmm_gathered_ref)
    for act in qm.GLU_ACTS:
        for rows in (False, True):
            x = torch.randn(2, 1, d, generator=g).to(torch.bfloat16)
            idx = torch.randperm(f, generator=g)[:34]
            if rows:
                idx = torch.stack([idx, torch.randperm(f, generator=g)[:34]])
            fused.clear()
            got = ops.mp_ffn(x, banks, idx, sizes, act)
            assert fused == ["glu", "down"]
            monkeypatch.setattr(qm, "GEMV_MAX_M", 0)   # the composition
            want = ops.mp_ffn(x, banks, idx, sizes, act)
            monkeypatch.setattr(qm, "GEMV_MAX_M", 4)
            assert fused == ["glu", "down"]
            assert got.dtype == want.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
