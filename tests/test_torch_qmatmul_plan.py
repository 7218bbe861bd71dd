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
