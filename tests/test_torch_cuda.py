"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where there is no
NVIDIA GPU; the kernels build from ``src/repro_torch/csrc`` with nvcc at
first use. Tolerances are fp32-level: the kernels sum in another order.
Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _banks(dev, d=256, f=300, seed=0):
    from repro_torch.core.quantize import build_neuron_banks
    g = torch.Generator(device=dev).manual_seed(seed)
    return build_neuron_banks(torch.randn(d, f, generator=g, device=dev) / 16,
                              torch.randn(d, f, generator=g, device=dev) / 16,
                              torch.randn(f, d, generator=g, device=dev) / 16)


@pytest.mark.parametrize("prec,sfx", [("fp", "_fp"), ("int8", "_i8"),
                                      ("int4", "_i4")])
@pytest.mark.parametrize("M,n", [(1, 7), (4, 38), (64, 78), (130, 33)])
def test_qmatmul_gathered_matches_plain(dev, prec, sfx, M, n):
    from repro_torch.kernels import ref
    from repro_torch.kernels.qmatmul import qmatmul_gathered
    banks = _banks(dev)
    idx = torch.randperm(300, device=dev)[:n].to(torch.int32)
    x = torch.randn(M, 256, device=dev)
    s = None if prec == "fp" else banks[f"wg{sfx}_s"]
    torch.testing.assert_close(
        qmatmul_gathered(x, banks[f"wg{sfx}"], s, idx, precision=prec),
        ref.qmm_gathered_ref(x, banks[f"wg{sfx}"], s, idx, precision=prec),
        rtol=1e-5, atol=1e-5)
    h = torch.randn(M, n, device=dev)
    y = torch.randn(M, 256, device=dev)
    s = None if prec == "fp" else banks[f"wd{sfx}_s"]
    torch.testing.assert_close(
        qmatmul_gathered(h, banks[f"wd{sfx}"], s, idx, precision=prec,
                         layout="row", out=y.clone()),
        ref.qmm_gathered_ref(h, banks[f"wd{sfx}"], s, idx, precision=prec,
                             layout="row", out=y.clone()),
        rtol=1e-5, atol=1e-5)


def test_qmatmul_identity_matches_qmatmul_ref(dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.qmatmul import qmatmul_gathered
    banks = _banks(dev)
    x = torch.randn(3, 256, device=dev)
    for prec, w, s in (("fp", "wu_fp", None), ("int8", "wu_i8", "wu_i8_s"),
                       ("int4", "wu_i4", "wu_i4_s")):
        sc = None if s is None else banks[s]
        torch.testing.assert_close(
            qmatmul_gathered(x, banks[w], sc, precision=prec),
            ref.qmatmul_ref(x, banks[w], sc, precision=prec),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,Hkv,G,D", [(4, 145, 8, 5, 128), (2, 37, 2, 4, 32),
                                         (1, 1000, 1, 8, 64)])
def test_flash_decode_matches_plain(dev, B, S, Hkv, G, D):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode
    q = torch.randn(B, Hkv, G, D, device=dev)
    k, v = torch.randn(B, S, Hkv, D, device=dev), torch.randn(B, S, Hkv, D,
                                                              device=dev)
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].repeat(B, 1)
    slots[0, :2] = -1
    lengths = torch.randint(0, S, (B,), device=dev, dtype=torch.int32)
    torch.testing.assert_close(flash_decode(q, k, v, slots, lengths),
                               ref.flash_decode_ref(q, k, v, slots, lengths),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [(4, 128, 40, 8, 128, 0),
                                                 (2, 45, 8, 2, 64, 0),
                                                 (1, 70, 4, 4, 32, 16)])
def test_flash_attention_matches_plain(dev, B, S, Hq, Hkv, D, window):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(B, S, Hq, D, device=dev)
    k, v = torch.randn(B, S, Hkv, D, device=dev), torch.randn(B, S, Hkv, D,
                                                              device=dev)
    torch.testing.assert_close(flash_attention(q, k, v, window=window),
                               ref.flash_attention_ref(q, k, v, window=window),
                               rtol=1e-5, atol=1e-5)


def test_tiny_generate_on_cuda_equals_cpu(dev):
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine_model import RealModelRunner
    from repro_torch.kernels import flash_attention, flash_decode, qmatmul
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    for layer in params["layers"]:
        layer["ffn"]["pred"]["A"] = torch.randn(
            layer["ffn"]["pred"]["A"].shape, generator=g) / 16

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(dev)
    prompts = np.random.default_rng(0).integers(0, 512, (2, 12))
    before = (qmatmul.launches, flash_decode.launches,
              flash_attention.launches)
    gpu = RealModelRunner(cfg, to(params), max_seq=20, device=dev)
    tok_gpu, idx_gpu = gpu.generate(prompts, 6)
    after = (qmatmul.launches, flash_decode.launches,
             flash_attention.launches)
    assert all(a > b for a, b in zip(after, before))
    cpu = RealModelRunner(cfg, params, max_seq=20, device="cpu")
    tok_cpu, idx_cpu = cpu.generate(prompts, 6)
    np.testing.assert_array_equal(tok_gpu, tok_cpu)
    for a, b in zip(idx_gpu, idx_cpu):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    torch.testing.assert_close(gpu.last_logits.cpu(), cpu.last_logits,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prec,sfx", [("fp", "_fp"), ("int8", "_i8"),
                                      ("int4", "_i4")])
@pytest.mark.parametrize("M,n", [(1, 38), (16, 78), (1, 1037)])
def test_qmatmul_rows_match_plain_and_alone_equals_grouped(dev, prec, sfx, M,
                                                           n):
    """x (R, M, K) with one active set per row: each row as the plain
    version gives it, and a row alone gives the same bits as in a group of
    four (the K split depends on the row's shape only)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.qmatmul import qmatmul_gathered
    banks = _banks(dev, f=1100)
    idx = torch.stack([torch.randperm(1100, device=dev)[:n]
                       for _ in range(4)]).to(torch.int32)
    x = torch.randn(4, M, 256, device=dev)
    s = None if prec == "fp" else banks[f"wg{sfx}_s"]
    got = qmatmul_gathered(x, banks[f"wg{sfx}"], s, idx, precision=prec)
    torch.testing.assert_close(
        got, ref.qmm_gathered_ref(x, banks[f"wg{sfx}"], s, idx,
                                  precision=prec), rtol=1e-5, atol=1e-5)
    alone = qmatmul_gathered(x[2:3].contiguous(), banks[f"wg{sfx}"], s,
                             idx[2:3].contiguous(), precision=prec)
    assert torch.equal(alone[0], got[2])
    h = torch.randn(4, M, n, device=dev)
    y = torch.randn(4, M, 256, device=dev)
    s = None if prec == "fp" else banks[f"wd{sfx}_s"]
    got = qmatmul_gathered(h, banks[f"wd{sfx}"], s, idx, precision=prec,
                           layout="row", out=y.clone())
    torch.testing.assert_close(
        got, ref.qmm_gathered_ref(h, banks[f"wd{sfx}"], s, idx, precision=prec,
                                  layout="row", out=y.clone()),
        rtol=1e-5, atol=1e-5)
    alone = qmatmul_gathered(h[1:2].contiguous(), banks[f"wd{sfx}"], s,
                             idx[1:2].contiguous(), precision=prec,
                             layout="row", out=y[1:2].clone())
    assert torch.equal(alone[0], got[1])


@pytest.mark.parametrize("pos0,Sbuf,Hq,Hkv,D", [((0, 48, 96, 112), 256, 40, 8,
                                                 128),
                                                ((3, 21), 45, 8, 2, 64)])
def test_chunk_attention_matches_plain_and_ignores_garbage(dev, pos0, Sbuf, Hq,
                                                           Hkv, D):
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunk_attention import chunk_attention
    B, S = len(pos0), 16
    q = torch.randn(B, S, Hq, D, device=dev)
    k, v = (torch.randn(B, Sbuf, Hkv, D, device=dev) for _ in range(2))
    p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    got = chunk_attention(q, k, v, p0)
    torch.testing.assert_close(got, ref.chunk_attention_ref(q, k, v, p0),
                               rtol=1e-5, atol=1e-5)
    for b, p in enumerate(pos0):           # non-finite bytes above the front
        k[b, p + S:] = float("nan")
        v[b, p + S:] = float("inf")
    assert torch.equal(chunk_attention(q, k, v, p0), got)


def test_atu_update_matches_plain_with_duplicates(dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.atu_update import atu_update
    d, f, k, bg = 512, 1024, 256, 8
    bank = torch.randn(d, f, device=dev)
    unit = torch.randn(d, k, device=dev)
    groups = torch.randint(0, f // bg, (24,))
    dests = torch.randint(0, k // bg, (24,))
    dests[5] = dests[17]                   # a duplicate destination
    src = (groups[:, None] * bg + torch.arange(bg)).reshape(-1).int()
    dst = (dests[:, None] * bg + torch.arange(bg)).reshape(-1).int()
    want = ref.atu_update_ref(bank, unit.clone(), src, dst, bg=bg)
    got = atu_update(bank, unit, src.to(dev), dst.to(dev), bg=bg)
    assert got is unit and torch.equal(got, want)
    i8 = torch.randint(-127, 128, (d, f), dtype=torch.int8, device=dev)
    want = ref.atu_update_ref(i8, unit.clone(), src, dst, bg=bg)
    assert torch.equal(atu_update(i8, unit, src.to(dev), dst.to(dev), bg=bg),
                       want)


def test_mp_glu_ffn_matches_plain(dev):
    from repro_torch.kernels import ops, ref
    d, f = 256, 512
    w = [torch.randn(s, device=dev) / 16 for s in ((d, f), (d, f), (f, d))]
    idx = torch.randperm(f, device=dev)[:150]
    banks = ops.make_compact_banks(*w, {"fp16": 38, "int8": 38, "int4": 74},
                                   idx)
    x = torch.randn(4, d, device=dev)
    torch.testing.assert_close(ops.mp_glu_ffn(x, banks),
                               ref.mp_glu_ffn_ref(x, banks), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["prefill_resume", "decode"])
def test_rows_forward_bits_do_not_depend_on_the_batch(dev, mode):
    """The server's stacked rows: each row at its own position gives, bit
    for bit, what it gives as a one-row forward (the products, norms and
    attention splits of a row see the shape it has alone)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine_model import _stack_rows
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    for layer in params["layers"]:
        A = layer["ffn"]["pred"]["A"]
        layer["ffn"]["pred"]["A"] = torch.randn(A.shape, generator=g,
                                                device=dev) / 4
    rng = np.random.default_rng(4)
    caches = []
    for p in (16, 32, 48, 64):
        c = T.init_cache(cfg, 1, 128, device=dev)
        T.forward(cfg, params, torch.from_numpy(rng.integers(0, 512, (1, p)))
                  .to(dev), cache=c, mode="prefill")
        caches.append(c)
    S = 16 if mode == "prefill_resume" else 1
    tokens = torch.from_numpy(rng.integers(0, 512, (4, S))).to(dev)
    logits, _, aux = T.forward(cfg, params, tokens, cache=_stack_rows(caches),
                               mode=mode, rows=True)
    for r, c in enumerate(caches):
        alone, _, ar = T.forward(cfg, params, tokens[r:r + 1], cache=c,
                                 mode=mode)
        assert torch.equal(logits[r:r + 1], alone)
        assert torch.equal(aux["active_idx"]["pattern"][0][r],
                           ar["active_idx"]["pattern"][0])
