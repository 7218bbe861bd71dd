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
    """One layer's banks in the port's (neuron-major) layout."""
    from repro_torch.core.quantize import build_neuron_banks, to_neuron_major
    g = torch.Generator(device=dev).manual_seed(seed)
    return to_neuron_major(build_neuron_banks(
        torch.randn(d, f, generator=g, device=dev) / 16,
        torch.randn(d, f, generator=g, device=dev) / 16,
        torch.randn(f, d, generator=g, device=dev) / 16))


def _attention_f64(q, k, v, pos0):
    """Causal attention of queries at ``pos0[b] + i`` over slots 0..Skv-1,
    all in float64 (the plain versions round the scores to fp32, which at
    scores of +-60 moves the output by ~3e-5)."""
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / D ** 0.5
    q_pos = pos0.long()[:, None] + torch.arange(S, device=q.device)[None]
    mask = torch.arange(Skv, device=q.device)[None, None] <= q_pos[:, :, None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v.double())
    return o.reshape(B, S, Hq, D).float()


def _close(got, want, tol_rel=1e-5):
    """max|got - want| <= tol_rel * max(1, max|want|) (fp32 sums in another
    order), and every value finite."""
    tol = tol_rel * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= tol, (err, tol)


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
    from repro_torch.core.quantize import to_reference_layout
    from repro_torch.kernels import ref
    from repro_torch.kernels.qmatmul import qmatmul_gathered
    banks = _banks(dev)
    dense = to_reference_layout(banks)       # qmatmul_ref takes (K, N)
    x = torch.randn(3, 256, device=dev)
    for prec, w, s in (("fp", "wu_fp", None), ("int8", "wu_i8", "wu_i8_s"),
                       ("int4", "wu_i4", "wu_i4_s")):
        sc = None if s is None else banks[s]
        torch.testing.assert_close(
            qmatmul_gathered(x, banks[w], sc, precision=prec),
            ref.qmatmul_ref(x, dense[w], sc, precision=prec),
            rtol=1e-5, atol=1e-5)


def _route(monkeypatch, kernel):
    """Send every qmatmul call to kernel A ("gemv", M <= 16) or kernel B
    ("mma") by moving the crossover; "auto" keeps it."""
    from repro_torch.kernels import qmatmul
    if kernel != "auto":
        monkeypatch.setattr(qmatmul, "GEMV_MAX_M",
                            16 if kernel == "gemv" else 0)


#: M on both sides of the crossover; kernel A (gemv) takes M <= 16
_MS = (1, 4, 8, 16, 17, 64, 130, 512)
_KERNEL_CASES = [(k, M) for M in _MS
                 for k in ("auto", "mma") + (("gemv",) if M <= 16 else ())]


@pytest.mark.parametrize("prec,sfx", [("fp", "_fp"), ("int8", "_i8"),
                                      ("int4", "_i4")])
@pytest.mark.parametrize("kernel,M", _KERNEL_CASES)
@pytest.mark.parametrize("d", [256, 200])
def test_qmatmul_each_kernel_matches_plain_and_repeats(dev, monkeypatch, prec,
                                                       sfx, kernel, M, d):
    """Kernel A and kernel B, both forms, against the plain version: d = 200
    is no multiple of the 32-deep tile and leaves int8/int4 rows without
    16-byte alignment; 77 neurons is an odd int4 width. Two calls give the
    same bits."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.qmatmul import qmatmul_gathered
    _route(monkeypatch, kernel)
    banks = _banks(dev, d=d, f=1100, seed=M)
    kw = dict(precision=prec)
    idx = torch.randperm(1100, device=dev)[:77].to(torch.int32)
    x = torch.randn(M, d, device=dev)
    s = None if prec == "fp" else banks[f"wg{sfx}_s"]
    got = qmatmul_gathered(x, banks[f"wg{sfx}"], s, idx, **kw)
    _close(got, ref.qmm_gathered_ref(x, banks[f"wg{sfx}"], s, idx,
                                     precision=prec))
    assert torch.equal(got, qmatmul_gathered(x, banks[f"wg{sfx}"], s, idx,
                                             **kw))
    h, y = torch.randn(M, 77, device=dev), torch.randn(M, d, device=dev)
    s = None if prec == "fp" else banks[f"wd{sfx}_s"]
    got = qmatmul_gathered(h, banks[f"wd{sfx}"], s, idx, layout="row",
                           out=y.clone(), **kw)
    _close(got, ref.qmm_gathered_ref(h, banks[f"wd{sfx}"], s, idx,
                                     precision=prec, layout="row",
                                     out=y.clone()))
    assert torch.equal(got, qmatmul_gathered(h, banks[f"wd{sfx}"], s, idx,
                                             layout="row", out=y.clone(),
                                             **kw))


@pytest.mark.parametrize("prec,sfx", [("fp", "_fp"), ("int8", "_i8"),
                                      ("int4", "_i4")])
@pytest.mark.parametrize("kernel,M", [("gemv", 1), ("gemv", 4), ("gemv", 16),
                                      ("mma", 4), ("mma", 16), ("mma", 64)])
def test_qmatmul_each_kernel_row_alone_equals_grouped(dev, monkeypatch, prec,
                                                      sfx, kernel, M):
    from repro_torch.kernels.qmatmul import qmatmul_gathered
    _route(monkeypatch, kernel)
    banks = _banks(dev, d=5120 // 8, f=2000, seed=7)
    idx = torch.stack([torch.randperm(2000, device=dev)[:1037]
                       for _ in range(4)]).to(torch.int32)
    x = torch.randn(4, M, 640, device=dev)
    s = None if prec == "fp" else banks[f"wg{sfx}_s"]
    got = qmatmul_gathered(x, banks[f"wg{sfx}"], s, idx, precision=prec)
    alone = qmatmul_gathered(x[3:].contiguous(), banks[f"wg{sfx}"], s,
                             idx[3:].contiguous(), precision=prec)
    assert torch.equal(alone[0], got[3])
    h, y = torch.randn(4, M, 1037, device=dev), torch.randn(4, M, 640,
                                                            device=dev)
    s = None if prec == "fp" else banks[f"wd{sfx}_s"]
    got = qmatmul_gathered(h, banks[f"wd{sfx}"], s, idx, precision=prec,
                           layout="row", out=y.clone())
    alone = qmatmul_gathered(h[3:].contiguous(), banks[f"wd{sfx}"], s,
                             idx[3:].contiguous(), precision=prec,
                             layout="row", out=y[3:].clone())
    assert torch.equal(alone[0], got[3])


def _decode_inputs(dev, B, S, Hkv, G, D, seed=0):
    """q, k, v of a decode step from a seeded generator, and each slot at
    its own index as position."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hkv, G, D, generator=g, device=dev)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev)
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].repeat(B, 1)
    return q, k, v, slots


@pytest.mark.parametrize("B,S,Hkv,G,D,ring", [
    (4, 145, 8, 5, 128, False), (2, 37, 2, 4, 32, False),
    (1, 1000, 1, 8, 64, False), (2, 4096, 8, 5, 128, False),
    (1, 32768, 8, 5, 128, False),
    (1, 256, 1, 2, 32, True),             # tests/test_kernels.py's ring
    (3, 4096, 8, 5, 128, True),
    (4, 145, 8, 12, 128, False),          # mistral-large-123b: 2 head groups
    (4, 145, 2, 7, 64, False),            # internvl2-1b
    (4, 145, 8, 8, 128, False),           # command-r-35b
    (2, 4096, 8, 12, 128, False), (2, 300, 2, 7, 64, True),
    (1, 1000, 1, 16, 64, False),          # G = 16: two groups of 8
    (4, 209, 32, 1, 64, False),           # musicgen-large: G = 1 (MHA)
    (2, 4096, 32, 1, 64, True)])
def test_flash_decode_matches_plain(dev, B, S, Hkv, G, D, ring):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v, slots = _decode_inputs(dev, B, S, Hkv, G, D, seed=S)
    if ring:       # a ring buffer wrapped past S: slot i holds the position
        now = S + 44                  # now - ((now - i) mod S)
        slots = now - torch.remainder(now - slots, S)
        lengths = torch.tensor([now - 50 * b for b in range(B)], device=dev,
                               dtype=torch.int32)
    else:
        slots[0, :2] = -1
        lengths = torch.from_numpy(np.random.default_rng(S).integers(
            0, S, B).astype(np.int32)).to(dev)
    torch.testing.assert_close(flash_decode(q, k, v, slots, lengths),
                               ref.flash_decode_ref(q, k, v, slots, lengths),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [20, 145, 4096])
def test_flash_decode_row_without_a_valid_slot_equals_plain(dev, S):
    """A row whose slots are all empty, and one whose length is below every
    position, give the plain version's uniform weights (V's mean), in the
    one-range and the several-range form; the row beside them is normal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v, slots = _decode_inputs(dev, 3, S, 8, 5, 128)
    slots[1] = -1
    lengths = torch.tensor([S - 3, S - 1, -1], device=dev, dtype=torch.int32)
    torch.testing.assert_close(flash_decode(q, k, v, slots, lengths),
                               ref.flash_decode_ref(q, k, v, slots, lengths),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [145, 4096])
def test_flash_decode_masked_slots_change_no_bit(dev, S):
    """NaN and Inf in masked slots (empty slots, and slots above a row's
    length) leave every output bit as zeros there do."""
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v, slots = _decode_inputs(dev, 4, S, 8, 5, 128)
    slots[1, 5:9] = -1
    slots[2, 40:100] = -1
    lengths = torch.tensor([S - 1, S // 2, S - 17, 70], device=dev,
                           dtype=torch.int32)
    masked = ~((slots >= 0) & (slots <= lengths[:, None]))
    kz, vz, kn, vn = k.clone(), v.clone(), k.clone(), v.clone()
    kz[masked], vz[masked] = 0.0, 0.0
    kn[masked], vn[masked] = float("nan"), float("inf")
    want = flash_decode(q, kz, vz, slots, lengths)
    assert torch.equal(flash_decode(q, kn, vn, slots, lengths), want)
    assert torch.equal(flash_decode(q, k, v, slots, lengths), want)


@pytest.mark.parametrize("S", [145, 4096])
def test_flash_decode_row_alone_equals_row_in_group(dev, S):
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v, slots = _decode_inputs(dev, 4, S, 8, 5, 128)
    lengths = torch.tensor([S - 1, S // 3, S - 9, 40], device=dev,
                           dtype=torch.int32)
    got = flash_decode(q, k, v, slots, lengths)
    for b in range(4):
        alone = flash_decode(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                             v[b:b + 1].contiguous(),
                             slots[b:b + 1].contiguous(),
                             lengths[b:b + 1].contiguous())
        assert torch.equal(alone[0], got[b])


@pytest.mark.parametrize("B,S", [(4, 145), (4, 4096), (1, 32768)])
def test_flash_decode_repeats_bitwise_in_one_launch(dev, B, S):
    """Two calls give the same bits (the ranges' counters are back at 0
    after each launch), and each call is one launch."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v, slots = _decode_inputs(dev, B, S, 8, 5, 128)
    lengths = torch.full((B,), S - 1, device=dev, dtype=torch.int32)
    before = fd.launches
    first = fd.flash_decode(q, k, v, slots, lengths)
    assert torch.equal(fd.flash_decode(q, k, v, slots, lengths), first)
    assert fd.launches == before + 2


@pytest.mark.parametrize("S", [145, 4096])
def test_flash_decode_head_groups_keep_each_heads_bits(dev, monkeypatch, S):
    """G = 12 in 2, 3, 4, 6 or 12 blocks of heads (the ranges fixed): every
    head gets the same bits, also a row alone, and masked NaN/Inf change
    none."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v, slots = _decode_inputs(dev, 4, S, 8, 12, 128, seed=S + 12)
    lengths = torch.tensor([S - 1, S // 3, S - 9, 40], device=dev,
                           dtype=torch.int32)
    monkeypatch.setattr(fd, "RANGE_SLOTS", 64)
    want = fd.flash_decode(q, k, v, slots, lengths)
    for hb in (1, 2, 3, 4):
        monkeypatch.setattr(fd, "HEADS_PER_BLOCK", hb)
        assert torch.equal(fd.flash_decode(q, k, v, slots, lengths), want)
    monkeypatch.setattr(fd, "HEADS_PER_BLOCK", 0)
    alone = fd.flash_decode(q[1:2].contiguous(), k[1:2].contiguous(),
                            v[1:2].contiguous(), slots[1:2].contiguous(),
                            lengths[1:2].contiguous())
    assert torch.equal(alone[0], want[1])
    masked = slots > lengths[:, None]
    kn, vn = k.clone(), v.clone()
    kn[masked], vn[masked] = float("nan"), float("inf")
    assert torch.equal(fd.flash_decode(q, kn, vn, slots, lengths), want)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,mag", [
    (4, 128, 40, 8, 128, 0, 1.0), (2, 45, 8, 2, 64, 0, 1.0),
    (1, 70, 4, 4, 32, 16, 1.0),
    (1, 77, 10, 2, 128, 0, 1.0),          # G = 5 at a ragged S
    (2, 77, 10, 2, 128, 24, 1.0),         # G = 5, windowed
    (3, 50, 16, 1, 64, 0, 1.0),           # G = 16: two head groups
    (4, 128, 96, 8, 128, 0, 1.0),         # mistral-large-123b: G = 12
    (4, 128, 14, 2, 64, 0, 1.0),          # internvl2-1b: G = 7, D = 64
    (4, 192, 32, 32, 64, 0, 1.0),         # musicgen-large: G = 1 (MHA)
    (2, 77, 32, 32, 64, 0, 1.0),          # G = 1 at a ragged S
    (4, 128, 40, 8, 128, 0, 3.5)])        # scores reach about +-60
def test_flash_attention_matches_plain(dev, B, S, Hq, Hkv, D, window, mag):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator(device=dev).manual_seed(S + Hq)
    q = torch.randn(B, S, Hq, D, device=dev, generator=g) * mag
    k = torch.randn(B, S, Hkv, D, device=dev, generator=g) * mag
    v = torch.randn(B, S, Hkv, D, device=dev, generator=g)
    got = flash_attention(q, k, v, window=window)
    want = ref.flash_attention_ref(q, k, v, window=window)
    if mag == 1.0:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:                       # the split-TF32 products against fp32's
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, :, :1], k[:, :, :1])
        assert float(scores.abs().max()) / D ** 0.5 > 50
        _close(got, want)
        _close(got, _attention_f64(q, k, v, torch.zeros(B, device=dev)))


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(4, 128, 40, 8, 128),
                                          (4, 77, 10, 2, 128),
                                          (4, 192, 32, 32, 64)])
def test_flash_attention_row_alone_equals_row_in_group(dev, B, S, Hq, Hkv, D):
    """The plan depends on one row's shape: a row alone gives the bits it
    gives in a group of four."""
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(B, S, Hq, D, device=dev)
    k, v = (torch.randn(B, S, Hkv, D, device=dev) for _ in range(2))
    got = flash_attention(q, k, v)
    for b in (0, B - 1):
        alone = flash_attention(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                                v[b:b + 1].contiguous())
        assert torch.equal(alone[0], got[b])


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


@pytest.mark.parametrize("pos0,Sbuf,Hq,Hkv,D,mag", [
    ((0, 48, 96, 112), 256, 40, 8, 128, 1.0), ((3, 21), 45, 8, 2, 64, 1.0),
    ((5, 61), 77, 10, 2, 128, 1.0),       # G = 5; fronts 20 and 76 sit inside
                                          # a key tile and a key range
    ((7,), 40, 4, 4, 32, 1.0),            # G = 1
    ((2032,), 2048, 40, 8, 128, 1.0),     # a chunk at the end of 2 K slots
    ((0, 48, 96, 112), 256, 96, 8, 128, 1.0),    # G = 12
    ((0, 48, 96, 112), 256, 14, 2, 64, 1.0),     # G = 7, D = 64
    ((0, 48, 96, 112), 256, 40, 8, 128, 3.5)])   # scores reach about +-60
def test_chunk_attention_matches_plain_and_ignores_garbage(dev, pos0, Sbuf, Hq,
                                                           Hkv, D, mag):
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunk_attention import chunk_attention
    B, S = len(pos0), 16
    g = torch.Generator(device=dev).manual_seed(Sbuf + Hq)
    q = torch.randn(B, S, Hq, D, device=dev, generator=g) * mag
    k = torch.randn(B, Sbuf, Hkv, D, device=dev, generator=g) * mag
    v = torch.randn(B, Sbuf, Hkv, D, device=dev, generator=g)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    got = chunk_attention(q, k, v, p0)
    want = ref.chunk_attention_ref(q, k, v, p0)
    if mag == 1.0:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:                       # the split-TF32 products against fp32's
        _close(got, want)
        _close(got, _attention_f64(q, k, v, p0))
    for b, p in enumerate(pos0):           # non-finite bytes above the front
        k[b, p + S:] = float("nan")
        v[b, p + S:] = float("inf")
    assert torch.equal(chunk_attention(q, k, v, p0), got)
    # a row alone gives the bits it gives in the group
    b = B - 1
    alone = chunk_attention(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                            v[b:b + 1].contiguous(), p0[b:b + 1].contiguous())
    assert torch.equal(alone[0], got[b])


@pytest.mark.parametrize("split", [0, 32, 64, 128])
def test_chunk_attention_every_key_split_matches_plain(dev, monkeypatch,
                                                       split):
    """The key axis whole and split into ranges of 32, 64 or 128 slots (the
    combine of 1 to 8 ranges) all match the plain version."""
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import ref
    monkeypatch.setattr(ca, "SPLIT_SLOTS", split)
    q = torch.randn(4, 16, 40, 128, device=dev)
    k, v = (torch.randn(4, 256, 8, 128, device=dev) for _ in range(2))
    p0 = torch.tensor([0, 48, 100, 240], dtype=torch.int32, device=dev)
    torch.testing.assert_close(ca.chunk_attention(q, k, v, p0),
                               ref.chunk_attention_ref(q, k, v, p0),
                               rtol=1e-5, atol=1e-5)


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


#: (bank dtype, unit dtype) for each of the kernel's kinds: 1, 2 and 4-byte
#: bitwise copies and the int8 -> fp32 cast
ATU_KINDS = {1: (torch.int8, torch.int8), 2: (torch.float16, torch.float16),
             4: (torch.float32, torch.float32), 5: (torch.int8, torch.float32)}
#: (d, f, k, groups or 0 for m = k): the ATU row's shape (d = 5120, f =
#: 13824, a unit of 4152 columns, 104 groups); a d that is no multiple of
#: any block's rows, with odd widths, so that an item is one element; and
#: m = k, every unit column replaced
ATU_SHAPES = {"row": (5120, 13824, 4152, 104), "odd": (777, 2051, 1027, 37),
              "m_eq_k": (300, 1024, 512, 0)}


def _atu_values(shape, dtype, dev, g):
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, dtype=dtype, device=dev,
                             generator=g)
    return torch.randn(shape, device=dev, generator=g).to(dtype)


@pytest.mark.parametrize("shape", sorted(ATU_SHAPES))
@pytest.mark.parametrize("bg", (1, 8, 32, 256))
@pytest.mark.parametrize("kind", sorted(ATU_KINDS))
def test_atu_update_every_kind_and_group_width(dev, kind, bg, shape):
    """Bit for bit against the plain version, with a duplicate destination
    (the later group wins) and a group whose source lies outside the bank,
    which the kernel skips and the plain version is not given; it shares
    its destination with an earlier group, which must still land."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.atu_update import atu_update
    d, f, k, n = ATU_SHAPES[shape]
    n = min(n, f // bg, k // bg) if n else k // bg
    g = torch.Generator(device=dev).manual_seed(kind * 1000 + bg)
    bank_t, unit_t = ATU_KINDS[kind]
    bank = _atu_values((d, f), bank_t, dev, g)
    unit = _atu_values((d, k), unit_t, dev, g)
    groups = torch.randperm(f // bg, generator=g, device=dev)[:n].cpu()
    dests = torch.randperm(k // bg, generator=g, device=dev)[:n].cpu()
    keep = torch.ones(n, dtype=torch.bool)
    if n >= 3:
        dests[1] = dests[n - 2]            # a duplicate: group n - 2 wins
        groups[n - 1] = f // bg + 1        # outside the bank: skipped
        dests[n - 1] = dests[0]
        keep[n - 1] = False
    src = (groups[:, None] * bg + torch.arange(bg)).reshape(-1).int()
    dst = (dests[:, None] * bg + torch.arange(bg)).reshape(-1).int()
    assert src.numel() <= k
    inside = keep.repeat_interleave(bg)
    want = ref.atu_update_ref(bank, unit.clone(), src[inside], dst[inside],
                              bg=bg)
    got = atu_update(bank, unit, src.to(dev), dst.to(dev), bg=bg)
    torch.cuda.synchronize()
    assert got is unit and torch.equal(got, want)


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


@pytest.mark.parametrize("arch,widen", [
    ("qwen2.5-32b", None), ("command-r-35b", None),
    ("mistral-large-123b", None), ("internvl2-1b", None),
    ("mistral-large-123b", dict(num_heads=24, head_dim=64)),   # G = 12
    ("internvl2-1b", dict(num_heads=14, head_dim=64))])        # G = 7
def test_dense_arch_tiny_on_cuda_equals_cpu(dev, arch, widen):
    """Each dense-attention config at tiny size (and widened to the full
    configs' G at head dim 64): greedy tokens and active sets on the card
    equal the CPU's, last logits within 1e-4; rows mode keeps a row's bits
    alone."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine_model import RealModelRunner, _stack_rows
    from repro_torch.kernels import flash_attention, flash_decode, qmatmul
    from repro_torch.models import transformer as T
    cfg = get_config(arch, tiny=True)
    if widen:
        cfg = dataclasses.replace(cfg, **widen)
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
    gparams = to(params)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    before = (qmatmul.launches, flash_decode.launches,
              flash_attention.launches)
    gpu = RealModelRunner(cfg, gparams, max_seq=20, device=dev)
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
    rng = np.random.default_rng(4)
    caches = []
    for p in (16, 32, 48):
        c = T.init_cache(cfg, 1, 64, device=dev)
        T.forward(cfg, gparams, torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, p))).to(dev), cache=c, mode="prefill")
        caches.append(c)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))).to(dev)
    logits, _, _ = T.forward(cfg, gparams, tokens, cache=_stack_rows(caches),
                             mode="decode", rows=True)
    for r, c in enumerate(caches):
        alone, _, _ = T.forward(cfg, gparams, tokens[r:r + 1], cache=c,
                                mode="decode")
        assert torch.equal(logits[r:r + 1], alone)


def _softcap_inputs(dev, shape_q, shape_kv, seed, mag=3.5):
    """q, k, v drawn at ``mag`` (scores of about +-60 at D = 128, where a
    cap of 30 saturates)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(*shape_q, device=dev, generator=g) * mag
    k = torch.randn(*shape_kv, device=dev, generator=g) * mag
    v = torch.randn(*shape_kv, device=dev, generator=g)
    return q, k, v


@pytest.mark.parametrize("B,S,Hkv,G,D", [
    (4, 145, 8, 6, 128),                  # grok-1-314b's serve decode step
    (4, 128, 8, 6, 128),                  # grok's server decode bucket
    (2, 4096, 8, 6, 128), (3, 37, 2, 4, 32)])
def test_flash_decode_softcap_matches_plain(dev, B, S, Hkv, G, D):
    """The softcap form at saturating scores: the plain version within
    1e-5 x max(1, max|plain|); a row with no valid slot; NaN/Inf in masked
    slots change no bit; a row alone equals the row in the group; the cap
    does change the result."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    q, k, v = _softcap_inputs(dev, (B, Hkv, G, D), (B, S, Hkv, D), S + G)
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].repeat(B, 1)
    slots[B - 1, 5:9] = -1
    lengths = torch.tensor([S - 1 - 7 * b for b in range(B)], device=dev,
                           dtype=torch.int32)
    before = (fd.launches, fd.launches_softcap)
    got = fd.flash_decode(q, k, v, slots, lengths, softcap=30.0)
    assert (fd.launches, fd.launches_softcap) == (before[0] + 1,
                                                 before[1] + 1)
    _close(got, ref.flash_decode_ref(q, k, v, slots, lengths, softcap=30.0))
    assert float((got - fd.flash_decode(q, k, v, slots, lengths))
                 .abs().max()) > 1e-3
    none = slots.clone()
    none[0] = -1
    _close(fd.flash_decode(q, k, v, none, lengths, softcap=30.0),
           ref.flash_decode_ref(q, k, v, none, lengths, softcap=30.0))
    masked = ~((slots >= 0) & (slots <= lengths[:, None]))
    kn, vn = k.clone(), v.clone()
    kn[masked], vn[masked] = float("nan"), float("inf")
    assert torch.equal(fd.flash_decode(q, kn, vn, slots, lengths,
                                       softcap=30.0), got)
    b = B - 1
    alone = fd.flash_decode(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                            v[b:b + 1].contiguous(),
                            slots[b:b + 1].contiguous(),
                            lengths[b:b + 1].contiguous(), softcap=30.0)
    assert torch.equal(alone[0], got[b])


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (4, 128, 48, 8, 128),                 # grok-1-314b's serve prefill
    (2, 77, 12, 2, 64), (1, 45, 8, 2, 32)])
def test_flash_attention_softcap_matches_plain(dev, B, S, Hq, Hkv, D):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v = _softcap_inputs(dev, (B, S, Hq, D), (B, S, Hkv, D), S + Hq)
    before = fa.launches_softcap
    got = fa.flash_attention(q, k, v, softcap=30.0)
    assert fa.launches_softcap == before + 1
    _close(got, ref.flash_attention_ref(q, k, v, softcap=30.0))
    assert float((got - fa.flash_attention(q, k, v)).abs().max()) > 1e-3
    alone = fa.flash_attention(q[B - 1:].contiguous(), k[B - 1:].contiguous(),
                               v[B - 1:].contiguous(), softcap=30.0)
    assert torch.equal(alone[0], got[B - 1])


@pytest.mark.parametrize("split", [0, 32, 64])
@pytest.mark.parametrize("pos0,Sbuf,Hq,Hkv,D", [
    ((0, 48, 96, 112), 256, 48, 8, 128),  # grok-1-314b's server chunk
    ((3, 21), 45, 8, 2, 64)])
def test_chunk_attention_softcap_matches_plain(dev, monkeypatch, pos0, Sbuf,
                                               Hq, Hkv, D, split):
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import ref
    monkeypatch.setattr(ca, "SPLIT_SLOTS", split)
    B, S = len(pos0), 16
    q, k, v = _softcap_inputs(dev, (B, S, Hq, D), (B, Sbuf, Hkv, D), Sbuf + Hq)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    before = ca.launches_softcap
    got = ca.chunk_attention(q, k, v, p0, softcap=30.0)
    assert ca.launches_softcap == before + 1
    _close(got, ref.chunk_attention_ref(q, k, v, p0, softcap=30.0))
    for b, p in enumerate(pos0):           # non-finite bytes above the front
        k[b, p + S:] = float("nan")
        v[b, p + S:] = float("inf")
    assert torch.equal(ca.chunk_attention(q, k, v, p0, softcap=30.0), got)
    alone = ca.chunk_attention(q[B - 1:].contiguous(), k[B - 1:].contiguous(),
                               v[B - 1:].contiguous(), p0[B - 1:].contiguous(),
                               softcap=30.0)
    assert torch.equal(alone[0], got[B - 1])


@pytest.mark.parametrize("capacity_factor", [0.0, 1.25])
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b"])
def test_moe_arch_tiny_on_cuda_equals_cpu(dev, arch, capacity_factor):
    """Each MoE config at tiny size with a drawn router, at the tiny
    config's capacity factor (no drop) and at the full configs' 1.25
    (drops): the card's routing of a prefill equals the CPU's (experts,
    positions, keep) and drops what the CPU drops; greedy tokens on the
    card equal the CPU's, last logits within 1e-4, no qmatmul launch, the
    softcap forms launched where the config caps (grok); rows mode keeps a
    row's bits alone."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine_model import RealModelRunner, _stack_rows
    from repro_torch.kernels import flash_attention, flash_decode, qmatmul
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cfg = get_config(arch, tiny=True)
    if capacity_factor:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    params = T.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    for layer in params["layers"]:
        r = layer["ffn"]["router"]
        layer["ffn"]["router"] = torch.randn(r.shape, generator=g)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(dev)
    gparams = to(params)
    ffn = params["layers"][0]["ffn"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    kw = dict(E=cfg.num_experts, k=cfg.num_experts_per_tok,
              capacity_factor=cfg.moe_capacity_factor)
    on_card = moe.route(x.to(dev), ffn["router"].to(dev), **kw)
    on_cpu = moe.route(x, ffn["router"], **kw)
    for a, b in zip(on_card[2:5], on_cpu[2:5]):
        assert torch.equal(a.cpu(), b)
    assert (not bool(on_cpu[4].all())) is bool(capacity_factor)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    before = (qmatmul.launches, flash_decode.launches_softcap,
              flash_attention.launches_softcap, flash_decode.launches)
    gpu = RealModelRunner(cfg, gparams, max_seq=20, device=dev)
    tok_gpu, _ = gpu.generate(prompts, 6)
    after = (qmatmul.launches, flash_decode.launches_softcap,
             flash_attention.launches_softcap, flash_decode.launches)
    capped = bool(cfg.logit_softcap)
    assert after[0] == before[0] and after[3] > before[3]
    assert (after[1] > before[1]) is capped
    assert (after[2] > before[2]) is capped
    cpu = RealModelRunner(cfg, params, max_seq=20, device="cpu")
    tok_cpu, _ = cpu.generate(prompts, 6)
    np.testing.assert_array_equal(tok_gpu, tok_cpu)
    torch.testing.assert_close(gpu.last_logits.cpu(), cpu.last_logits,
                               rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(4)
    caches = []
    for p in (16, 32, 48):
        c = T.init_cache(cfg, 1, 64, device=dev)
        T.forward(cfg, gparams, torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, p))).to(dev), cache=c, mode="prefill")
        caches.append(c)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))).to(dev)
    logits, _, _ = T.forward(cfg, gparams, tokens, cache=_stack_rows(caches),
                             mode="decode", rows=True)
    for r, c in enumerate(caches):
        alone, _, _ = T.forward(cfg, gparams, tokens[r:r + 1], cache=c,
                                mode="decode")
        assert torch.equal(logits[r:r + 1], alone)


# --- head dim 256: recurrentgemma-2b (G = 10 over one KV head) ----------

@pytest.mark.parametrize("B,S,lengths,ring", [
    (4, 145, [128, 133, 138, 143], False),
    (2, 2048, [2176, 2191], True)])
def test_flash_decode_head_dim_256_matches_plain(dev, B, S, lengths, ring):
    """G = 10 over one KV head of 256 (two head groups of 5), at the serve
    step's cache and over the sliding window's 2048-slot ring, wrapped
    (slot i holds length - ((length - i) mod S)), with holes and slots
    above the length in it, so that the valid slots are not a prefix of the
    buffer: against the plain version; NaN and Inf in the masked slots
    change no bit, and a row alone equals the row in the group."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v, slots = _decode_inputs(dev, B, S, 1, 10, 256, seed=S + 256)
    ln = torch.tensor(lengths, device=dev, dtype=torch.int32)
    if ring:
        slots = (ln[:, None] - torch.remainder(ln[:, None] - slots, S)).to(
            torch.int32)
        slots[0, 100:140] = -1              # never written
        slots[1, 7:9] = ln[1] + 5           # above the row's position
    else:
        slots = torch.where(slots <= ln[:, None], slots, -1)
        slots[1, 5:9] = -1
    valid = (slots >= 0) & (slots <= ln[:, None])
    first_masked = int((~valid[0]).nonzero()[0])
    assert bool(valid[0, first_masked:].any()) is ring
    got = flash_decode(q, k, v, slots, ln)
    torch.testing.assert_close(got, ref.flash_decode_ref(q, k, v, slots, ln),
                               rtol=1e-5, atol=1e-5)
    kn, vn = k.clone(), v.clone()
    kn[~valid], vn[~valid] = float("nan"), float("inf")
    assert torch.equal(flash_decode(q, kn, vn, slots, ln), got)
    b = B - 1
    alone = flash_decode(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                         v[b:b + 1].contiguous(), slots[b:b + 1].contiguous(),
                         ln[b:b + 1].contiguous())
    assert torch.equal(alone[0], got[b])


@pytest.mark.parametrize("B,S,window", [(4, 128, 0), (2, 300, 64),
                                        (1, 2176, 2048)])
def test_flash_attention_head_dim_256_matches_plain(dev, B, S, window):
    """The whole-prompt form at D = 256, G = 10 over one KV head, causal and
    within a window smaller than S (whole key tiles below the window at
    2176 tokens over a window of 2048): against the plain version, and a
    row alone equals the row in the group."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator(device=dev).manual_seed(S + 256)
    q = torch.randn(B, S, 10, 256, device=dev, generator=g)
    k = torch.randn(B, S, 1, 256, device=dev, generator=g)
    v = torch.randn(B, S, 1, 256, device=dev, generator=g)
    got = flash_attention(q, k, v, window=window)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v,
                                                            window=window),
                               rtol=1e-5, atol=1e-5)
    if B > 1:
        alone = flash_attention(q[1:2].contiguous(), k[1:2].contiguous(),
                                v[1:2].contiguous(), window=window)
        assert torch.equal(alone[0], got[1])


def test_chunk_attention_raises_on_head_dim_256(dev):
    from repro_torch.kernels.chunk_attention import chunk_attention
    q = torch.zeros(2, 16, 10, 256, device=dev)
    kv = torch.zeros(2, 64, 1, 256, device=dev)
    with pytest.raises(ValueError, match="head dim 256 not in"):
        chunk_attention(q, kv, kv, torch.zeros(2, dtype=torch.int32,
                                               device=dev))


@pytest.mark.parametrize("P", [12, 80])
def test_hybrid_tiny_on_cuda_equals_cpu(dev, P):
    """recurrentgemma-2b tiny (window 64): prompts of 12 and of 80 tokens
    (the ring keeps the last 64) and 6 greedy tokens: tokens and active
    sets on the card equal the CPU's, last logits within 1e-4; rows mode
    keeps a row's bits alone, one row past the ring's end."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine_model import RealModelRunner, _stack_rows
    from repro_torch.kernels import flash_attention, flash_decode, qmatmul
    from repro_torch.models import transformer as T
    cfg = get_config("recurrentgemma-2b", tiny=True)
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
    gparams = to(params)
    prompts = np.random.default_rng(P).integers(0, cfg.vocab_size, (2, P))
    before = (qmatmul.launches, flash_decode.launches,
              flash_attention.launches)
    gpu = RealModelRunner(cfg, gparams, max_seq=P + 8, device=dev)
    tok_gpu, idx_gpu = gpu.generate(prompts, 6)
    after = (qmatmul.launches, flash_decode.launches,
             flash_attention.launches)
    assert all(a > b for a, b in zip(after, before))
    cpu = RealModelRunner(cfg, params, max_seq=P + 8, device="cpu")
    tok_cpu, idx_cpu = cpu.generate(prompts, 6)
    np.testing.assert_array_equal(tok_gpu, tok_cpu)
    for a, b in zip(idx_gpu, idx_cpu):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    torch.testing.assert_close(gpu.last_logits.cpu(), cpu.last_logits,
                               rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(4)
    caches = []
    for p in (16, 40, 70):
        c = T.init_cache(cfg, 1, 96, device=dev)
        T.forward(cfg, gparams, torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, p))).to(dev), cache=c, mode="prefill")
        caches.append(c)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))).to(dev)
    logits, _, _ = T.forward(cfg, gparams, tokens, cache=_stack_rows(caches),
                             mode="decode", rows=True)
    for r, c in enumerate(caches):
        alone, _, _ = T.forward(cfg, gparams, tokens[r:r + 1], cache=c,
                                mode="decode")
        assert torch.equal(logits[r:r + 1], alone)


@pytest.mark.parametrize("kernel,M", [("gemv", 4), ("mma", 4), ("mma", 768)])
def test_musicgen_ffn_d2048_matches_plain(dev, monkeypatch, kernel, M):
    """One layer's M2Cache FFN at musicgen-large's widths (d = 2048, f =
    8192, GELU; tiers 614/614/1230) through kernel A and kernel B against
    the plain version: the decode step's 4 rows and the prefill's 4 x 192."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import mp_ffn
    from repro_torch.kernels import ops
    cfg = get_config("musicgen-large")
    tiers = mp_ffn.tier_sizes(cfg.d_ff, cfg)
    assert (tiers["fp16"], tiers["int8"], tiers["int4"]) == (614, 614, 1230)
    _route(monkeypatch, kernel)
    banks = _banks(dev, d=2048, f=8192, seed=M)
    g = torch.Generator(device=dev).manual_seed(M)
    pred = {"A": torch.randn(2048, 64, generator=g, device=dev) / 8,
            "B": torch.randn(64, 8192, generator=g, device=dev) / 8}
    x = torch.randn(1, M, 2048, generator=g, device=dev)
    got, info = mp_ffn.mp_ffn_apply(cfg, banks, pred, x)
    with monkeypatch.context() as m:
        m.setattr(ops, "_on_cpu", lambda *t: True)
        want, winfo = mp_ffn.mp_ffn_apply(cfg, banks, pred, x)
    assert torch.equal(info["active_idx"], winfo["active_idx"])
    _close(got, want)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("P", [12, 80])
def test_ssm_tiny_on_cuda_equals_cpu(dev, P):
    """mamba2-370m tiny (chunk 32): prompts of 12 and of 80 tokens (three
    chunks, the last padded) and 6 greedy tokens: tokens on the card equal
    the CPU's, last logits within 1e-4, no kernel launched (the SSD is
    plain PyTorch, as the reference's is plain jnp); rows mode keeps a
    row's bits alone; the SSD block on the card within 1e-5 of the CPU's."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine_model import RealModelRunner, _stack_rows
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    cfg = get_config("mamba2-370m", tiny=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    for layer in params["layers"]:
        for k in ("A_log", "dt_bias", "D", "conv_b"):
            layer[k] = torch.randn(layer[k].shape, generator=g) / 2
    gparams = _to(params, dev)
    prompts = np.random.default_rng(P).integers(0, cfg.vocab_size, (2, P))
    gpu = RealModelRunner(cfg, gparams, max_seq=P + 8, device=dev)
    tok_gpu, _ = gpu.generate(prompts, 6)
    cpu = RealModelRunner(cfg, params, max_seq=P + 8, device="cpu")
    tok_cpu, _ = cpu.generate(prompts, 6)
    np.testing.assert_array_equal(tok_gpu, tok_cpu)
    torch.testing.assert_close(gpu.last_logits.cpu(), cpu.last_logits,
                               rtol=1e-4, atol=1e-4)
    x = torch.randn(2, P, cfg.d_model, generator=g)
    for mode, xin in (("prefill", x), ("decode", x[:, :1])):
        st = T.init_cache(cfg, 2, 8, device="cpu")["pattern"][0]
        st = {k: torch.randn(v[0].shape, generator=g) for k, v in st.items()}
        y, ns = ssm.ssm_block(cfg, params["layers"][0], xin, st, mode=mode)
        yg, nsg = ssm.ssm_block(cfg, gparams["layers"][0], xin.to(dev),
                                _to(st, dev), mode=mode)
        _close(yg.cpu(), y)
        _close(nsg["h"].cpu(), ns["h"])
    rng = np.random.default_rng(4)
    caches = []
    for p in (16, 40, 70):
        c = T.init_cache(cfg, 1, 8, device=dev)
        T.forward(cfg, gparams, torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, p))).to(dev), cache=c, mode="prefill")
        caches.append(c)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))).to(dev)
    logits, _, _ = T.forward(cfg, gparams, tokens, cache=_stack_rows(caches),
                             mode="decode", rows=True)
    for r, c in enumerate(caches):
        alone, _, _ = T.forward(cfg, gparams, tokens[r:r + 1], cache=c,
                                mode="decode")
        assert torch.equal(logits[r:r + 1], alone)


@pytest.mark.parametrize("widen", [None, dict(d_model=256, head_dim=64,
                                              d_ff=512)])
def test_audio_tiny_forward_on_cuda_equals_cpu(dev, widen):
    """musicgen-large tiny (and widened to head dim 64), every predictor A
    drawn: a prefill of 12 codebook steps after the conditioning frames,
    then 4 greedy decode steps, through forward on the card and on the
    CPU: greedy codes and active sets equal, logits within 1e-4; the three
    kernels launched."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention, flash_decode, qmatmul
    from repro_torch.models import transformer as T
    cfg = get_config("musicgen-large", tiny=True)
    if widen:
        cfg = dataclasses.replace(cfg, **widen)
    params = T.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    for layer in params["layers"]:
        layer["ffn"]["pred"]["A"] = torch.randn(
            layer["ffn"]["pred"]["A"].shape, generator=g) / 16
    gparams = _to(params, dev)
    codes = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, cfg.num_codebooks, 12)))
    frames = torch.randn(2, cfg.num_prefix_embeddings, cfg.d_model,
                         generator=g)
    before = (qmatmul.launches, flash_decode.launches,
              flash_attention.launches)
    runs = []
    for device, p in (("cpu", params), (dev, gparams)):
        c = T.init_cache(cfg, 2, 32, device=device)
        logits, c, aux = T.forward(cfg, p, codes.to(device), cache=c,
                                   mode="prefill", prefix=frames.to(device))
        out = [(logits.cpu(), aux)]
        for _ in range(4):
            nxt = torch.argmax(out[-1][0][..., -1, :], -1)[..., None]
            logits, c, aux = T.forward(cfg, p, nxt.to(device), cache=c,
                                       mode="decode")
            out.append((logits.cpu(), aux))
        runs.append(out)
    after = (qmatmul.launches, flash_decode.launches,
             flash_attention.launches)
    for (lc, ac), (lg, ag) in zip(*runs):
        torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
        assert torch.equal(torch.argmax(lg[..., -1, :], -1),
                           torch.argmax(lc[..., -1, :], -1))
        for a, b in zip(ac["active_idx"]["pattern"],
                        ag["active_idx"]["pattern"]):
            assert torch.equal(a, b.cpu())
    assert all(a > b for a, b in zip(after, before))


def _value_and_grad(cfg, params, batch):
    from repro_torch.tree import tree_leaves
    from repro_torch.models import transformer as T
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = T.lm_loss(cfg, params, batch, remat=True)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)


def test_tiny_train_step_on_cuda_equals_cpu(dev):
    """One step of the trainer at tiny size from the same weights and batch:
    the loss within 1e-5 relative, every gradient leaf within 1e-4 x its
    largest magnitude (the tolerances of the CPU parity tests against the
    reference), then the params after one AdamW step within 2 x lr (Adam
    turns a gradient difference where v ~ 0 into up to lr), fewer than
    1e-3 of the elements farther apart than 1e-5; no kernel launched."""
    from repro_torch.tree import tree_leaves
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import batches
    from repro_torch.kernels import flash_attention, flash_decode, qmatmul
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, seed=0, device="cpu", m2=False)
    gparams = _to(params, dev)
    b = next(batches(cfg, batch_size=4, seq_len=64, seed=0))
    before = (qmatmul.launches, flash_decode.launches,
              flash_attention.launches)
    runs = {}
    for device, p in (("cpu", params), (dev, gparams)):
        batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        loss, grads = _value_and_grad(cfg, p, batch)
        opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        step = make_train_step(cfg, opt, remat=True)
        p, _, m = step(p, init_opt_state(p), batch)
        runs[device] = (loss.cpu(), [g.cpu() for g in grads],
                        [t.cpu() for t in tree_leaves(p)], float(m["lr"]))
    (lc, gc, pc, lr), (lg, gg, pg, _) = runs["cpu"], runs[dev]
    assert abs(float(lg) - float(lc)) <= 1e-5 * float(lc)
    for a, w in zip(gg, gc):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
    diff = torch.cat([(a - w).abs().flatten() for a, w in zip(pg, pc)])
    assert float(diff.max()) <= 2 * lr
    assert float((diff > 1e-5).float().mean()) < 1e-3
    assert (qmatmul.launches, flash_decode.launches,
            flash_attention.launches) == before


def test_tiny_search_on_cuda_equals_cpu(dev):
    """Algorithm 1 at tiny size (examples/ratio_search_demo.py's budget and
    steps) from the same weights, predictor A drawn: feasibility and the
    best ratio equal, uq within 1e-4 relative; on the card each searched
    candidate launches qmatmul 3 x its non-empty tiers x layers x (1 +
    gen_len) times."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.core import mp_ffn
    from repro_torch.core import ratio_search as R
    from repro_torch.kernels import qmatmul
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    for layer in params["layers"]:
        layer["ffn"]["pred"]["A"] = torch.randn(
            layer["ffn"]["pred"]["A"].shape, generator=g) / 4
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    want = R.search(cfg, params, prompts, memory_budget=0.25, gen_len=6)
    before = qmatmul.launches
    got = R.search(cfg, _to(params, dev), prompts.to(dev), memory_budget=0.25,
                   gen_len=6)
    assert got.best_ratio == want.best_ratio
    expected = 0
    for a, b in zip(got.table, want.table):
        assert a["feasible"] == b["feasible"]
        if b["feasible"]:
            assert abs(a["uq"] - b["uq"]) <= 1e-4 * abs(b["uq"])
            cand = dataclasses.replace(cfg, m2_ratio_fp16=b["ratio"][0],
                                       m2_ratio_int8=b["ratio"][1],
                                       m2_ratio_int4=b["ratio"][2])
            sizes = mp_ffn.tier_sizes(cfg.d_ff, cand)
            tiers = sum(1 for t in ("fp16", "int8", "int4") if sizes[t])
            expected += 3 * tiers * cfg.num_layers * (1 + 6)
    assert qmatmul.launches - before == expected


# ---------------------------------------------------------------------------
# bf16 forms: bf16 inputs widened to fp32 inside, fp32 sums; qmatmul and
# flash_decode write fp32 (held within 1e-5 of the plain version), the
# attention forms write bf16 (held to one bf16 rounding of the plain
# version's fp32 result, plus 1e-5)


def _close_rounded(got, want_f32, tol_rel=1e-5):
    """A bf16 result against the fp32 one it rounds: within half a bf16
    unit of it (at most 2^-8 of the value: bf16 keeps 8 significant bits),
    plus ``tol_rel`` for the fp32 sums' order."""
    assert got.dtype == torch.bfloat16
    tol = tol_rel * max(1.0, float(want_f32.abs().max()))
    excess = (got.float() - want_f32).abs() - want_f32.abs() * 2.0 ** -8
    assert bool(torch.isfinite(got.float()).all())
    assert float(excess.max()) <= tol, (float(excess.max()), tol)


@pytest.mark.parametrize("prec", ["fp", "int8", "int4"])
@pytest.mark.parametrize("M", [1, 4, 16, 130])
@pytest.mark.parametrize("layout", ["col", "row"])
def test_qmatmul_bf16_matches_plain(dev, prec, M, layout):
    from repro_torch.core.quantize import quantize_int4, quantize_int8
    from repro_torch.kernels import qmatmul as qm
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(M)
    f, K, n = 300, 256, 78
    w = torch.randn(f, K, generator=g, device=dev) / 16
    w, s = ((w.to(torch.bfloat16), None) if prec == "fp" else
            quantize_int8(w, 1) if prec == "int8" else quantize_int4(w, 1))
    idx = torch.randperm(f, device=dev)[:n].to(torch.int32)
    x = torch.randn(M, K if layout == "col" else n, generator=g,
                    device=dev).to(torch.bfloat16)
    before = qm.launches_bf16
    got = qm.qmatmul_gathered(x, w, s, idx, precision=prec, layout=layout)
    assert qm.launches_bf16 == before + 1 and got.dtype == torch.float32
    _close(got, ref.qmm_gathered_ref(x, w, s, idx, precision=prec,
                                     layout=layout))


@pytest.mark.parametrize("B,S,Hkv,G,D,ring,cap", [
    (4, 145, 8, 5, 128, False, 0.0), (1, 8192, 8, 5, 128, True, 0.0),
    (4, 145, 2, 7, 64, False, 0.0), (2, 300, 1, 10, 256, True, 0.0),
    (4, 145, 8, 6, 128, False, 30.0), (4, 209, 32, 1, 64, False, 0.0)])
def test_flash_decode_bf16_matches_plain(dev, B, S, Hkv, G, D, ring, cap):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(S)
    bf = torch.bfloat16
    q = torch.randn(B, Hkv, G, D, generator=g, device=dev).to(bf)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(bf)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(bf)
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].repeat(B, 1)
    lengths = torch.full((B,), S - 1, device=dev, dtype=torch.int32)
    if ring:                              # wrapped: slot i holds S + i - 3
        slots = (slots + S - 3).contiguous()
        slots[:, 3:] -= S
        lengths += S - 3
    before = fd.launches_bf16
    got = fd.flash_decode(q, k, v, slots, lengths, softcap=cap)
    assert fd.launches_bf16 == before + 1 and got.dtype == torch.float32
    _close(got, ref.flash_decode_ref(q, k, v, slots, lengths, softcap=cap))


def _decode_bf16(dev, B, S, Hkv, G, D, seed, ring=True):
    """bf16 q, k, v and a ring's slot positions: slot i of row b holds
    position lengths[b] - ((lengths[b] - i) mod S), every slot valid, the
    ring wrapped at a different slot in each row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn(B, Hkv, G, D, generator=g, device=dev).to(bf)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(bf)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(bf)
    lengths = (S + 5 + 37 * torch.arange(B, device=dev)).to(torch.int32)
    slot = torch.arange(S, device=dev, dtype=torch.int32)[None]
    if ring:
        slots = lengths[:, None] - torch.remainder(lengths[:, None] - slot, S)
    else:
        slots = slot.repeat(B, 1)
    return q, k, v, slots.to(torch.int32).contiguous(), lengths


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else \
        t.view(torch.int16)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("G,S", [(1, 300), (5, 2048), (7, 999), (16, 4100)])
def test_flash_decode_bf16_ring_matches_plain_and_the_fp32_form(dev, D, G, S):
    """The bf16 form on the tensor cores over a wrapped ring at D = 32 to
    256 and G = 1 to 16 (two head groups of 8 at G = 16): within 1e-5 of
    the plain version and of the fp32 form run on the widened inputs (its
    sums run in another order: Q K^T and P V as MMAs, each warp its own
    slots)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    q, k, v, slots, lengths = _decode_bf16(dev, 2, S, 2, G, D, seed=D + G)
    before = fd.launches_bf16
    got = fd.flash_decode(q, k, v, slots, lengths)
    assert fd.launches_bf16 == before + 1
    _close(got, ref.flash_decode_ref(q, k, v, slots, lengths))
    _close(got, fd.flash_decode(q.float(), k.float(), v.float(), slots,
                                lengths))


@pytest.mark.parametrize("S", [145, 8192])
def test_flash_decode_bf16_masked_slots_change_no_bit(dev, S):
    """NaN and Inf in the K and V of masked slots (empty, or past the
    length) leave every output bit as it was; a row with no valid slot
    gives V's mean over the whole buffer, as the plain version does."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    q, k, v, slots, lengths = _decode_bf16(dev, 3, S, 8, 5, 128, seed=S,
                                           ring=False)
    lengths = torch.tensor([S - 20, S // 2, S - 1], dtype=torch.int32,
                           device=dev)
    slots[0, 3:40:2] = -1
    clean = fd.flash_decode(q, k, v, slots, lengths)
    masked = (slots < 0) | (slots > lengths[:, None])
    k2, v2 = k.clone(), v.clone()
    k2[masked] = float("nan")
    v2[masked] = float("inf")
    assert torch.equal(_bits(fd.flash_decode(q, k2, v2, slots, lengths)),
                       _bits(clean))
    none = torch.full_like(slots, -1)
    got = fd.flash_decode(q, k, v, none, lengths)
    _close(got, ref.flash_decode_ref(q, k, v, none, lengths))
    assert torch.equal(_bits(got), _bits(fd.flash_decode(
        q.float(), k.float(), v.float(), none, lengths)))


@pytest.mark.parametrize("S,G,D", [(145, 5, 128), (8192, 5, 128),
                                   (2048, 10, 256), (209, 1, 64)])
def test_flash_decode_bf16_row_alone_equals_it_in_a_group(dev, S, G, D):
    from repro_torch.kernels import flash_decode as fd
    q, k, v, slots, lengths = _decode_bf16(dev, 4, S, 2, G, D, seed=S + D)
    group = fd.flash_decode(q, k, v, slots, lengths)
    for b in range(4):
        alone = fd.flash_decode(q[b:b + 1].contiguous(),
                                k[b:b + 1].contiguous(),
                                v[b:b + 1].contiguous(),
                                slots[b:b + 1].contiguous(), lengths[b:b + 1])
        assert torch.equal(_bits(alone[0]), _bits(group[b]))


@pytest.mark.parametrize("prec", ["fp", "int8", "int4"])
@pytest.mark.parametrize("n", [38, 78, 1037, 2073])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("R,M,aligned", [(1, 1, True), (4, 1, True),
                                         (1, 4, True), (1, 1, False)])
def test_glu_bf16_matches_plain_and_the_composition(dev, prec, n, act, R, M,
                                                    aligned):
    """The fused GLU at odd tier widths, per-row sets and M = 4, and with x
    not 16-byte aligned: gate and up within 1e-5 of the plain products and
    equal to kernel A's col form's bit for bit; h bit-equal to the PyTorch
    composition over them (``activation(gate.to(bf16)) * up.to(bf16)``)."""
    from repro_torch.core.quantize import quantize_int4, quantize_int8
    from repro_torch.kernels import qmatmul as qm
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(n + M)
    f, K = 2500, 320
    ws = []
    for _ in range(2):
        w = torch.randn(f, K, generator=g, device=dev) / 8
        ws.append((w.to(torch.bfloat16), None) if prec == "fp" else
                  quantize_int8(w, 1) if prec == "int8" else
                  quantize_int4(w, 1))
    (wg, sg), (wu, su) = ws
    idx = torch.stack([torch.randperm(f, generator=g, device=dev)[:n]
                       for _ in range(R)]).to(torch.int32)
    buf = torch.randn(R * M * K + 1, generator=g, device=dev).to(
        torch.bfloat16)
    x = (buf[:-1] if aligned else buf[1:]).view(R, M, K)
    if R == 1:
        x, idx = x[0], idx[0]
    assert (x.data_ptr() % 16 == 0) == aligned
    before = qm.launches_glu
    tier = [(prec, wg, wu, sg, su, idx)]
    (h, gate, up), = qm.glu_bf16(x, tier, act=act, products=True)
    assert qm.launches_glu == before + 1 and h.dtype == torch.bfloat16
    for got, w, s in ((gate, wg, sg), (up, wu, su)):
        _close(got, ref.qmm_gathered_ref(x, w, s, idx, precision=prec))
        assert torch.equal(_bits(got), _bits(qm.qmatmul_gathered(
            x, w, s, idx, precision=prec)))
    assert torch.equal(_bits(h), _bits(ref.glu_bf16_ref(gate, up, act)))
    assert torch.equal(_bits(h), _bits(qm.glu_bf16(x, tier, act=act)[0]))


@pytest.mark.parametrize("R,M", [(1, 1), (4, 1), (1, 4)])
def test_glu_bf16_three_tiers_in_one_launch(dev, R, M):
    """The three tiers in one launch (blocks of the fp tier, then int8's,
    then int4's) give each tier's h and products as the tier alone does,
    bit for bit, at odd widths."""
    from repro_torch.core.quantize import quantize_int4, quantize_int8
    from repro_torch.kernels import qmatmul as qm
    g = torch.Generator(device=dev).manual_seed(R + M)
    f, K = 2500, 320
    tiers = []
    for prec, n in (("fp", 78), ("int8", 1037), ("int4", 2073)):
        ws = []
        for _ in range(2):
            w = torch.randn(f, K, generator=g, device=dev) / 8
            ws.append((w.to(torch.bfloat16), None) if prec == "fp" else
                      quantize_int8(w, 1) if prec == "int8" else
                      quantize_int4(w, 1))
        idx = torch.stack([torch.randperm(f, generator=g, device=dev)[:n]
                           for _ in range(R)]).to(torch.int32)
        tiers.append((prec, ws[0][0], ws[1][0], ws[0][1], ws[1][1],
                      idx if R > 1 else idx[0]))
    x = torch.randn(R, M, K, generator=g, device=dev).to(torch.bfloat16)
    x = x if R > 1 else x[0]
    before = qm.launches_glu
    together = qm.glu_bf16(x, tiers, act="gelu", products=True)
    assert qm.launches_glu == before + 1
    for tier, got in zip(tiers, together):
        (alone,) = qm.glu_bf16(x, [tier], act="gelu", products=True)
        for a, b in zip(got, alone):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("R", [None, 4])
def test_fused_ffn_equals_the_composition_bit_for_bit(dev, monkeypatch, R):
    """``ops.mp_ffn`` at bf16 and M = 1: the fused path (one GLU launch,
    the down products and one sum) gives the bits of the composition
    it replaces (col products, the activation in PyTorch, the row form into
    a zeroed fp32 output, one cast), with shared and per-row sets."""
    from repro_torch.core.quantize import build_neuron_banks, to_neuron_major
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qm
    g = torch.Generator(device=dev).manual_seed(7)
    d, f = 512, 3000
    banks = to_neuron_major(build_neuron_banks(*(
        (torch.randn(s, generator=g, device=dev) / 16).to(torch.bfloat16)
        for s in ((d, f), (d, f), (f, d)))))
    sizes = {"fp16": 225, "int8": 225, "int4": 449, "k": 899}
    x = torch.randn(4 if R else 2, 1, d, generator=g, device=dev).to(
        torch.bfloat16)
    idx = torch.stack([torch.randperm(f, generator=g, device=dev)[:899]
                       for _ in range(4)])
    idx = idx if R else idx[0]
    for act in qm.GLU_ACTS:
        before = qm.launches_glu
        got = ops.mp_ffn(x, banks, idx, sizes, act)
        assert qm.launches_glu == before + 1
        monkeypatch.setattr(qm, "GLU_MAX_M", 0)        # the composition
        want = ops.mp_ffn(x, banks, idx, sizes, act)
        monkeypatch.setattr(qm, "GLU_MAX_M", 4)
        assert qm.launches_glu == before + 1
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,cap", [
    (4, 128, 40, 8, 128, 0, 0.0), (2, 300, 14, 2, 64, 64, 0.0),
    (2, 200, 10, 1, 256, 0, 0.0), (4, 128, 48, 8, 128, 0, 30.0)])
def test_flash_attention_bf16_matches_plain(dev, B, S, Hq, Hkv, D, window,
                                            cap):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).to(
        torch.bfloat16) for h in (Hq, Hkv, Hkv))
    before = fa.launches_bf16
    got = fa.flash_attention(q, k, v, window=window, softcap=cap)
    assert fa.launches_bf16 == before + 1
    _close_rounded(got, ref.flash_attention_ref(
        q.float(), k.float(), v.float(), window=window, softcap=cap))


@pytest.mark.parametrize("pos0,Sbuf,Hq,Hkv,D,cap", [
    ([0, 48, 96, 112], 256, 40, 8, 128, 0.0),
    ([0, 100, 200, 240], 256, 14, 2, 64, 0.0),
    ([0, 48, 96, 112], 256, 48, 8, 128, 30.0)])
def test_chunk_attention_bf16_matches_plain(dev, pos0, Sbuf, Hq, Hkv, D, cap):
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(Sbuf)
    B = len(pos0)
    q = torch.randn(B, 16, Hq, D, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, Sbuf, Hkv, D, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    before = ca.launches_bf16
    got = ca.chunk_attention(q, k, v, p0, softcap=cap)
    assert ca.launches_bf16 == before + 1
    _close_rounded(got, ref.chunk_attention_ref(
        q.float(), k.float(), v.float(), p0, softcap=cap))


@pytest.mark.parametrize("prec", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["col", "row"])
@pytest.mark.parametrize("M,d", [(16, 512), (64, 196), (512, 512)])
def test_qmatmul_bf16_kernel_b_rows_match_plain(dev, monkeypatch, prec,
                                                layout, M, d):
    """Kernel B's bf16 form over R = 4 rows, each with its own active set
    of 1037 neurons (no tile multiple; the row form's h rows are then not
    16-byte aligned), against the plain version (the row form into an
    output it adds to); K is split (the plan's deterministic second pass)
    at every shape here; d = 196 leaves x's rows (col) and the weight rows
    (int8: 196 bytes, int4: 98) unaligned. A row alone gives its bits in
    the group."""
    from repro_torch.core.quantize import quantize_int4, quantize_int8
    from repro_torch.kernels import qmatmul as qm
    from repro_torch.kernels import ref
    monkeypatch.setattr(qm, "GEMV_MAX_M", 0)
    g = torch.Generator(device=dev).manual_seed(M + d)
    f, n, R = 2100, 1037, 4
    w = torch.randn(f, d, generator=g, device=dev) / 16
    w, s = ((w.to(torch.bfloat16), None) if prec == "fp" else
            quantize_int8(w, 1) if prec == "int8" else quantize_int4(w, 1))
    idx = torch.stack([torch.randperm(f, generator=g, device=dev)[:n]
                       for _ in range(R)]).to(torch.int32)
    x = torch.randn(R, M, d if layout == "col" else n, generator=g,
                    device=dev).to(torch.bfloat16)
    N = n if layout == "col" else d
    assert qm._plan(M, N, x.shape[-1], layout, dev)[2] > 1
    y = (torch.randn(R, M, N, generator=g, device=dev) if layout == "row"
         else None)

    def out(rows=slice(None)):
        return None if y is None else y[rows].clone()
    kw = dict(precision=prec, layout=layout)
    before = qm.launches_mma
    got = qm.qmatmul_gathered(x, w, s, idx, out=out(), **kw)
    assert qm.launches_mma == before + 1
    _close(got, ref.qmm_gathered_ref(x, w, s, idx, out=out(), **kw))
    r = R - 1
    alone = qm.qmatmul_gathered(x[r:].contiguous(), w, s, idx[r:].contiguous(),
                                out=out(slice(r, None)), **kw)
    assert torch.equal(alone[0], got[r])


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (2, 77, 4, 4, 32),        # G = 1, S no multiple of the 16-row tile
    (3, 45, 12, 1, 32),       # G = 12 over one KV head
    (2, 150, 96, 8, 64),      # G = 12 in two blocks of 6 heads
    (2, 200, 10, 1, 256)])    # D = 256: one block of 8 warps at bf16
def test_flash_attention_bf16_ragged_and_row_alone(dev, B, S, Hq, Hkv, D):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(S + Hq)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).to(
        torch.bfloat16) for h in (Hq, Hkv, Hkv))
    got = fa.flash_attention(q, k, v)
    _close_rounded(got, ref.flash_attention_ref(q.float(), k.float(),
                                                v.float()))
    r = B - 1
    alone = fa.flash_attention(q[r:].contiguous(), k[r:].contiguous(),
                               v[r:].contiguous())
    assert torch.equal(alone[0], got[r])


@pytest.mark.parametrize("split", [0, 32, 64])
@pytest.mark.parametrize("pos0,Sbuf,S,Hq,Hkv,D", [
    ((0, 37, 100), 160, 13, 12, 1, 32),        # G = 12, D = 32, S = 13
    ((5, 61), 77, 16, 4, 4, 32),               # G = 1, fronts inside tiles
    ((0, 48, 96, 112), 256, 16, 40, 8, 128)])  # the server's chunk
def test_chunk_attention_bf16_ignores_garbage_and_row_alone(
        dev, monkeypatch, split, pos0, Sbuf, S, Hq, Hkv, D):
    """The bf16 chunk form against the plain version with the key axis
    whole or split; NaN and Inf planted above each row's front change no
    bit; a row alone gives its bits in the group."""
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import ref
    monkeypatch.setattr(ca, "SPLIT_SLOTS", split)
    B = len(pos0)
    g = torch.Generator(device=dev).manual_seed(Sbuf + Hq)
    bf = torch.bfloat16
    q = torch.randn(B, S, Hq, D, generator=g, device=dev).to(bf)
    k, v = (torch.randn(B, Sbuf, Hkv, D, generator=g, device=dev).to(bf)
            for _ in range(2))
    p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    got = ca.chunk_attention(q, k, v, p0)
    _close_rounded(got, ref.chunk_attention_ref(q.float(), k.float(),
                                                v.float(), p0))
    for b, p in enumerate(pos0):
        k[b, p + S:] = float("nan")
        v[b, p + S:] = float("inf")
    assert torch.equal(ca.chunk_attention(q, k, v, p0), got)
    r = B - 1
    alone = ca.chunk_attention(q[r:].contiguous(), k[r:].contiguous(),
                               v[r:].contiguous(), p0[r:].contiguous())
    assert torch.equal(alone[0], got[r])


#: each C entry point's arguments that carry the shape and the plan (the
#: rest are addresses, sizes in bytes and scratch)
_PLAN_ARGS = {"repro_torch.kernels.qmatmul": slice(4, 8),
              "repro_torch.kernels.flash_decode": slice(10, 20),
              "repro_torch.kernels.flash_attention": slice(4, 15),
              "repro_torch.kernels.chunk_attention": slice(9, 20)}
_QMM_PLAN = slice(9, 15)       # qmm_gathered: precision .. k_split


def test_fp32_forms_keep_their_entry_points_and_plans(dev, monkeypatch):
    """An fp32 call goes to the fp32 C entry point (``qmm_gathered``,
    ``flash_decode_fwd``, ``flash_attention_fwd``, ``..._chunk_fwd``) and a
    bf16 call to its ``_bf16`` twin, with the same shape arguments and the
    plan of the form's own plan function (the attention forms'
    ``_plan_bf16``, the others' ``_plan``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import qmatmul as qm
    calls = []

    def recording(mod, bf16):
        fn = mod._kernel(bf16)

        def call(*args):
            calls.append((mod.__name__, bf16, fn.__name__, args))
            return fn(*args)
        return call
    for mod in (qm, fd, fa, ca):
        for bf16 in (False, True):
            monkeypatch.setitem(mod._fns, bf16, recording(mod, bf16))
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(4, 256, device=dev).to(dt)
        w = torch.randn(300, 256, device=dev).to(dt)
        qm.qmatmul_gathered(x, w, None, torch.arange(38, device=dev,
                                                     dtype=torch.int32))
        q = torch.randn(2, 2, 5, 128, device=dev).to(dt)
        kv = torch.randn(2, 145, 2, 128, device=dev).to(dt)
        slots = torch.arange(145, device=dev, dtype=torch.int32)[None].repeat(
            2, 1)
        fd.flash_decode(q, kv, kv, slots, torch.full((2,), 144, device=dev,
                                                     dtype=torch.int32))
        qp = torch.randn(2, 64, 10, 128, device=dev).to(dt)
        kp = torch.randn(2, 64, 2, 128, device=dev).to(dt)
        fa.flash_attention(qp, kp, kp)
        kb = torch.randn(2, 128, 2, 128, device=dev).to(dt)
        ca.chunk_attention(qp[:, :16].contiguous(), kb, kb,
                           torch.tensor([0, 64], device=dev,
                                        dtype=torch.int32))
    assert len(calls) == 8
    fp32, bf16 = calls[:4], calls[4:]
    want = {"repro_torch.kernels.qmatmul": "qmm_gathered",
            "repro_torch.kernels.flash_decode": "flash_decode_fwd",
            "repro_torch.kernels.flash_attention": "flash_attention_fwd",
            "repro_torch.kernels.chunk_attention":
                "flash_attention_chunk_fwd"}
    def plan(m, args):
        extra = args[_QMM_PLAN] if m.endswith("qmatmul") else ()
        return list(args[_PLAN_ARGS[m]]) + list(extra)

    def bf16_plan(m, args):
        """plan(m, args) of the fp32 call with the bf16 plan function's
        heads, sub-tiles and pairing or split in place of its own"""
        want = plan(m, args)
        sms = build.sm_count(dev)
        if m.endswith("flash_attention"):            # B S Hq Hkv D .. hb qsub pair
            p = fa._plan_bf16(*want[1:5], sms)
            want[8:11] = [p.heads_per_block, p.qsub, int(p.pair)]
        elif m.endswith("chunk_attention"):          # B S Skv Hq Hkv D .. hb qsub split
            p = ca._plan_bf16(*want[1:6], sms)
            want[8:11] = [p.heads_per_block, p.qsub, p.split]
        return want
    for (m, b, name, args), (m2, b2, name2, args2) in zip(fp32, bf16):
        assert (b, name) == (False, want[m])
        assert (m2, b2, name2) == (m, True, want[m] + "_bf16")
        assert len(args) == len(args2) and plan(m, args2) == bf16_plan(m,
                                                                       args)


#: test_tiny_forward_bf16_on_cuda_equals_cpu's limits, as a share of
#: max(1, max|cpu logits|): about 3x the largest reading with the sets
#: replayed (H100 80GB HBM3, 700 W: qwen2.5-14b 0.0105, mamba2-370m 0.0324
#: at the prefill, where no port kernel runs: CUDA's bf16 ops round at
#: other places than the CPU's). The control the qwen2.5-14b limit must
#: fail: the sets left free, 0.158
BF16_CUDA_TOL = {"qwen2.5-14b": 0.03, "mamba2-370m": 0.1}


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-370m"])
def test_tiny_forward_bf16_on_cuda_equals_cpu(dev, arch, monkeypatch):
    """A tiny config at bf16 through ``forward`` (prefill, then 4 decode
    steps fed the CPU's tokens) on the card against the CPU, same weights,
    the card replaying the CPU's active sets (a predictor score that ties
    within a bf16 unit may swap a neuron otherwise): the logits within
    BF16_CUDA_TOL x max(1, max|cpu|) (the card's kernels sum in fp32 and
    round once where the CPU's plain ops round every bf16 op), greedy
    tokens equal where the CPU's top-2 margin is wider."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import mp_ffn
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    sets, topk = [], mp_ffn.shared_topk_indices
    cfg = get_config(arch, tiny=True)
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    for i, layer in enumerate(params["layers"]):
        pred = layer.get("ffn", {}).get("pred")
        if pred is not None:
            pred["A"] = torch.from_numpy(np.random.default_rng(21 + i)
                                         .standard_normal(pred["A"].shape)
                                         .astype(np.float32) / 4)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int64))
    out = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        replay = iter(list(sets))

        def chosen(scores, k, replay=replay, cpu=name == "cpu"):
            if cpu:
                sets.append(topk(scores, k))
                return sets[-1]
            return next(replay).to(scores.device)
        monkeypatch.setattr(mp_ffn, "shared_topk_indices", chosen)
        p = tree_map(lambda t: t.to(device), params)
        cache = T.init_cache(cfg, 2, 32, dtype=torch.bfloat16, device=device)
        logits, cache, _ = T.forward(cfg, p, tokens.to(device), cache=cache,
                                     mode="prefill")
        steps = [logits[:, -1].float().cpu()]
        for step in range(4):
            nxt = (out["cpu"][step] if name == "cuda" else steps[-1]).argmax(
                -1)[:, None]
            logits, cache, _ = T.forward(cfg, p, nxt.to(device), cache=cache,
                                         mode="decode")
            steps.append(logits[:, -1].float().cpu())
        out[name] = steps
    for c, g in zip(out["cpu"], out["cuda"]):
        tol = BF16_CUDA_TOL[arch] * max(1.0, float(c.abs().max()))
        assert float((c - g).abs().max()) <= tol
        top2 = c.topk(2, -1).values
        sure = top2[:, 0] - top2[:, 1] > tol
        assert torch.equal(c.argmax(-1)[sure], g.argmax(-1)[sure])
