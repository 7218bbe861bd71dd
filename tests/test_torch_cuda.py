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
