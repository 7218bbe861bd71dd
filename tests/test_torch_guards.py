"""Guards of the port's rules: repro_torch and chip_smoke.py never import JAX
or the JAX package; the kernel dispatch sends CPU tensors to the plain
versions and has no fallback from a kernel to them; entry points default to
CUDA and raise without it."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted("repro_torch" + ("." + ".".join(p.relative_to(PORT)
                                                  .with_suffix("").parts)
                                   if p.name != "__init__.py" or p.parent != PORT
                                   else "")
                  for p in PORT.rglob("*.py")
                  if p.name != "__init__.py" or p.parent == PORT)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'repro.'))\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "flax"), \
                f"{path}: imports {name}"


def test_kernel_sources_ship_with_the_package():
    from repro_torch.kernels import build
    for name in build.SOURCES:
        src = build.CSRC / f"{name}.cu"
        text = src.read_text()
        assert "Replaces: src/repro/kernels/" in text, name
        assert "What bounds it" in text and "Design:" in text, name
        assert 'extern "C"' in text, name


# --- dispatch -----------------------------------------------------------------


def _small_ffn(seed=0):
    from repro_torch.core.quantize import build_neuron_banks, to_neuron_major
    g = torch.Generator().manual_seed(seed)
    d, f = 32, 40
    banks = to_neuron_major(build_neuron_banks(torch.randn(d, f, generator=g),
                                               torch.randn(d, f, generator=g),
                                               torch.randn(f, d, generator=g)))
    idx = torch.randperm(f, generator=g)[:12]
    sizes = {"k": 12, "fp16": 3, "int8": 3, "int4": 6}
    return banks, idx, sizes, torch.randn(2, 3, d, generator=g)


def test_dispatch_sends_cpu_tensors_to_plain_versions():
    from repro_torch.kernels import flash_attention, flash_decode, ops, qmatmul, ref
    before = (qmatmul.launches, flash_decode.launches, flash_attention.launches)
    banks, idx, sizes, x = _small_ffn()
    assert torch.equal(ops.mp_ffn(x, banks, idx, sizes, "silu"),
                       ref.mp_ffn_gathered_ref(x, banks, idx, sizes, "silu"))
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 6, 8, 32, generator=g),
               torch.randn(2, 6, 2, 32, generator=g),
               torch.randn(2, 6, 2, 32, generator=g))
    pos = torch.arange(6)[None].expand(2, 6)
    out = ops.prefill_attention(q, k, v, pos)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v),
                               rtol=1e-5, atol=1e-5)
    dq = q[:, :1]
    slots = torch.where(pos <= 4, pos, -1).to(torch.int32)
    lengths = torch.full((2,), 4, dtype=torch.int32)
    out = ops.decode_attention(dq, k, v, slots, lengths)
    want = ref.flash_decode_ref(dq[:, 0].reshape(2, 2, 4, 32), k, v,
                                pos.to(torch.int32), lengths)
    torch.testing.assert_close(out.reshape(2, 2, 4, 32), want, rtol=1e-5,
                               atol=1e-5)
    # no kernel ran
    assert (qmatmul.launches, flash_decode.launches,
            flash_attention.launches) == before


def test_dispatch_has_no_fallback_path():
    src = (PORT / "kernels" / "ops.py").read_text()
    tree = ast.parse(src)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    assert "environ" not in src and "getenv" not in src
    # a tensor that is not on the CPU goes to the kernel, which refuses it
    from repro_torch.kernels import ops
    banks, idx, sizes, x = _small_ffn()
    meta = {k: v.to("meta") for k, v in banks.items()}
    with pytest.raises(ValueError, match="CUDA"):
        ops.mp_ffn(x.to("meta"), meta, idx.to("meta"), sizes, "silu")
    q = torch.zeros(1, 4, 4, 32, device="meta")
    k = torch.zeros(1, 4, 1, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.prefill_attention(q, k, k, torch.zeros(1, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, :1], k, k,
                             torch.zeros(1, 4, dtype=torch.int32, device="meta"),
                             torch.zeros(1, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("which", ["qmatmul", "flash_decode", "flash_attention"])
def test_kernel_wrappers_refuse_cpu_tensors(which):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.qmatmul import qmatmul_gathered
    with pytest.raises(ValueError, match="CUDA"):
        if which == "qmatmul":
            qmatmul_gathered(torch.zeros(2, 8), torch.zeros(8, 4))
        elif which == "flash_decode":
            flash_decode(torch.zeros(1, 1, 2, 32), torch.zeros(1, 4, 1, 32),
                         torch.zeros(1, 4, 1, 32),
                         torch.zeros(1, 4, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))
        else:
            flash_attention(torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32),
                            torch.zeros(1, 4, 1, 32))


# --- entry points default to CUDA ---------------------------------------------


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import M2CacheEngine
    from repro_torch.core.engine_model import RealModelRunner
    from repro_torch.launch.serve import build_parser, main
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2.5-14b", tiny=True)
    assert build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(cfg, 1, 8)
    params = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        RealModelRunner(cfg, params, max_seq=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        M2CacheEngine(cfg=cfg, params=params, dram_capacity_gb=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "qwen2.5-14b", "--tiny"])
    from repro_torch.launch import train as launch_train
    from repro_torch.training.train_loop import train
    assert launch_train.build_parser().parse_args(
        ["--arch", "qwen2.5-14b"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "qwen2.5-14b", "--tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, steps=1, batch_size=1, seq_len=8)
    assert resolve_device("cpu").type == "cpu"


def test_runner_refuses_params_on_another_device():
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine_model import RealModelRunner
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, device="cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        RealModelRunner(cfg, params, max_seq=8, device="cpu")


def test_prompts_and_init_come_from_torch_generators():
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2.5-14b", tiny=True)
    a, b = make_prompts(cfg, 2, 5, 7), make_prompts(cfg, 2, 5, 7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, make_prompts(cfg, 2, 5, 8))
    p1 = T.init_params(cfg, seed=4, device="cpu")
    p2 = T.init_params(cfg, seed=4, device="cpu")
    assert torch.equal(p1["layers"][1]["wqkv"], p2["layers"][1]["wqkv"])
