"""Port parity at bf16, the reference's default precision.

Whole runs, one tiny config of each family (``_torch_bf16.FAMILIES``):
the reference's bf16 params carried over by ``repro_torch.bridge``, a
prefill of 2 x 16 tokens (internvl2-1b behind a 4-frame vlm prefix), four
greedy decode steps, ``m2=True``; qwen2.5-14b also two ``prefill_resume``
chunks. The reference runs once, in a subprocess whose XLA rounds every
bf16 op (``_torch_bf16`` says why); each family's test waits for its
``.npz``. Per step: the first layer's active set equal; the logits within
``TOL`` (the reference's own bf16 kernel tolerance, ``tests/
test_kernels.py``), or within a kept gap whose cause is written beside it;
the greedy token equal wherever the reference's top-2 margin exceeds the
tolerance.

Module by module, against the reference's eager ops on the same bf16
inputs: the activations, the norm and RoPE, an attention layer and the
M2Cache FFN; the banks that ``core.quantize.build_neuron_banks`` makes
from bf16 weights, byte for byte; and ``launch/steps.build_case`` at bf16
against the reference's arguments, leaf dtypes and bytes.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bf16 as H
from repro.configs.base import get_config as jax_config
from repro.core import mp_ffn as JM
from repro.core import quantize as JQ
from repro.launch import steps as JS
from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.configs.base import get_config
from repro_torch.core import mp_ffn as TM
from repro_torch.core import quantize as Q
from repro_torch.launch import steps as S
from repro_torch.models import common as C
from repro_torch.models import transformer as T

#: |port - reference| a logit may differ by: the reference's own bf16
#: tolerance for its kernels (tests/test_kernels.py)
TOL = 3e-2
#: arch -> (its bound, the cause), where a family's logits differ by more
#: than TOL. mamba2-370m (0.057 at the prompt, measured here): XLA computes
#: the bf16 cumsum of dt * A (the SSD's segsum and chunk decays) as a
#: blocked two-level scan that rounds every add to bf16 (its reduce-window
#: rewrite: 1 - 0.33 of a (64, 256) cumsum's values differ from a sum in
#: fp32 rounded once, which torch.cumsum gives); the SSD layer's other ops
#: take the reference's order and rounding
KEPT_GAPS = {"mamba2-370m": 8e-2}
#: waiting for the reference's subprocess, at most
REFERENCE_S = 600


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("bf16_reference")
    proc = H.start_reference(str(out))
    yield out, proc
    proc.kill()
    proc.communicate(timeout=60)


def _reference_arrays(reference, arch) -> dict:
    out, proc = reference
    path = out / f"{arch}.npz"
    t0 = time.monotonic()
    while not path.exists():
        if proc.poll() is not None and not path.exists():
            raise RuntimeError("the reference stopped before " + arch + ":\n"
                               + proc.stderr.read()[-3000:])
        assert time.monotonic() - t0 < REFERENCE_S, "the reference is late"
        time.sleep(0.2)
    with np.load(path) as z:
        return dict(z)


def _port_params(arch):
    jcfg, jp = H.reference_params(arch)
    cfg = get_config(arch, tiny=True)
    return jcfg, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _check_step(arch, tag, want, logits, aux):
    got = logits.float().numpy()
    ref = want[f"{tag}_logits"]
    assert got.shape == ref.shape and logits.dtype == torch.bfloat16
    assert np.isfinite(got).all()
    bound = KEPT_GAPS.get(arch, TOL)
    err = float(np.abs(got - ref).max())
    assert err <= bound, (arch, tag, err, bound)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > bound
    np.testing.assert_array_equal(got.argmax(-1)[sure], ref.argmax(-1)[sure])
    if f"{tag}_idx" in want:
        np.testing.assert_array_equal(
            aux["active_idx"]["pattern"][0][0].numpy(), want[f"{tag}_idx"])


@pytest.mark.parametrize("arch", H.FAMILIES)
def test_family_matches_reference_at_bf16(reference, arch):
    jcfg, cfg, tp = _port_params(arch)
    want = _reference_arrays(reference, arch)
    tokens, prefix = H.inputs(cfg)
    n_pre = 0 if prefix is None else H.PREFIX
    cache = T.init_cache(cfg, H.B, H.BUF + n_pre, dtype=torch.bfloat16,
                         device="cpu")
    logits, cache, aux = T.forward(
        cfg, tp, torch.from_numpy(tokens), cache=cache, mode="prefill",
        prefix=None if prefix is None else
        torch.from_numpy(prefix).to(torch.bfloat16))
    _check_step(arch, "prefill", want, logits, aux)
    for leaf in (cache["pattern"][0]).values():    # bf16 carries stay bf16
        assert leaf.dtype in (torch.bfloat16, torch.int8, torch.float32)
        if leaf.is_floating_point() and leaf.dim() > 2:
            assert leaf.dtype == torch.bfloat16
    for step in range(H.DECODES):
        nxt = torch.from_numpy(want[f"decode{step}_tokens"].copy())
        logits, cache, aux = T.forward(cfg, tp, nxt, cache=cache,
                                       mode="decode")
        _check_step(arch, f"decode{step}", want, logits, aux)
    if arch == "qwen2.5-14b":
        cache = T.init_cache(cfg, H.B, H.BUF, dtype=torch.bfloat16,
                             device="cpu")
        for c in range(H.S // H.CHUNK):
            logits, cache, aux = T.forward(
                cfg, tp, torch.from_numpy(
                    tokens[:, c * H.CHUNK:(c + 1) * H.CHUNK].copy()),
                cache=cache, mode="prefill_resume")
            _check_step(arch, f"chunk{c}", want, logits, aux)


def _bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x * scale, jnp.bfloat16)
    return xj, to_tensor(np.asarray(xj), "cpu")


def _same(got, want):
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("name", ["silu", "gelu", "sigmoid"])
def test_activation_bit_equal_at_bf16(name):
    xj, xt = _bf16((4096,), 1, 3.0)
    jf = jax.nn.sigmoid if name == "sigmoid" else JC.activation(name)
    tf = C.sigmoid if name == "sigmoid" else C.activation(name)
    _same(tf(xt), jf(xj))
    # fp32 keeps PyTorch's own forms
    F = torch.nn.functional
    assert torch.equal(tf(xt.float()), {
        "silu": F.silu, "sigmoid": torch.sigmoid,
        "gelu": lambda t: F.gelu(t, approximate="tanh")}[name](xt.float()))


@pytest.mark.parametrize("module", ["rms_norm", "rope"])
def test_norm_and_rope_bit_equal_at_bf16(module):
    xj, xt = _bf16((2, 16, 4, 32), 2)
    if module == "rms_norm":
        wj, wt = _bf16((32,), 3, 0.1)
        _same(C.rms_norm(xt, wt.float()), JC.rms_norm(xj, wj.astype(
            jnp.float32)))
    else:
        pos = np.arange(16, dtype=np.int32)[None].repeat(2, 0) + 1000
        _same(C.rope(xt, torch.from_numpy(pos), 1e6),
              JC.rope(xj, jnp.asarray(pos), 1e6))


@pytest.fixture(scope="module")
def qwen():
    jcfg, jp = H.reference_params("qwen2.5-14b")
    cfg = get_config("qwen2.5-14b", tiny=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jax.tree.map(lambda a: a[0], jp["layers"]["pattern"][0]), \
        cfg, tp["layers"][0]


def test_attention_layer_bit_equal_at_bf16(qwen):
    """One attention layer's prefill (norm, QKV with bias, RoPE, attention,
    the M2Cache FFN) and its cache, against the reference's eager ops."""
    jcfg, jl, cfg, tl = qwen
    xj, xt = _bf16((2, 16, cfg.d_model), 4)
    jc = jax.tree.map(lambda a: a[0], JT.init_cache(
        jcfg, 2, 24, dtype=jnp.bfloat16)["pattern"][0])
    ye, ce, _ = JT.attn_layer(jcfg, jl, xj, jc, 0, mode="prefill", window=0,
                              m2=True)
    tc = T.init_cache(cfg, 2, 24, dtype=torch.bfloat16, device="cpu")
    kv = {n: tc["pattern"][0][n][0] for n in ("k", "v")}
    yt, _, _ = T.attn_layer(cfg, tl, xt, kv, torch.zeros(2, dtype=torch.int64),
                            mode="prefill")
    _same(yt, ye)
    for n in ("k", "v"):
        _same(kv[n], ce[n])


def test_mp_ffn_at_bf16(qwen):
    """The M2Cache FFN's active set exactly; its output 99 % bit-equal to
    the reference's eager ops and elsewhere within one bf16 rounding at the
    output's scale (0.4 % of outputs differ, by at most 2^-9, measured here:
    a product's fp32 sum lands on the other side of a bf16 rounding)."""
    jcfg, jl, cfg, tl = qwen
    xj, xt = _bf16((2, 16, cfg.d_model), 5)
    yj, ij = JM.mp_ffn_apply(jcfg, jl["ffn"]["banks"], jl["ffn"]["pred"], xj)
    yt, it = TM.mp_ffn_apply(cfg, tl["ffn"]["banks"], tl["ffn"]["pred"], xt)
    np.testing.assert_array_equal(it["active_idx"].numpy(),
                                  np.asarray(ij["active_idx"]))
    assert yt.dtype == torch.bfloat16
    want = np.asarray(yj.astype(jnp.float32))
    got = yt.float().numpy()
    assert np.mean(got == want) >= 0.99
    assert np.abs(got - want).max() <= 2.0 ** -8 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("d,f", [(64, 96), (256, 512)])
def test_banks_byte_equal_from_bf16_weights(d, f):
    wg, tg = _bf16((d, f), 6)
    wu, tu = _bf16((d, f), 7)
    wd, td = _bf16((f, d), 8)
    want = JQ.build_neuron_banks(wg, wu, wd)
    got = Q.build_neuron_banks(tg, tu, td)
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        assert str(g.dtype).split(".")[-1] == w.dtype.name, k
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def _leaves(tree, prefix=""):
    """path -> leaf of a nested dict/list tree (tensors or
    ShapeDtypeStructs)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in
                _leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _leaves(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _dtype_name(x) -> str:
    return str(x.dtype).split(".")[-1]


@pytest.mark.parametrize("shape,variant,kv_quant", [
    ("prefill_32k", "dense", False), ("decode_32k", "dense", False),
    ("decode_32k", "m2", False), ("long_500k", "m2", False),
    ("decode_32k", "dense", True)])
def test_build_case_bf16_matches_reference_arguments(shape, variant,
                                                     kv_quant):
    """build_case at bf16 (tiny qwen2.5-14b): every leaf named as the
    reference names it has the reference's dtype (weights bf16; vectors,
    norms, scales, the predictor fp32; int8 banks and K/V), and each
    argument holds the reference's bytes. The cache and the batch keep the
    reference's layout, so there shapes are compared too."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = JS.build_case("qwen2.5-14b", shape, mesh, tiny=True,
                        variant=variant, kv_quant=kv_quant)
    port = S.build_case("qwen2.5-14b", shape, None, tiny=True,
                        variant=variant, kv_quant=kv_quant,
                        dtype=torch.bfloat16)
    assert len(port.args) == len(ref.args)
    for i, (pa, ra) in enumerate(zip(port.args, ref.args)):
        # the cache's position: the reference's an int32 scalar, the
        # port's a Python int
        pl, rl = [{p: x for p, x in _leaves(a).items()
                   if not p.endswith("/pos")} for a in (pa, ra)]
        nbytes = [sum(int(np.prod(x.shape)) * np.dtype(
            "float16" if _dtype_name(x) == "bfloat16" else _dtype_name(x))
            .itemsize for x in leaves.values() if hasattr(x, "shape"))
            for leaves in (pl, rl)]
        assert nbytes[0] == nbytes[1], (i, nbytes)
        if i == 0:                       # params: the layout differs
            names = {}
            for p, x in pl.items():
                names.setdefault(p.split("/")[-1], set()).add(_dtype_name(x))
            for p, x in rl.items():
                assert names[p.split("/")[-1]] == {_dtype_name(x)}, p
        else:                            # cache, batch: the same layout
            pl = {p: x for p, x in pl.items() if hasattr(x, "shape")}
            rl = {p: x for p, x in rl.items() if hasattr(x, "shape")}
            assert pl.keys() == rl.keys()
            for p, x in rl.items():
                assert (tuple(pl[p].shape), _dtype_name(pl[p])) == \
                    (tuple(x.shape), _dtype_name(x)), p


@pytest.mark.parametrize("arch", H.GLU_ARCHS)
def test_fused_glu_plain_version_bit_equal_at_bf16(reference, arch):
    """The fused GLU launch's plain version (``kernels/ref.py``): over the
    port's fp tier it gives the reference's bf16 h bit for bit (the
    reference's einsum, rounded once, then its activation with every op at
    bf16: silu for qwen2.5-14b, gelu for recurrentgemma-2b; the reference
    run with ``--xla_allow_excess_precision=false``); and its epilogue over
    the reference's own gate and up products gives the reference's h at
    every tier (the int tiers' products differ by design: the kernels scale
    the fp32 sum, the reference multiplies by weights dequantized to
    bf16)."""
    from repro_torch.kernels import ref as R
    want = _reference_arrays(reference, arch)
    _, cfg, tp = _port_params(arch)
    banks = tp["layers"][0]["ffn"]["banks"]
    bf = torch.bfloat16
    x = torch.from_numpy(want["glu_x"]).to(bf)
    k16 = want["glu_wg_fp"].shape[-1]
    i16 = torch.from_numpy(want["glu_idx"][:k16].copy())
    h = R.qmm_glu_ref(x.reshape(-1, x.shape[-1]),
                      [("fp", banks["wg_fp"], banks["wu_fp"], None, None,
                        i16)], act_name=cfg.ffn_act)[0].reshape(
                          *x.shape[:2], k16)
    assert h.dtype == bf
    np.testing.assert_array_equal(h.float().numpy(), want["glu_h_fp"])
    for tier in ("fp", "int8", "int4"):
        got = R.glu_bf16_ref(torch.from_numpy(want[f"glu_wg_{tier}"]),
                             torch.from_numpy(want[f"glu_wu_{tier}"]),
                             cfg.ffn_act)
        np.testing.assert_array_equal(got.float().numpy(),
                                      want[f"glu_h_{tier}"], err_msg=tier)


@pytest.mark.parametrize("kernel", ["qmatmul", "flash_decode",
                                    "flash_attention"])
def test_plain_versions_take_bf16_as_the_reference_oracles(kernel):
    """kernels/ref.py at bf16 inputs against repro/kernels/ref.py's oracles
    (and its Pallas kernels, in interpret mode, for the dtype they write):
    qmatmul and flash_decode write fp32, flash_attention q's dtype; the
    values within fp32 sums in another order (both widen the same bf16
    inputs)."""
    from repro.kernels import ref as JR
    from repro.kernels.flash_attention import flash_attention as pallas_fa
    from repro.kernels.flash_decode import flash_decode as pallas_fd
    from repro.kernels.qmatmul import qmatmul as pallas_qmm
    from repro_torch.kernels import ref as R
    if kernel == "qmatmul":
        (xj, xt), (wj, wt) = _bf16((4, 256), 9), _bf16((256, 128), 10)
        want = JR.qmatmul_ref(xj, wj)
        got = R.qmatmul_ref(xt, wt)
        pallas = pallas_qmm(xj, wj, bk=128, bn=128)
    elif kernel == "flash_decode":
        (qj, qt), (kj, kt), (vj, vt) = (_bf16(s, 11 + i) for i, s in
                                        enumerate([(2, 2, 4, 32),
                                                   (2, 64, 2, 32),
                                                   (2, 64, 2, 32)]))
        pos = np.arange(64, dtype=np.int32)[None].repeat(2, 0)
        ln = np.array([63, 40], dtype=np.int32)
        want = JR.flash_decode_ref(qj, kj, vj, jnp.asarray(pos),
                                   jnp.asarray(ln))
        got = R.flash_decode_ref(qt, kt, vt, torch.from_numpy(pos),
                                 torch.from_numpy(ln))
        pallas = pallas_fd(qj, kj, vj, jnp.asarray(pos), jnp.asarray(ln),
                           bs=32)
    else:
        (qj, qt), (kj, kt), (vj, vt) = (_bf16(s, 14 + i) for i, s in
                                        enumerate([(2, 64, 8, 32),
                                                   (2, 64, 2, 32),
                                                   (2, 64, 2, 32)]))
        want = JR.flash_attention_ref(qj, kj, vj, window=16)
        got = R.flash_attention_ref(qt, kt, vt, window=16)
        pallas = pallas_fa(qj, kj, vj, window=16, bq=32, bk=32)
    assert _dtype_name(got) == want.dtype.name == pallas.dtype.name
    w = np.asarray(want.astype(jnp.float32))
    tol = 2.0 ** -8 if got.dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(), w, rtol=tol,
                               atol=tol * max(1.0, np.abs(w).max()))
