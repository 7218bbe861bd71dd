"""Port parity: the plain PyTorch versions of the kernels
(repro_torch.kernels.ref) and the model's building blocks
(repro_torch.models.common) against the JAX oracles (repro.kernels.ref),
the Pallas kernels run in interpret mode on this CPU, and
repro.models.common. Float tolerances are fp32-level (1e-5) unless stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import quantize_int4, quantize_int8
from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.kernels.flash_decode import flash_decode as pallas_decode
from repro.kernels.qmatmul import qmatmul as pallas_qmatmul
from repro.models import common as JC
from repro_torch.kernels import ref as R
from repro_torch.models import common as C

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quant(w, precision):
    if precision == "fp":
        return w, None
    fn = quantize_int8 if precision == "int8" else quantize_int4
    q, s = fn(jnp.asarray(w), 0)
    return np.array(q), np.array(s)


@pytest.mark.parametrize("precision", ["fp", "int8", "int4"])
def test_qmatmul_ref_matches_jax_ref_and_pallas(precision):
    rng = _rng(0)
    x = _f32(rng, 3, 256)
    wq, s = _quant(_f32(rng, 256, 128, scale=1 / 16), precision)
    got = R.qmatmul_ref(_t(x), _t(wq), None if s is None else _t(s),
                        precision=precision).numpy()
    args = (jnp.asarray(x), jnp.asarray(wq), None if s is None else jnp.asarray(s))
    np.testing.assert_allclose(
        got, np.asarray(JR.qmatmul_ref(*args, precision=precision)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(pallas_qmatmul(*args, precision=precision, bk=128,
                                       bn=128, interpret=True)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("precision", ["fp", "int8", "int4"])
@pytest.mark.parametrize("n", [7, 38])
def test_gathered_col_equals_qmatmul_of_gathered_columns(precision, n):
    rng = _rng(1)
    x = _f32(rng, 4, 64)
    wq, s = _quant(_f32(rng, 64, 90, scale=1 / 8), precision)
    idx = rng.permutation(90)[:n].astype(np.int32)
    got = R.qmm_gathered_ref(_t(x), _t(wq), None if s is None else _t(s),
                             _t(idx), precision=precision, layout="col")
    want = JR.qmatmul_ref(jnp.asarray(x), jnp.asarray(wq[:, idx]),
                          None if s is None else jnp.asarray(s[idx]),
                          precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # idx=None is plain qmatmul
    full = R.qmm_gathered_ref(_t(x), _t(wq), None if s is None else _t(s),
                              precision=precision, layout="col")
    np.testing.assert_allclose(
        full.numpy(), np.asarray(JR.qmatmul_ref(
            jnp.asarray(x), jnp.asarray(wq),
            None if s is None else jnp.asarray(s), precision=precision)),
        **TOL)


@pytest.mark.parametrize("precision", ["fp", "int8", "int4"])
def test_gathered_row_equals_dequantized_rows(precision):
    rng = _rng(2)
    w = _f32(rng, 90, 64, scale=1 / 8)
    if precision == "fp":
        wq, s, deq = w, None, w
    elif precision == "int8":
        q, s = quantize_int8(jnp.asarray(w), 1)
        wq, s = np.array(q), np.array(s)
        deq = wq.astype(np.float32) * s[:, None]
    else:
        q, s = quantize_int4(jnp.asarray(w), 1)
        from repro.core.quantize import unpack_int4
        wq, s = np.array(q), np.array(s)
        deq = np.asarray(unpack_int4(jnp.asarray(wq), 1)).astype(
            np.float32) * s[:, None]
    idx = rng.permutation(90)[:13].astype(np.int32)
    h = _f32(rng, 3, 13)
    y0 = _f32(rng, 3, 64)
    out = _t(y0)
    got = R.qmm_gathered_ref(_t(h), _t(wq), None if s is None else _t(s),
                             _t(idx), precision=precision, layout="row",
                             out=out)
    assert got is out
    np.testing.assert_allclose(got.numpy(), y0 + h @ deq[idx], **TOL)


@pytest.mark.parametrize("S,bs", [(64, 32), (96, 32)])
def test_flash_decode_ref_matches_jax_ref_and_pallas(S, bs):
    rng = _rng(3)
    B, Hkv, G, D = 2, 2, 4, 32
    q, k, v = _f32(rng, B, Hkv, G, D), _f32(rng, B, S, Hkv, D), \
        _f32(rng, B, S, Hkv, D)
    slots = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    slots[1, 3:7] = -1
    lengths = np.array([S // 2, S - 1], np.int32)
    got = R.flash_decode_ref(_t(q), _t(k), _t(v), _t(slots),
                             _t(lengths)).numpy()
    jargs = tuple(map(jnp.asarray, (q, k, v, slots, lengths)))
    np.testing.assert_allclose(got, np.asarray(JR.flash_decode_ref(*jargs)),
                               **TOL)
    np.testing.assert_allclose(
        got, np.asarray(pallas_decode(*jargs, bs=bs, interpret=True)), **TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_ref_matches_jax_ref_and_pallas(window):
    rng = _rng(4)
    B, S, Hq, Hkv, D = 2, 32, 8, 2, 32
    q, k, v = _f32(rng, B, S, Hq, D), _f32(rng, B, S, Hkv, D), \
        _f32(rng, B, S, Hkv, D)
    got = R.flash_attention_ref(_t(q), _t(k), _t(v), window=window).numpy()
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(
        got, np.asarray(JR.flash_attention_ref(*jargs, window=window)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(pallas_attention(*jargs, window=window, bq=16, bk=16,
                                         interpret=True)), **TOL)


def test_mp_ffn_gathered_ref_matches_reference_algorithm():
    from repro.core.quantize import build_neuron_banks
    from repro.core.quantize import unpack_int4 as junpack
    rng = _rng(5)
    d, f = 32, 60
    banks = {k: np.array(v) for k, v in build_neuron_banks(
        jnp.asarray(_f32(rng, d, f)), jnp.asarray(_f32(rng, d, f)),
        jnp.asarray(_f32(rng, f, d))).items()}
    sizes = {"k": 18, "fp16": 4, "int8": 5, "int4": 9}
    idx = rng.permutation(f)[:18]
    x = _f32(rng, 2, 3, d)
    got = R.mp_ffn_gathered_ref(_t(x), {k: _t(v) for k, v in banks.items()},
                                _t(idx), sizes, "silu").numpy()
    i16, i8, i4 = idx[:4], idx[4:9], idx[9:]
    wg = np.concatenate([
        banks["wg_fp"][:, i16], banks["wg_i8"][:, i8] * banks["wg_i8_s"][i8],
        np.asarray(junpack(jnp.asarray(banks["wg_i4"][:, i4]), 0))
        * banks["wg_i4_s"][i4]], axis=1)
    wu = np.concatenate([
        banks["wu_fp"][:, i16], banks["wu_i8"][:, i8] * banks["wu_i8_s"][i8],
        np.asarray(junpack(jnp.asarray(banks["wu_i4"][:, i4]), 0))
        * banks["wu_i4_s"][i4]], axis=1)
    wd = np.concatenate([
        banks["wd_fp"][i16], banks["wd_i8"][i8] * banks["wd_i8_s"][i8, None],
        np.asarray(junpack(jnp.asarray(banks["wd_i4"][i4]), 1))
        * banks["wd_i4_s"][i4, None]], axis=0)
    h = np.asarray(jax.nn.silu(jnp.asarray(x @ wg))) * (x @ wu)
    np.testing.assert_allclose(got, h @ wd, rtol=1e-4, atol=1e-4)


# --- models/common -----------------------------------------------------------


@pytest.mark.parametrize("name", ["rms_norm", "layer_norm"])
def test_norms_match(name):
    rng = _rng(6)
    x, w = _f32(rng, 2, 5, 48), _f32(rng, 48, scale=0.1)
    got = getattr(C, name)(_t(x), _t(w)).numpy()
    want = np.asarray(getattr(JC, name)(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    rng = _rng(7)
    x = _f32(rng, 2, 9, 4, 32)
    pos = np.tile(np.arange(3, 12, dtype=np.int32), (2, 1))
    got = C.rope(_t(x), _t(pos), theta).numpy()
    want = np.asarray(JC.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["silu", "relu", "gelu"])
def test_activations_match(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    got = C.activation(name)(_t(x)).numpy()
    want = np.asarray(JC.activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _attn_inputs(seed, B, Sq, Skv, Hq, Hkv, D):
    rng = _rng(seed)
    return (_f32(rng, B, Sq, Hq, D), _f32(rng, B, Skv, Hkv, D),
            _f32(rng, B, Skv, Hkv, D))


def test_chunked_attention_prefill_matches():
    q, k, v = _attn_inputs(8, 2, 12, 12, 8, 2, 32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    got = C.chunked_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos)).numpy()
    want = JC.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # and against the Pallas prefill kernel's oracle
    np.testing.assert_allclose(
        got, np.asarray(JR.flash_attention_ref(*map(jnp.asarray, (q, k, v)))),
        **TOL)


def test_chunked_attention_decode_matches():
    # one query at position 9 over a 16-slot buffer: slots > 9 are invalid
    q, k, v = _attn_inputs(9, 2, 1, 16, 8, 2, 32)
    q_pos = np.full((2, 1), 9, np.int32)
    kv_pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    valid = kv_pos <= 9
    got = C.chunked_attention(_t(q), _t(k), _t(v), _t(q_pos), _t(kv_pos),
                              kv_valid=_t(valid)).numpy()
    want = JC.chunked_attention(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                                kv_valid=jnp.asarray(valid))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the decode kernel's oracle computes the same function
    dec = R.flash_decode_ref(_t(q[:, 0].reshape(2, 2, 4, 32)), _t(k), _t(v),
                             _t(kv_pos), _t(np.full((2,), 9, np.int32)))
    np.testing.assert_allclose(dec.numpy().reshape(2, 1, 8, 32), got, **TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 30.0)])
def test_chunked_attention_query_chunks_window_softcap(window, softcap):
    q, k, v = _attn_inputs(10, 1, 16, 16, 4, 2, 32)
    pos = np.arange(16, dtype=np.int32)[None]
    got = C.chunked_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                              window=window, softcap=softcap,
                              q_chunk=4).numpy()
    want = JC.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                window=window, softcap=softcap, q_chunk=4)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
