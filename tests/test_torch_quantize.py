"""Port parity: weight quantization (repro_torch.core.quantize vs
repro.core.quantize). Banks must be byte-identical: same round-half-even,
same nibble order (low nibble = even index), same sign extension."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as JQ
from repro_torch.core import quantize as Q


def _w(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("d,f", [(64, 96), (32, 30), (128, 50)])
def test_build_neuron_banks_byte_equal(d, f):
    wg, wu, wd = _w(0, (d, f)), _w(1, (d, f)), _w(2, (f, d))
    want = JQ.build_neuron_banks(jnp.asarray(wg), jnp.asarray(wu),
                                 jnp.asarray(wd))
    got = Q.build_neuron_banks(torch.from_numpy(wg), torch.from_numpy(wu),
                               torch.from_numpy(wd))
    assert set(got) == set(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        out = got[name].numpy()
        assert out.dtype == ref.dtype, name
        assert out.shape == ref.shape, name
        # exact: ints byte for byte, scales bit for bit
        assert out.tobytes() == ref.tobytes(), name


@pytest.mark.parametrize("d,f", [(64, 96), (32, 30), (128, 50)])
def test_neuron_major_banks_round_trip_and_match_reference(d, f):
    """The port's layout (gate and up neuron-major) taken back to the
    reference's equals the JAX banks byte for byte, and the pair of layout
    functions round-trips byte for byte."""
    wg, wu, wd = _w(5, (d, f)), _w(6, (d, f)), _w(7, (f, d))
    want = JQ.build_neuron_banks(jnp.asarray(wg), jnp.asarray(wu),
                                 jnp.asarray(wd))
    ref = Q.build_neuron_banks(torch.from_numpy(wg), torch.from_numpy(wu),
                               torch.from_numpy(wd))
    port = Q.to_neuron_major(ref)
    assert set(port) == set(ref)
    for name in Q.NEURON_COLUMN_BANKS:
        assert port[name].shape == ref[name].shape[::-1], name
        assert port[name].is_contiguous(), name
    # each neuron is one contiguous row; an int4 byte keeps its nibble pair
    np.testing.assert_array_equal(
        Q.unpack_int4(port["wg_i4"], 1).numpy(),
        Q.unpack_int4(ref["wg_i4"], 0).numpy().T)
    back = Q.to_reference_layout(port)
    for name, arr in want.items():
        arr = np.asarray(arr)
        out = back[name].numpy()
        assert out.shape == arr.shape and out.dtype == arr.dtype, name
        assert out.tobytes() == arr.tobytes(), name
    again = Q.to_neuron_major(back)
    for name in port:
        assert again[name].numpy().tobytes() == port[name].numpy().tobytes()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_matches_reference(axis, bits):
    w = _w(3, (16, 24), 3.0)
    w[0, 0] = 0.0
    jf = JQ.quantize_int8 if bits == 8 else JQ.quantize_int4
    tf = Q.quantize_int8 if bits == 8 else Q.quantize_int4
    jq, js = jf(jnp.asarray(w), axis)
    tq, ts = tf(torch.from_numpy(w), axis)
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def test_round_half_even_and_all_zero_rows():
    # scale = 127/127 = 1 per column, so w/scale hits exact .5 ties
    w = np.zeros((4, 3), np.float32)
    w[:, 0] = [127.0, 0.5, 1.5, -2.5]
    w[:, 1] = [127.0, 2.5, -0.5, 3.5]
    q, s = Q.quantize_int8(torch.from_numpy(w), 0)
    jq, js = JQ.quantize_int8(jnp.asarray(w), 0)
    assert q[:, 0].tolist() == [127, 0, 2, -2]
    assert q[:, 1].tolist() == [127, 2, 0, 4]
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert float(s[2]) == float(js[2]) == pytest.approx(1e-8)


@pytest.mark.parametrize("shape,axis", [((7,), 0), ((5, 3), 0), ((3, 9), 1),
                                        ((4, 6), -1), ((2, 3, 5), 1)])
def test_pack_unpack_int4_roundtrip_and_bytes(shape, axis):
    q = np.random.default_rng(4).integers(-7, 8, shape).astype(np.int8)
    packed = Q.pack_int4(torch.from_numpy(q), axis)
    want = np.asarray(JQ.pack_int4(jnp.asarray(q), axis))
    assert packed.numpy().tobytes() == want.tobytes()
    assert packed.shape == want.shape
    n = shape[axis]
    back = Q.unpack_int4(packed, axis, orig_len=n)
    np.testing.assert_array_equal(back.numpy(), q)
    jback = np.asarray(JQ.unpack_int4(jnp.asarray(want), axis, orig_len=n))
    np.testing.assert_array_equal(back.numpy(), jback)


@pytest.mark.parametrize("axis", [0, 1])
def test_unpack_int4_every_byte_sign_extends_like_reference(axis):
    b = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    got = Q.unpack_int4(torch.from_numpy(b), axis).numpy()
    want = np.asarray(JQ.unpack_int4(jnp.asarray(b), axis))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("precision", ["fp16", "int8", "int4"])
def test_bytes_per_neuron(precision):
    assert Q.bytes_per_neuron(5120, precision) == \
        JQ.bytes_per_neuron(5120, precision)
