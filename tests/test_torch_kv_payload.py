"""Port parity of the server path's building blocks (repro_torch vs repro):
KV-block payloads (keys and bytes), the KV storage codec (dicts byte for
byte), the chunked-prefill attention and ``prefill_resume`` forward (1e-5:
fp32 sums in another order), and the per-row sparse FFN (each row against
the reference's ``mp_ffn_apply`` on that row alone, 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import kv_payload as JKP
from repro.core import mp_ffn as JM
from repro.core import quantize as JQ
from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.core import kv_payload as KP
from repro_torch.core import mp_ffn as M
from repro_torch.core import quantize as Q
from repro_torch.kernels import ops, ref
from repro_torch.models import common as C
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-5, atol=1e-5)


def _filled_caches(batch=2, buf=32, seed=0):
    """The same random KV bytes in a reference cache and a port cache."""
    jcfg = jax_config("qwen2.5-14b", tiny=True)
    cfg = get_config("qwen2.5-14b", tiny=True)
    jc = JT.init_cache(jcfg, batch, buf, dtype=jnp.float32)
    tc = T.init_cache(cfg, batch, buf, device="cpu")
    rng = np.random.default_rng(seed)
    for n in ("k", "v"):
        arr = rng.standard_normal(tc["pattern"][0][n].shape).astype(np.float32)
        jc["pattern"][0][n] = jnp.asarray(arr)
        tc["pattern"][0][n].copy_(torch.from_numpy(arr))
    return jcfg, cfg, jc, tc


# --- kv_payload --------------------------------------------------------------


@pytest.mark.parametrize("start,stop", [(0, 16), (16, 32), (5, 9)])
def test_extract_keys_and_bytes_match_reference(start, stop):
    _, _, jc, tc = _filled_caches(batch=1)
    want = JKP.extract(jc, start, stop)
    got = KP.extract(tc, start, stop)
    assert list(got) == list(want) == ["['pattern'][0]['k']",
                                       "['pattern'][0]['v']"]
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].shape == want[key].shape
        assert got[key].tobytes() == want[key].tobytes()


def test_row_of_a_stack_matches_reference_row():
    """A stacked row's payload equals the reference's payload of the same
    row: the reference stacks rows on a new leading axis, the port on the
    cache's batch axis; the payload is the one-row session's either way."""
    _, _, jc, tc = _filled_caches(batch=3)
    jstack = jax.tree.map(lambda a: jnp.moveaxis(a[:, :, None], 1, 0)
                          if a.ndim == 5 else a, jc)
    for row in range(3):
        want = JKP.extract(jstack, 4, 20, row=row)
        got = KP.extract(tc, 4, 20, row=row)
        for key in want:
            assert got[key].shape == want[key].shape == (2, 1, 16, 2, 32)
            assert got[key].tobytes() == want[key].tobytes()


def test_inject_scrub_round_trip_in_place():
    _, _, _, tc = _filled_caches(batch=2)
    before = {n: tc["pattern"][0][n].clone() for n in ("k", "v")}
    payload = KP.extract(tc, 8, 24, row=1)
    same = KP.scrub(tc, 8, 24, row=1)
    assert same is tc
    assert not tc["pattern"][0]["k"][:, 1, 8:24].any()
    assert torch.equal(tc["pattern"][0]["k"][:, 0], before["k"][:, 0])
    KP.inject(tc, payload, 8, row=1)
    for n in ("k", "v"):
        assert torch.equal(tc["pattern"][0][n], before[n])
    # a row payload goes into a one-row session cache at another position
    cfg = get_config("qwen2.5-14b", tiny=True)
    sess = T.init_cache(cfg, 1, 32, device="cpu")
    KP.inject(sess, payload, 0)
    assert torch.equal(sess["pattern"][0]["v"][:, 0, :16],
                       before["v"][:, 1, 8:24])
    assert KP.payload_nbytes(payload) == 2 * 16 * 2 * 2 * 32 * 4


def test_token_nbytes_and_gate_match_reference():
    jcfg, cfg, _, _ = _filled_caches()
    want = JKP.token_nbytes(JT.cache_specs(jcfg, 1, max_seq=32,
                                           dtype=jnp.float32))
    assert KP.token_nbytes(T.cache_specs(cfg, 1, max_seq=32)) == want
    assert KP.supports_payloads(cfg) == JKP.supports_payloads(jcfg) is True
    assert KP.supports_payloads(None) is False


# --- KV storage codec ----------------------------------------------------------


def _payload(seed, shape=(2, 1, 16, 2, 32)):
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal(shape).astype(np.float32)
    arr[..., :8] *= 9.0                   # outlier groups
    if arr.ndim > 1:
        arr.reshape(-1, shape[-1])[1] = 0.0   # an all-zero row
    return {"['pattern'][0]['k']": arr,
            "['pattern'][0]['v']": rng.standard_normal(shape).astype(
                np.float32)}


def _same_dict(got, want):
    assert list(got) == list(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("shape", [(2, 1, 16, 2, 32), (1, 1, 5, 3, 12),
                                   (7,)])
def test_kv_codec_dicts_byte_identical(precision, shape):
    p = _payload(1, shape)
    q = Q.kv_quantize_payload(p, precision)
    _same_dict(q, JQ.kv_quantize_payload(p, precision))
    _same_dict(Q.kv_dequantize_payload(q), JQ.kv_dequantize_payload(q))
    assert Q.kv_payload_precision(q) == precision
    assert Q.kv_payload_nbytes(q) == JQ.kv_payload_nbytes(q)


@pytest.mark.parametrize("cur,to", [("fp16", "int8"), ("fp16", "int4"),
                                    ("int8", "int4"), ("int4", "int8"),
                                    ("int8", "fp16")])
def test_kv_requantize_matches_reference(cur, to):
    p = _payload(2)
    start = Q.kv_quantize_payload(p, cur)
    _same_dict(Q.kv_requantize_payload(start, to),
               JQ.kv_requantize_payload(start, to))


def test_numpy_int4_packing_matches_torch_and_reference():
    q = np.random.default_rng(3).integers(-7, 8, (5, 9)).astype(np.int8)
    packed = Q._pack_int4_np(q, axis=1)
    assert packed.tobytes() == np.asarray(JQ.pack_int4(q, axis=1)).tobytes()
    assert torch.equal(torch.from_numpy(packed),
                       Q.pack_int4(torch.from_numpy(q), axis=1))
    np.testing.assert_array_equal(Q._unpack_int4_np(packed, 1, orig_len=9), q)


# --- chunked-prefill attention and the prefill_resume forward -----------------


@pytest.mark.parametrize("pos0", [[0], [16, 48], [0, 32, 96, 112]])
def test_chunk_attention_matches_reference(pos0):
    rng = np.random.default_rng(4)
    B, S, Sbuf, Hq, Hkv, D = len(pos0), 16, 128, 8, 2, 32
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sbuf, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sbuf, Hkv, D)).astype(np.float32)
    p0 = np.asarray(pos0)
    q_pos = p0[:, None] + np.arange(S)[None]
    kv_pos = np.broadcast_to(np.arange(Sbuf)[None], (B, Sbuf))
    want = np.asarray(JC.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(q_pos),
                                           jnp.asarray(kv_pos)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.chunk_attention(tq, tk, tv, torch.from_numpy(q_pos))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(
        ref.chunk_attention_ref(tq, tk, tv, torch.from_numpy(p0)),
        C.chunked_attention(tq, tk, tv, torch.from_numpy(q_pos),
                            torch.from_numpy(kv_pos.copy())), **TOL)
    # large garbage above each row's front changes nothing
    tk2, tv2 = tk.clone(), tv.clone()
    for b, p in enumerate(pos0):
        tk2[b, p + S:] = 1e4
        tv2[b, p + S:] = -1e4
    assert torch.equal(ops.chunk_attention(tq, tk2, tv2,
                                           torch.from_numpy(q_pos)), got)


@pytest.fixture(scope="module")
def tiny_params():
    jcfg = jax_config("qwen2.5-14b", tiny=True)
    cfg = get_config("qwen2.5-14b", tiny=True)
    jp = JT.init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32,
                        m2=True)
    pred = jp["layers"]["pattern"][0]["ffn"]["pred"]
    pred["A"] = jnp.asarray(np.random.default_rng(6).standard_normal(
        pred["A"].shape).astype(np.float32) / 4.0)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def test_prefill_resume_chunks_match_reference(tiny_params):
    """Two 16-token chunks into a 64-slot buffer, the second at pos0 = 16:
    logits, K/V and active sets as the reference's."""
    jcfg, jp, cfg, tp = tiny_params
    tokens = np.random.default_rng(7).integers(0, 512, (1, 32)).astype(
        np.int32)
    jc = JT.init_cache(jcfg, 1, 64, dtype=jnp.float32)
    tc = T.init_cache(cfg, 1, 64, device="cpu")
    for c in range(2):
        chunk = tokens[:, 16 * c:16 * (c + 1)]
        jl, jc, ja = JT.forward(jcfg, jp, jnp.asarray(chunk), cache=jc,
                                mode="prefill_resume", m2=True)
        tl, tc, ta = T.forward(cfg, tp, torch.from_numpy(chunk), cache=tc,
                               mode="prefill_resume")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(ta["active_idx"]["pattern"][0].numpy(),
                                      np.asarray(ja["active_idx"]["pattern"][0]))
        for n in ("k", "v"):
            np.testing.assert_allclose(tc["pattern"][0][n].numpy(),
                                       np.asarray(jc["pattern"][0][n]), **TOL)
        assert tc["pos"] == int(jc["pos"]) == 16 * (c + 1)


def test_rows_forward_equals_each_row_alone(tiny_params):
    """rows=True: each row at its own position with its own active sets
    gives what that row gives as a one-row forward, bit for bit."""
    _, _, cfg, tp = tiny_params
    rng = np.random.default_rng(8)
    caches = []
    for p in (0, 16, 32):
        c = T.init_cache(cfg, 1, 64, device="cpu")
        if p:
            T.forward(cfg, tp, torch.from_numpy(rng.integers(0, 512, (1, p))),
                      cache=c, mode="prefill")
        caches.append(c)
    chunk = torch.from_numpy(rng.integers(0, 512, (3, 16)))
    from repro_torch.core.engine_model import _stack_rows
    stack = _stack_rows(caches)
    logits, stack, aux = T.forward(cfg, tp, chunk, cache=stack,
                                   mode="prefill_resume", rows=True)
    assert stack["pos"].tolist() == [16, 32, 48]
    assert aux["active_idx"]["pattern"][0].shape == (3, cfg.num_layers, 154)
    for r, c in enumerate(caches):
        lr, c, ar = T.forward(cfg, tp, chunk[r:r + 1], cache=c,
                              mode="prefill_resume")
        assert torch.equal(logits[r:r + 1], lr)
        assert torch.equal(aux["active_idx"]["pattern"][0][r],
                           ar["active_idx"]["pattern"][0])


@pytest.mark.parametrize("S", [1, 16])
def test_per_row_ffn_matches_reference_row_alone(tiny_params, S):
    jcfg, jp, cfg, tp = tiny_params
    layer = tp["layers"][1]["ffn"]
    jlayer = jax.tree.map(lambda a: a[1], jp["layers"]["pattern"][0]["ffn"])
    x = np.random.default_rng(9).standard_normal((4, S, cfg.d_model)).astype(
        np.float32)
    y, info = M.mp_ffn_apply(cfg, layer["banks"], layer["pred"],
                             torch.from_numpy(x), rows=True)
    assert info["active_idx"].shape == (4, 154)
    for r in range(4):
        jy, jinfo = JM.mp_ffn_apply(jcfg, jlayer["banks"], jlayer["pred"],
                                    jnp.asarray(x[r:r + 1]))
        np.testing.assert_array_equal(info["active_idx"][r].numpy(),
                                      np.asarray(jinfo["active_idx"]))
        np.testing.assert_allclose(y[r:r + 1].numpy(), np.asarray(jy), **TOL)
    assert len({tuple(i.tolist()) for i in info["active_idx"]}) > 1
