"""Port parity of long-context serving: the RoPE frequencies, the window
override, the int8 K/V cache (``kv_quant``), ``INPUT_SHAPES`` and
``launch/steps.build_case``, against the JAX package on the CPU.

Tolerances:
- RoPE: the frequencies bit for bit for every config with attention;
  ``rope`` within 1e-6 at positions from 128, 8704 and 524272 (fp32
  ``torch.pow`` frequencies missed by up to 3.9e-2 at 524272).
- ``_kv_quantize`` on identical inputs: bytes and scales bit for bit.
- qwen2.5-14b tiny with a window of 16: a prefill of 40 tokens (the ring
  wraps), then 12 greedy decode steps. Logits within 1e-4 (abs and rel),
  greedy tokens equal. Int8 K/V computed by each package from its own K
  (agreeing to ~1e-6 relative) may round to either side of a .5 tie: bytes
  may differ by 1 there, never more, and are counted (fewer than 1e-3 of
  them); scales within SCALE_RTOL = 2e-6 relative (seen 1.4e-6: a scale
  is max|K| / 127, as close as the two packages' K). Logits over an int8
  cache are held
  within 1e-4 at fixed bytes: each decode step starts from the reference's
  cache, and a step whose newly written bytes differ runs again with the
  reference's bytes.
- ``lm_loss(window=)``: loss within 1e-6 relative, every gradient leaf
  within 1e-4 of its largest magnitude; a ``make_train_step(window=)``
  step (``build_case``'s) loss within 1e-6 and grad_norm within 1e-5
  relative.
- ``build_case``: equal meta, cache and token specs and parameter counts
  for every arch x input shape x variant x kv_quant.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ASSIGNED_ARCHS
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import get_config as jax_config
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import common as JC
from repro.models import transformer as JT
from repro.training.optimizer import init_opt_state as jax_opt_state
from repro_torch.bridge import params_to_jax, to_tensor
from repro_torch.core.quantize import to_reference_layout
from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import steps as S
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import init_opt_state
from repro_torch.tree import tree_leaves, tree_map

from _torch_tiny import _paths, tiny_model

ARCH = "qwen2.5-14b"
WINDOW, PROMPT, STEPS, MAX_SEQ = 16, 40, 12, 64
TOL = dict(rtol=1e-4, atol=1e-4)
#: the share of int8 bytes that may differ by 1 at near-ties
TIE_SHARE = 1e-3
SCALE_RTOL = 2e-6
ATTN_ARCHS = [a for a in ASSIGNED_ARCHS if jax_config(a).num_heads]

#: the reference's forward, compiled once per shape and mode
_jforward = jax.jit(JT.forward, static_argnums=(0,),
                    static_argnames=("mode", "window", "m2"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cache(jcache) -> dict:
    """The reference's cache (numpy leaves) as the port's: the same layout,
    ``pos`` an int."""
    def entry(e):
        return {k: to_tensor(np.asarray(v), "cpu") for k, v in e.items()}
    return {"pattern": [entry(e) for e in jcache["pattern"]],
            "remainder": [entry(e) for e in jcache["remainder"]],
            "pos": int(jcache["pos"])}


def _int8_gap(got, want):
    """(elements that differ, largest |difference|) of two int8 arrays."""
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want))
    return int((d > 0).sum()), int(d.max())


def _check_int8(tc, jc):
    """The port's int8 cache against the reference's: scales within
    SCALE_RTOL, bytes within 1 and fewer than TIE_SHARE of them apart.
    Returns the bytes that differ."""
    diff = 0
    for te, je in zip(tc["pattern"], jc["pattern"]):
        for n in ("k_s", "v_s"):
            np.testing.assert_allclose(te[n].numpy(), je[n], rtol=SCALE_RTOL,
                                       atol=0)
        for n in ("k", "v"):
            assert te[n].dtype == torch.int8
            count, worst = _int8_gap(te[n].numpy(), je[n])
            assert worst <= 1 and count <= TIE_SHARE * je[n].size, (count,
                                                                     worst)
            diff += count
    return diff


# --- RoPE --------------------------------------------------------------------


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_rope_frequencies_bit_for_bit(arch):
    jcfg = jax_config(arch)
    half = jcfg.head_dim // 2
    want = np.asarray(jcfg.rope_theta ** (-jnp.arange(0, half,
                                                      dtype=jnp.float32)
                                          / half))
    got = C.rope_freqs(float(jcfg.rope_theta), half, torch.device("cpu"))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_rope_matches_at_long_positions(arch):
    jcfg = jax_config(arch)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, 2, jcfg.head_dim)).astype(np.float32)
    for start in (128, 8704, 524272):
        pos = np.broadcast_to(start + np.arange(16), (2, 16)).astype(np.int32)
        got = C.rope(torch.from_numpy(x), torch.from_numpy(pos),
                     jcfg.rope_theta).numpy()
        want = np.asarray(JC.rope(jnp.asarray(x), jnp.asarray(pos),
                                  jcfg.rope_theta))
        assert np.abs(got - want).max() <= 1e-6, (start,
                                                  np.abs(got - want).max())


# --- the int8 quantizer and the caches ---------------------------------------


def test_kv_quantize_bit_for_bit():
    """Drawn rows, a zero row (the 1e-8 floor), a row of exact .5 ties
    (scale 1: 0.5, 1.5, 2.5, ... and their negatives) and rows whose
    extreme maps to +127 and to -127."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 2, 32)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    ties = (np.arange(16, dtype=np.float32) + 0.5)
    x[0, 1, 0] = np.concatenate([ties, -ties])
    x[0, 1, 0, 0] = 127.0                           # scale exactly 1
    x[0, 2, 1] = np.linspace(-5.0, 2.0, 32, dtype=np.float32)   # -127
    x[0, 3, 1] = 1e-9 * np.arange(32, dtype=np.float32)         # floor
    got_q, got_s = T._kv_quantize(torch.from_numpy(x))
    want_q, want_s = JT._kv_quantize(jnp.asarray(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_q.numpy().tobytes() == np.asarray(want_q).tobytes()
    assert got_s.numpy().tobytes() == np.asarray(want_s).tobytes()
    q = got_q.numpy()
    assert (q[0, 0, 0] == 0).all()
    assert float(got_s[0, 0, 0]) == float(np.float32(1e-8))
    # half to even: 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -1.5 -> -2
    assert q[0, 1, 0, 0] == 127 and list(q[0, 1, 0, [1, 2, 16, 17]]) == [
        2, 2, 0, -2]
    assert q[0, 2, 1].min() == -127 and q.max() == 127
    got = T._kv_dequantize(got_q, got_s, torch.float32).numpy()
    want = np.asarray(JT._kv_dequantize(want_q, want_s, jnp.float32))
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_specs_match(arch):
    """Leaves, shapes and dtypes of the full config's cache, with and
    without the window override and the int8 K/V; the tiny config's
    ``init_cache`` zeros in the same layout."""
    for tiny in (False, True):
        jcfg, cfg = jax_config(arch, tiny=tiny), get_config(arch, tiny=tiny)
        for window in (0, 16):
            for kv_quant in (False, True):
                kw = dict(window=window, kv_quant=kv_quant)
                want = JT.cache_specs(jcfg, 2, 64, dtype=jnp.float32, **kw)
                got = (T.init_cache(cfg, 2, 64, device="cpu", **kw) if tiny
                       else T.cache_specs(cfg, 2, 64, **kw))
                assert len(got["pattern"]) == len(want["pattern"])
                assert len(got["remainder"]) == len(want["remainder"])
                for g, w in zip(got["pattern"] + got["remainder"],
                                want["pattern"] + want["remainder"]):
                    assert g.keys() == w.keys()
                    for n in w:
                        assert tuple(g[n].shape) == w[n].shape, (n, kw)
                        assert str(g[n].dtype).split(".")[-1] == str(
                            w[n].dtype), (n, kw)
                        if tiny:
                            assert not g[n].any()
                assert {t.device.type for e in got["pattern"]
                        for t in e.values()} == {"cpu" if tiny else "meta"}


# --- qwen2.5-14b tiny: a window of 16, a 40-token prompt, 12 decode steps ----


def _greedy(logits):
    return np.asarray(logits).argmax(-1).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    return tiny_model(ARCH)


@pytest.fixture(scope="module")
def runs(model):
    """Each package's prefill and 12 greedy decode steps on its own cache,
    with the int8 K/V off and on; the reference's cache before each step."""
    jcfg, jp, cfg, tp = model
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    out = {}
    for kv_quant in (False, True):
        kw = dict(window=WINDOW, kv_quant=kv_quant)
        jc = JT.init_cache(jcfg, 2, MAX_SEQ, dtype=jnp.float32, **kw)
        jl, jc, _ = _jforward(jcfg, jp, jnp.asarray(prompt), cache=jc,
                              mode="prefill", window=WINDOW, m2=True)
        tc = T.init_cache(cfg, 2, MAX_SEQ, device="cpu", **kw)
        tl, tc, _ = T.forward(cfg, tp, torch.from_numpy(prompt), cache=tc,
                              mode="prefill", window=WINDOW)
        r = {"prefill": (tl.numpy(), np.asarray(jl)),
             "prefill_cache": ({n: v.clone() for n, v in
                                tc["pattern"][0].items()},
                               _np(jc["pattern"][0])),
             "j_caches": [], "j_logits": [], "t_logits": [],
             "j_tokens": [], "t_tokens": []}
        jt, tt = _greedy(jl[:, -1]), _greedy(tl[:, -1].numpy())
        for _ in range(STEPS):
            r["j_caches"].append(_np(jc))
            r["j_tokens"].append(jt)
            r["t_tokens"].append(tt)
            jl, jc, _ = _jforward(jcfg, jp, jnp.asarray(jt[:, None]),
                                  cache=jc, mode="decode", window=WINDOW,
                                  m2=True)
            tl, tc, _ = T.forward(cfg, tp, torch.from_numpy(tt[:, None]),
                                  cache=tc, mode="decode", window=WINDOW)
            r["j_logits"].append(np.asarray(jl))
            r["t_logits"].append(tl.numpy())
            jt, tt = _greedy(jl[:, 0]), _greedy(tl[:, 0].numpy())
        r["j_final"], r["t_final"] = _np(jc), tc
        out[kv_quant] = r
    out["prompt"] = prompt
    return out


def test_prefill_over_a_window_matches(runs):
    """The prefill attends within the window over its own unquantized K/V:
    the same logits with the int8 cache on and off. The ring holds the
    last 16 tokens: fp32 K/V within 1e-4; their int8 bytes differ only at
    near-ties of the reference's own K/V over its scales."""
    for kv_quant in (False, True):
        got, want = runs[kv_quant]["prefill"]
        np.testing.assert_allclose(got, want, **TOL)
    fp_t, fp_j = runs[False]["prefill_cache"]
    for n in ("k", "v"):
        assert fp_t[n].shape[2] == WINDOW
        np.testing.assert_allclose(fp_t[n].numpy(), fp_j[n], **TOL)
    q_t, q_j = runs[True]["prefill_cache"]
    for n in ("k", "v"):
        np.testing.assert_allclose(q_t[f"{n}_s"].numpy(), q_j[f"{n}_s"],
                                   rtol=SCALE_RTOL, atol=0)
        count, worst = _int8_gap(q_t[n].numpy(), q_j[n])
        assert worst <= 1 and count <= TIE_SHARE * q_j[n].size
        # every byte apart sits at a .5 tie of the reference's K/V
        ratio = np.abs(fp_j[n]) / q_j[f"{n}_s"][..., None]
        apart = q_t[n].numpy() != q_j[n]
        assert (np.abs(ratio[apart] % 1.0 - 0.5) < 1e-3).all()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_over_the_ring_matches(runs, kv_quant):
    """12 greedy steps, each package on its own cache: tokens equal; fp32
    logits within 1e-4 and the ring's K/V too; the int8 cache's scales
    within SCALE_RTOL and its bytes within 1 at near-ties, counted."""
    r = runs[kv_quant]
    for jt, tt in zip(r["j_tokens"], r["t_tokens"]):
        np.testing.assert_array_equal(tt, jt)
    if kv_quant:
        _check_int8(r["t_final"], r["j_final"])
        return
    for got, want in zip(r["t_logits"], r["j_logits"]):
        np.testing.assert_allclose(got, want, **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(r["t_final"]["pattern"][0][n].numpy(),
                                   r["j_final"]["pattern"][0][n], **TOL)
    assert r["t_final"]["pos"] == int(r["j_final"]["pos"]) == PROMPT + STEPS


def _reference_bytes(jc_after, slot: int):
    """A stand-in for ``_kv_quantize`` that hands out, call by call (each
    layer's K, then its V), the bytes and scales the reference wrote at
    ``slot``."""
    e = jc_after["pattern"][0]
    queue = [(e[n][l][:, slot:slot + 1], e[f"{n}_s"][l][:, slot:slot + 1])
             for l in range(e["k"].shape[0]) for n in ("k", "v")]

    def fake(x):
        q, s = queue.pop(0)
        assert tuple(x.shape) == q.shape
        return to_tensor(q, "cpu"), to_tensor(s, "cpu")
    return fake


def test_int8_decode_logits_at_fixed_bytes(model, runs, monkeypatch):
    """Each of the reference's decode steps over its int8 cache, run by the
    port from that cache: the bytes the step writes equal the reference's
    but at near-ties, and the logits within 1e-4 where they are equal; and
    every step again with the reference's bytes for its token, logits
    within 1e-4."""
    jcfg, jp, cfg, tp = model
    r = runs[True]
    tok_in = lambda tok: torch.from_numpy(tok[:, None])
    for i, (jc, tok) in enumerate(zip(r["j_caches"], r["j_tokens"])):
        after = r["j_caches"][i + 1] if i + 1 < STEPS else r["j_final"]
        tl, tc, _ = T.forward(cfg, tp, tok_in(tok), cache=_port_cache(jc),
                              mode="decode", window=WINDOW)
        if not _check_int8(tc, after):
            np.testing.assert_allclose(tl.numpy(), r["j_logits"][i], **TOL)
        with monkeypatch.context() as mp:
            mp.setattr(T, "_kv_quantize",
                       _reference_bytes(after, (PROMPT + i) % WINDOW))
            tl, tc, _ = T.forward(cfg, tp, tok_in(tok),
                                  cache=_port_cache(jc), mode="decode",
                                  window=WINDOW)
        assert _check_int8(tc, after) == 0
        np.testing.assert_allclose(tl.numpy(), r["j_logits"][i], **TOL)


def test_decode_equals_the_whole_prompt_prefill(model, runs):
    """With the predictor at the reference's zero init (every active set
    0..k-1 on both paths), each decode step's logits over the ring equal a
    whole-prompt prefill's at the same position within 1e-4."""
    _, _, cfg, tp = model
    zeroed = {**tp, "layers": [
        {**layer, "ffn": {**layer["ffn"], "pred": {
            **layer["ffn"]["pred"],
            "A": torch.zeros_like(layer["ffn"]["pred"]["A"])}}}
        for layer in tp["layers"]]}
    seq = torch.from_numpy(runs["prompt"])
    cache = T.init_cache(cfg, 2, MAX_SEQ, window=WINDOW, device="cpu")
    logits, cache, _ = T.forward(cfg, zeroed, seq, cache=cache,
                                 mode="prefill", window=WINDOW)
    for _ in range(STEPS):
        nxt = logits[:, -1].argmax(-1)[:, None].to(seq.dtype)
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache, _ = T.forward(cfg, zeroed, nxt, cache=cache,
                                     mode="decode", window=WINDOW)
        whole, _, _ = T.forward(
            cfg, zeroed, seq, mode="prefill", window=WINDOW,
            cache=T.init_cache(cfg, 2, MAX_SEQ, window=WINDOW, device="cpu"))
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   whole[:, -1].numpy(), **TOL)


def test_int8_decode_tracks_fp32():
    """tests/test_models.py's test_kv_quant_decode_close_to_fp on the port:
    an int8 cache's decode tracks train mode's logits within 0.1."""
    cfg = get_config(ARCH, tiny=True)
    params = T.init_params(cfg, seed=0, device="cpu", m2=False)
    B, S = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, S)))
    full, _, _ = T.forward(cfg, params, tokens, mode="train", m2=False)
    full = full.detach()
    cache = T.init_cache(cfg, B, max_seq=S, kv_quant=True, device="cpu")
    lp, cache, _ = T.forward(cfg, params, tokens[:, :12], cache=cache,
                             mode="prefill", m2=False)
    errs = [float((lp - full[:, :12]).abs().max())]
    for i in range(12, S):
        li, cache, _ = T.forward(cfg, params, tokens[:, i:i + 1],
                                 cache=cache, mode="decode", m2=False)
        errs.append(float((li[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 0.1, errs
    assert cache["pattern"][0]["k"].dtype == torch.int8


def test_prefill_resume_over_an_int8_cache(model, runs, monkeypatch):
    """A 24-token prefill into an int8 cache, then an 8-token chunk at
    position 24 (``prefill_resume``): logits within 1e-4 with each package
    on its own cache, then from the reference's (with its bytes where the
    chunk's differ); scales within SCALE_RTOL, bytes at near-ties."""
    jcfg, jp, cfg, tp = model
    prompt = runs["prompt"]
    jc = JT.init_cache(jcfg, 2, 48, dtype=jnp.float32, kv_quant=True)
    _, jc, _ = _jforward(jcfg, jp, jnp.asarray(prompt[:, :24]), cache=jc,
                         mode="prefill", window=0, m2=True)
    tc = T.init_cache(cfg, 2, 48, kv_quant=True, device="cpu")
    T.forward(cfg, tp, torch.from_numpy(prompt[:, :24]), cache=tc,
              mode="prefill")
    before = _np(jc)
    chunk = prompt[:, 24:32]
    jl, jc, _ = _jforward(jcfg, jp, jnp.asarray(chunk), cache=jc,
                          mode="prefill_resume", window=0, m2=True)
    after = _np(jc)
    tl, tc, _ = T.forward(cfg, tp, torch.from_numpy(chunk), cache=tc,
                          mode="prefill_resume")
    _check_int8(tc, after)
    assert tc["pos"] == int(after["pos"]) == 32
    if not _check_int8(tc, after):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tc = _port_cache(before)
    tl, tc, _ = T.forward(cfg, tp, torch.from_numpy(chunk), cache=tc,
                          mode="prefill_resume")
    if _check_int8(tc, after):
        e = after["pattern"][0]
        queue = [(e[n][l][:, 24:32], e[f"{n}_s"][l][:, 24:32])
                 for l in range(cfg.num_layers) for n in ("k", "v")]
        monkeypatch.setattr(T, "_kv_quantize", lambda x: tuple(
            to_tensor(a, "cpu") for a in queue.pop(0)))
        tl, tc, _ = T.forward(cfg, tp, torch.from_numpy(chunk),
                              cache=_port_cache(before),
                              mode="prefill_resume")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_prefill_resume_refuses_a_window_in_both(model):
    jcfg, jp, cfg, tp = model
    tok = np.zeros((1, 4), np.int32)
    jc = JT.init_cache(jcfg, 1, 32, window=WINDOW, dtype=jnp.float32)
    with pytest.raises(AssertionError, match="sliding-window"):
        JT.forward(jcfg, jp, jnp.asarray(tok), cache=jc,
                   mode="prefill_resume", window=WINDOW, m2=True)
    tc = T.init_cache(cfg, 1, 32, window=WINDOW, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        T.forward(cfg, tp, torch.from_numpy(tok), cache=tc,
                  mode="prefill_resume", window=WINDOW)


def test_rows_refuse_the_window_and_int8(model):
    """The server's stacked rows run neither (nor does the reference's
    server)."""
    _, _, cfg, tp = model
    tok = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="int8"):
        T.forward(cfg, tp, tok, mode="prefill", rows=True,
                  cache=T.init_cache(cfg, 2, 8, kv_quant=True, device="cpu"))
    with pytest.raises(NotImplementedError, match="window"):
        T.forward(cfg, tp, tok, mode="prefill", rows=True, window=4,
                  cache=T.init_cache(cfg, 2, 8, window=4, device="cpu"))


# --- training within a window ------------------------------------------------


@pytest.fixture(scope="module")
def dense(model):
    """``model``'s weights with the dense FFN (``init_params(m2=False)``'s
    leaves: the fp banks as ``wg``, ``wu``, ``wd``) in both packages, and a
    batch of 2 x 16 tokens."""
    jcfg, jp, cfg, tp = model
    names = ("wg", "wu", "wd")
    jd = {**jp, "layers": {"pattern": [
        {**layer, "ffn": {n: layer["ffn"]["banks"][f"{n}_fp"] for n in names}}
        for layer in jp["layers"]["pattern"]], "remainder": []}}
    td = {**tp, "layers": [
        {**layer, "ffn": {n: to_reference_layout(layer["ffn"]["banks"])[
            f"{n}_fp"] for n in names}} for layer in tp["layers"]]}
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16))
    return jcfg, jd, cfg, td, {"tokens": tokens.astype(np.int32)}


@pytest.fixture(scope="module")
def windowed_grads(dense):
    """The reference's ``lm_loss(window=5)`` and its gradients on
    ``dense``."""
    jcfg, jp, _, _, batch = dense
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(jcfg, p, jb, remat=False, window=5),
        has_aux=True))(jp)
    grads = _np(grads)
    return float(loss), grads, float(np.sqrt(sum(
        np.sum(np.square(g.astype(np.float64)))
        for g in jax.tree.leaves(grads))))


def test_lm_loss_within_a_window_matches(dense, windowed_grads):
    """At S = 16 over a window of 5: the loss, and the gradient of every
    leaf, of both packages' ``lm_loss(window=5)``; the window changes the
    loss."""
    _, _, cfg, tp, batch = dense
    jloss, jgrads, _ = windowed_grads
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    try:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, _ = T.lm_loss(cfg, tp, tb, remat=True, window=5)
        grads = torch.autograd.grad(loss, leaves)
        loss = float(loss.detach())
        unwindowed = float(T.lm_loss(cfg, tp, tb, remat=False)[0].detach())
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert loss == pytest.approx(jloss, rel=1e-6)
    assert abs(unwindowed - loss) > 1e-4
    by_id = {id(t): g for t, g in zip(leaves, grads)}
    got = _paths(params_to_jax(tree_map(lambda t: by_id[id(t)], tp), cfg))
    want = _paths(jgrads)
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-30), (path, err)


# --- launch/steps.build_case -------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


def _spec_count(tree) -> int:
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_build_case_matches_every_shape(arch, mesh):
    """Every input shape x {dense, m2} x kv_quant: equal meta (the chips
    aside: one card), cache and token specs and parameter count; the
    args on the meta device."""
    for shape in J_SHAPES:
        for variant in ("dense", "m2"):
            for kv_quant in (False, True):
                kw = dict(variant=variant, kv_quant=kv_quant)
                jc = JS.build_case(arch, shape, mesh, dtype=jnp.float32,
                                   **kw)
                tc = S.build_case(arch, shape, **kw)
                assert tc.name == jc.name
                assert tc.meta == dict(jc.meta, chips=1)
                assert tc.donate_argnums == jc.donate_argnums
                assert len(tc.args) == len(jc.args)
                assert sum(t.numel() for t in tree_leaves(tc.args[0])) == \
                    _spec_count(jc.args[0])
                assert all(t.device.type == "meta"
                           for t in tree_leaves(tc.args)
                           if isinstance(t, torch.Tensor))
                jb, tb = jc.args[-1], tc.args[-1]
                assert tb.keys() == jb.keys()
                for n in jb:
                    assert tuple(tb[n].shape) == jb[n].shape
                    assert str(tb[n].dtype).split(".")[-1] == str(
                        jb[n].dtype)
                if jc.meta["kind"] != "decode":
                    continue
                jcache, tcache = jc.args[1], tc.args[1]
                for g, w in zip(tcache["pattern"] + tcache["remainder"],
                                jcache["pattern"] + jcache["remainder"]):
                    assert g.keys() == w.keys()
                    for n in w:
                        assert tuple(g[n].shape) == w[n].shape
                        assert str(g[n].dtype).split(".")[-1] == str(
                            w[n].dtype)


def _small_long_500k(monkeypatch, kind: str, seq_len: int):
    """long_500k cut to 2 rows of ``seq_len`` positions, of ``kind``, over a
    window of 16 (decode) or 5 (train), in both packages."""
    for shapes, cls, steps in ((J_SHAPES, JInputShape, JS),
                               (INPUT_SHAPES, InputShape, S)):
        monkeypatch.setitem(shapes, "long_500k",
                            cls("long_500k", seq_len, 2, kind))
        monkeypatch.setattr(steps, "LONG_CONTEXT_WINDOW",
                            WINDOW if kind == "decode" else 5)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_build_case_serve_step_runs_like_the_reference(model, runs, mesh,
                                                       monkeypatch, kv_quant):
    """The tiny long_500k case (window 16 over 64 slots, m2): a 40-token
    prefill through forward, then 4 of the case's serve steps in each
    package; tokens equal, logits within 1e-4 wherever no int8 byte
    differs."""
    _small_long_500k(monkeypatch, "decode", 64)
    jcfg, jp, cfg, tp = model
    jcase = JS.build_case(ARCH, "long_500k", mesh, variant="m2",
                          dtype=jnp.float32, kv_quant=kv_quant, tiny=True)
    tcase = S.build_case(ARCH, "long_500k", variant="m2", kv_quant=kv_quant,
                         tiny=True)
    assert tcase.meta["window"] == jcase.meta["window"] == WINDOW
    kw = dict(window=WINDOW, kv_quant=kv_quant)
    jc = JT.init_cache(jcfg, 2, 64, dtype=jnp.float32, **kw)
    _, jc, _ = _jforward(jcfg, jp, jnp.asarray(runs["prompt"]), cache=jc,
                         mode="prefill", window=WINDOW, m2=True)
    tc = T.init_cache(cfg, 2, 64, device="cpu", **kw)
    T.forward(cfg, tp, torch.from_numpy(runs["prompt"]), cache=tc,
              mode="prefill", window=WINDOW)
    jfn = jax.jit(jcase.fn)
    tok = runs[kv_quant]["j_tokens"][0]
    for _ in range(4):
        jl, jc = jfn(jp, jc, {"tokens": jnp.asarray(tok[:, None])})
        tl, tc = tcase.fn(tp, tc, {"tokens": torch.from_numpy(tok[:, None])})
        np.testing.assert_array_equal(_greedy(tl.numpy()), _greedy(jl))
        if not kv_quant or not _check_int8(tc, _np(jc)):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = _greedy(jl)


def test_build_case_train_step_runs_like_the_reference(dense, mesh,
                                                       windowed_grads,
                                                       monkeypatch):
    """A tiny train case through long_500k's window (5 over 16 tokens):
    ``make_train_step(window=5)`` in both packages' ``build_case``; the
    loss within 1e-6 and grad_norm within 1e-5 relative of the reference's
    step and of its ``lm_loss(window=5)``."""
    _small_long_500k(monkeypatch, "train", 16)
    jcfg, jp, cfg, tp, batch = dense
    jcase = JS.build_case(ARCH, "long_500k", mesh, dtype=jnp.float32,
                          tiny=True)
    tcase = S.build_case(ARCH, "long_500k", tiny=True)
    assert tcase.meta == dict(jcase.meta, chips=1)
    assert tcase.meta["window"] == 5 and tcase.meta["kind"] == "train"
    assert [tuple(t.shape) for t in tree_leaves(tcase.args[2])] == [
        s.shape for s in jax.tree.leaves(jcase.args[2])]
    assert tuple(tcase.args[2]["tokens"].shape) == batch["tokens"].shape
    _, _, jm = jax.jit(jcase.fn)(jp, jax_opt_state(jp),
                                 {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    tparams = tree_map(lambda t: t.clone(), tp)
    _, _, tm = tcase.fn(tparams, init_opt_state(tparams),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    for want_loss, want_norm in ((float(jm["loss"]), float(jm["grad_norm"])),
                                 windowed_grads[::2]):
        assert float(tm["loss"]) == pytest.approx(want_loss, rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(want_norm, rel=1e-5)
