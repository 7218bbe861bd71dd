"""The port serves the reference's hybrid model, recurrentgemma-2b: RG-LRU
recurrent blocks (a gated linear recurrence, a tanh-GELU branch and a
causal depthwise conv) beside sliding-window attention over a ring K/V
cache, in the pattern (rglru, rglru, attn). At tiny size on the CPU against
the reference: the config field for field; ``causal_conv1d``, ``rg_lru``
and ``rglru_block`` within fp32 tolerance (the port's Hillis-Steele scan
sums in another order than ``jax.lax.associative_scan``); ``forward``'s
prefill and decode logits within 1e-4 and active sets rank for rank (two
ranks whose float64 scores tie at fp32 resolution may hold their neurons in
either order: the recurrence rounds otherwise than the reference's), on
the tiny config, on a 5-layer copy whose remainder runs, and through a
ring that wraps; the runner, ``launch/serve`` and ``launch/server`` equal to the
reference; the SSD bank files byte for byte. Inside the port, bit for bit:
a ``rows=True`` row equals the same row alone, batched decode equals
per-session decode. Two configs the port used to refuse run against the
reference too: a dense model with a window, a hybrid one with another
pattern."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import (as_json, model_from, reference_cli, shared_argv,
                         tiny_model)
from _torch_tiny import tokens as _tokens
from repro.configs.base import get_config as jax_config
from repro.core.engine_model import RealModelRunner as JaxRunner
from repro.models import common as JC
from repro.models import hybrid as JH
from repro.models import transformer as JT
from repro_torch.configs.base import SERVED, get_config
from repro_torch.core.engine_model import (RealModelRunner, _stack_rows,
                                           extract_layer_banks)
from repro_torch.launch import serve, server
from repro_torch.models import common as C
from repro_torch.models import hybrid as H
from repro_torch.models import transformer as T

ARCH = "recurrentgemma-2b"
TOL = dict(rtol=1e-4, atol=1e-4)
#: the recurrence and the conv alone: fp32 sums in another order
TOL_BLOCK = dict(rtol=1e-5, atol=1e-5)
OUT_KEYS = ("summary", "kv", "cache", "prefix", "persist", "carbon_g")

_MODELS = {}


def model(key: str = "tiny"):
    """Built once per key for the module: "tiny" (3 layers, F = 1), "five"
    (5 layers: F = 1, remainder 2), "eight" (F = 2, remainder 2),
    "dense_window" (qwen2.5-14b tiny with a window of 8) and
    "other_pattern" (qwen2.5-14b tiny as a hybrid of (rglru, attn))."""
    if key not in _MODELS:
        if key == "tiny":
            _MODELS[key] = tiny_model(ARCH)
        else:
            base, change = {
                "five": (ARCH, dict(num_layers=5)),
                "eight": (ARCH, dict(num_layers=8)),
                "dense_window": ("qwen2.5-14b", dict(window_size=8)),
                "other_pattern": ("qwen2.5-14b", dict(
                    family="hybrid", block_pattern=("rglru", "attn"),
                    lru_width=256))}[key]
            change = dict(change, name=f"{base}-{key}")
            _MODELS[key] = model_from(
                dataclasses.replace(jax_config(base, tiny=True), **change),
                dataclasses.replace(get_config(base, tiny=True), **change))
    return _MODELS[key]


def _prompts(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close_tree(ours, theirs, tol=TOL):
    """Every tensor of the port's tree within ``tol`` of the reference's
    array at the same place (lists, dicts; ints equal)."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _close_tree(ours[k], theirs[k], tol)
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _close_tree(a, b, tol)
    else:
        b = np.asarray(theirs)
        a = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


def _layer_ids(aux, cfg):
    """aux["active_idx"] as one array per layer, in layer order."""
    pat, F, _ = T.pattern_split(cfg)
    ids = aux["active_idx"]
    return ([np.asarray(ids["pattern"][l % len(pat)])[l // len(pat)]
             for l in range(F * len(pat))]
            + [np.asarray(a) for a in ids["remainder"]])


def _equal_idx(cfg, ours, theirs, scores=None):
    """aux["active_idx"] of both packages: the same structure and the same
    ids, rank for rank. ``scores``: each layer's summed predictor scores
    in float64 (from the port's FFN inputs); two ranks may then hold their
    neurons in either order where those scores tie at fp32 resolution
    (within 1e-6 of the largest): the recurrence's fp32 sums run in another
    order than the reference's, and a tie's order follows the rounding."""
    assert len(ours["pattern"]) == len(theirs["pattern"])
    assert len(ours["remainder"]) == len(theirs["remainder"])
    for l, (a, b) in enumerate(zip(_layer_ids({"active_idx": ours}, cfg),
                                   _layer_ids({"active_idx": theirs}, cfg))):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        if np.array_equal(a, b) or scores is None:
            np.testing.assert_array_equal(a, b)
            continue
        off = np.nonzero(a != b)[0]
        assert sorted(a[off]) == sorted(b[off]), l
        sc = scores[l]
        tie = 1e-6 * np.abs(sc).max()
        assert np.abs(sc[a[off]] - sc[b[off]]).max() <= tie, (l, off)


def _ffn_scores(monkeypatch, store):
    """Record, for every M2Cache FFN call of the port, its predictor's
    scores summed over the call's tokens, in float64."""
    from repro_torch.core import mp_ffn

    def scored(cfg, banks, pred, x, _run=mp_ffn.mp_ffn_apply, **kw):
        x64 = x.reshape(-1, x.shape[-1]).double()
        store.append((x64 @ pred["A"].double() @ pred["B"].double())
                     .sum(0).numpy())
        return _run(cfg, banks, pred, x, **kw)
    monkeypatch.setattr(T.mp, "mp_ffn_apply", scored)


def test_config_equals_reference_and_is_served():
    for tiny in (False, True):
        ours, theirs = get_config(ARCH, tiny), jax_config(ARCH, tiny)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    full = get_config(ARCH)
    assert ARCH in SERVED
    assert (full.family, full.num_layers, full.head_dim, full.window_size,
            full.num_heads // full.num_kv_heads) == ("hybrid", 26, 256,
                                                    2048, 10)
    assert T.pattern_split(full) == (("rglru", "rglru", "attn"), 8, 2)


def test_kv_payload_gate_equals_reference():
    """Ring slots alias positions and recurrent state has no token axis: no
    real KV residency in either package, so the engine takes the
    whole-prompt prefill."""
    from repro.core.kv_payload import supports_payloads as jax_gate
    from repro_torch.core.kv_payload import supports_payloads
    for tiny in (False, True):
        assert supports_payloads(get_config(ARCH, tiny)) is \
            jax_gate(jax_config(ARCH, tiny)) is False
    for key in ("dense_window", "other_pattern"):
        jcfg, _, cfg, _ = model(key)
        assert supports_payloads(cfg) is jax_gate(jcfg) is False


@pytest.mark.parametrize("S,with_state", [(1, True), (9, True), (9, False)])
def test_causal_conv1d_matches_reference(S, with_state):
    rng = np.random.default_rng(40 + S)
    B, W, Cw = 3, 4, 16
    x = rng.standard_normal((B, S, Cw)).astype(np.float32)
    w = rng.standard_normal((W, Cw)).astype(np.float32)
    b = rng.standard_normal((Cw,)).astype(np.float32)
    st = rng.standard_normal((B, W - 1, Cw)).astype(np.float32) \
        if with_state else None
    jy, js = JC.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st))
    ty, ts = C.causal_conv1d(_t(x), _t(w), _t(b),
                             None if st is None else _t(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL_BLOCK)
    # the new state is the last W - 1 inputs: bit for bit
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("S,with_state", [(1, True), (1, False), (37, True),
                                          (37, False), (64, True)])
def test_rg_lru_matches_reference(S, with_state):
    rng = np.random.default_rng(50 + S)
    B, W = 2, 24
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    r = rng.uniform(0, 1, (B, S, W)).astype(np.float32)
    i = rng.uniform(0, 1, (B, S, W)).astype(np.float32)
    lam = rng.uniform(-1, 2, (W,)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if with_state \
        else None
    jh, jf = JH.rg_lru(jnp.asarray(x), jnp.asarray(r), jnp.asarray(i),
                       jnp.asarray(lam),
                       None if h0 is None else jnp.asarray(h0))
    th, tf = H.rg_lru(_t(x), _t(r), _t(i), _t(lam),
                      None if h0 is None else _t(h0))
    assert th.shape == jh.shape and tf.shape == jf.shape
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL_BLOCK)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL_BLOCK)


def test_linear_scan_is_the_recurrence():
    """The Hillis-Steele scan against the recurrence run step by step, in
    float64, at lengths around powers of two."""
    rng = np.random.default_rng(59)
    for S in (1, 2, 3, 8, 31, 33, 100):
        a = rng.uniform(0, 1, (2, S, 5))
        b = rng.standard_normal((2, S, 5))
        h, want = np.zeros((2, 5)), []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        got = H.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.stack(want, 1),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("S,with_state", [(1, True), (12, True), (12, False)])
def test_rglru_block_matches_reference(S, with_state):
    """The block of the tiny model's first layer, with its special leaves
    drawn (conv weights and bias, gate biases, Lambda) so that none is the
    init's constant."""
    jcfg, jp, cfg, tp = model()
    rng = np.random.default_rng(60 + S)
    jl = {k: np.asarray(v[0]) for k, v in jp["layers"]["pattern"][0].items()
          if k != "ffn"}
    for k in ("conv_w", "conv_b", "b_a", "b_i", "lam"):
        jl[k] = (rng.standard_normal(jl[k].shape) / 2).astype(np.float32)
    B, W, cw = 2, cfg.lru_width, cfg.ssm_conv_width
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"h": rng.standard_normal((B, W)).astype(np.float32),
                 "conv": rng.standard_normal((B, cw - 1, W)).astype(
                     np.float32)}
    jy, js = JH.rglru_block(
        jcfg, {k: jnp.asarray(v) for k, v in jl.items()}, jnp.asarray(x),
        None if state is None else {k: jnp.asarray(v)
                                    for k, v in state.items()},
        0, mode="decode" if S == 1 else "prefill")
    ty, ts = H.rglru_block(cfg, {k: _t(v) for k, v in jl.items()}, _t(x),
                           None if state is None else {
                               k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert (ts is None) is (js is None)
    if js is not None:
        _close_tree(ts, js)


def test_init_params_follow_reference_rules_and_shapes():
    """The port's own init: the reference's leaves and shapes per layer
    kind, Lambda 0.7 and the conv weights 1 / width (transformer.py:
    280-286), biases and norms zero."""
    for key in ("tiny", "five"):
        jcfg, _, cfg, _ = model(key)
        specs = JT.abstract_params(jcfg, dtype=jnp.float32, m2=True)
        own = T.init_params(cfg, seed=3, device="cpu")
        pat, F, rem = T.pattern_split(cfg)
        assert len(own["layers"]) == cfg.num_layers
        for l, layer in enumerate(own["layers"]):
            spec = (jax.tree.map(lambda s: s.shape[1:],
                                 specs["layers"]["pattern"][l % len(pat)])
                    if l < F * len(pat) else jax.tree.map(
                        lambda s: s.shape,
                        specs["layers"]["remainder"][l - F * len(pat)]))
            assert set(layer) == set(spec)
            for k, v in layer.items():
                if k != "ffn":
                    assert tuple(v.shape) == spec[k], (l, k)
            if cfg.layer_kinds[l] == "rglru":
                assert torch.all(layer["lam"] == 0.7)
                assert torch.all(layer["conv_w"] == 1.0 / cfg.ssm_conv_width)
                for k in ("conv_b", "b_a", "b_i", "norm1", "norm2"):
                    assert float(layer[k].abs().max()) == 0.0
                assert float(layer["w_a"].abs().max()) > 0.0


def test_bridge_unstacks_repeat_major():
    """A 3-position pattern repeated twice with a remainder of 2: port layer
    l is the reference's pattern[l % 3][l // 3], then remainder[l - 6],
    every leaf's bytes kept (banks neuron-major)."""
    from repro_torch.core.quantize import to_reference_layout
    jcfg, jp, cfg, tp = model("eight")
    assert T.pattern_split(cfg) == (("rglru", "rglru", "attn"), 2, 2)
    layers = jp["layers"]
    for l, layer in enumerate(tp["layers"]):
        ref = (jax.tree.map(lambda a: np.asarray(a)[l // 3],
                            layers["pattern"][l % 3]) if l < 6
               else layers["remainder"][l - 6])
        assert set(layer) == set(ref)
        assert ("lam" in layer) is (cfg.layer_kinds[l] == "rglru")
        for k, v in layer.items():
            if k == "ffn":
                banks = to_reference_layout(v["banks"])
                for n, arr in ref["ffn"]["banks"].items():
                    assert banks[n].numpy().tobytes() == \
                        np.asarray(arr).tobytes()
                for n in ("A", "B"):
                    assert v["pred"][n].numpy().tobytes() == \
                        np.asarray(ref["ffn"]["pred"][n]).tobytes()
            else:
                assert v.numpy().tobytes() == np.asarray(ref[k]).tobytes()


def _steps(key, B, S, steps, buf, monkeypatch):
    """A prefill of an S-token prompt into a ``buf``-slot cache, then greedy
    decode steps (the reference's tokens fed to both), in both packages:
    logits, every cache leaf and the active sets held at every call.
    Returns both packages' greedy tokens."""
    jcfg, jp, cfg, tp = model(key)
    tokens = _prompts(cfg, 70 + S, B, S)
    jc = JT.init_cache(jcfg, B, buf, dtype=jnp.float32)
    tc = T.init_cache(cfg, B, buf, device="cpu")
    scores = []
    _ffn_scores(monkeypatch, scores)
    greedy, tok, mode = [], tokens, "prefill"
    for _ in range(steps + 1):
        scores.clear()
        jl, jc, ja = JT.forward(jcfg, jp, jnp.asarray(tok), cache=jc,
                                mode=mode, m2=True)
        tl, tc, ta = T.forward(cfg, tp, _t(tok), cache=tc, mode=mode)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _equal_idx(cfg, ta["active_idx"], ja["active_idx"], scores)
        _close_tree({k: tc[k] for k in ("pattern", "remainder")},
                    {k: jc[k] for k in ("pattern", "remainder")})
        assert int(tc["pos"]) == int(jc["pos"])
        jn = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        greedy.append((jn, torch.argmax(tl[:, -1], -1).numpy()))
        tok, mode = jn[:, None], "decode"
    return [g[0] for g in greedy], [g[1] for g in greedy]


@pytest.mark.parametrize("key", ["tiny", "five"])
def test_forward_prefill_and_decode_match_reference(key, monkeypatch):
    """The tiny config (F = 1) and a 5-layer copy (F = 1, remainder
    (rglru, rglru)): whole-prompt prefill, then decode steps."""
    theirs, ours = _steps(key, 2, 12, 4, 32, monkeypatch)
    np.testing.assert_array_equal(np.stack(ours), np.stack(theirs))
    _, _, cfg, _ = model(key)
    assert T.pattern_split(cfg)[2] == (2 if key == "five" else 0)


@pytest.mark.parametrize("S,steps", [(80, 6), (60, 8)])
def test_ring_that_wraps_matches_reference(S, steps, monkeypatch):
    """Window 64 over a buffer of 96: the ring holds min(64, 96) = 64 slots.
    A prompt of 80 keeps its last 64 tokens and masks the first queries'
    window; a prompt of 60 fills the ring below its end and the decode
    steps wrap it."""
    _, _, cfg, _ = model()
    assert cfg.window_size == 64
    c = T.init_cache(cfg, 2, 96, device="cpu")
    assert c["pattern"][2]["k"].shape == (1, 2, 64, 1, cfg.head_dim)
    theirs, ours = _steps("tiny", 2, S, steps, 96, monkeypatch)
    np.testing.assert_array_equal(np.stack(ours), np.stack(theirs))


def test_decode_slots_of_a_ring():
    """Each ring slot's position after writing token pos: slot s holds
    pos - ((pos - s) mod sbuf), -1 where never written."""
    pos = torch.tensor([5, 63, 64, 100])
    slots, lengths = T.decode_slots(pos, 64, ring=True)
    assert lengths.tolist() == [5, 63, 64, 100]
    assert slots[0, :6].tolist() == list(range(6))
    assert (slots[0, 6:] == -1).all()
    assert slots[1].tolist() == list(range(64))
    assert slots[2, 0] == 64 and slots[2, 1:].tolist() == list(range(1, 64))
    want = [100 - (100 - s) % 64 for s in range(64)]
    assert slots[3].tolist() == want
    assert slots.dtype == torch.int32


@pytest.mark.parametrize("key", ["dense_window", "other_pattern"])
def test_configs_once_refused_match_reference(key, monkeypatch):
    """A dense model with a window of 8 (a ring of 8 slots: a prompt of 12
    wraps it) and a hybrid of (rglru, attn) without one: prefill and decode
    against the reference."""
    theirs, ours = _steps(key, 2, 12, 3, 16, monkeypatch)
    np.testing.assert_array_equal(np.stack(ours), np.stack(theirs))


def test_prefill_resume_raises_on_hybrid():
    _, _, cfg, tp = model()
    c = T.init_cache(cfg, 1, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="prefill_resume"):
        T.forward(cfg, tp, torch.zeros((1, 4), dtype=torch.long), cache=c,
                  mode="prefill_resume")


def test_runner_tokens_and_active_sets_equal_reference():
    jcfg, jp, cfg, tp = model("five")
    prompts, gen = _prompts(cfg, 32, 2, 10), 4
    jtok, jidx = JaxRunner(jcfg, jp, max_seq=16).generate(prompts, gen)
    runner = RealModelRunner(cfg, tp, max_seq=16, device="cpu")
    ttok, tidx = runner.generate(prompts, gen)
    np.testing.assert_array_equal(ttok, jtok)
    for js, ts in zip(jidx, tidx):
        assert len(ts) == len(js) == cfg.num_layers
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b, a)
    assert len({tuple(np.asarray(i).ravel()) for i in jidx[0]}) > 1


@pytest.mark.parametrize("key", ["tiny", "five"])
def test_layer_bank_files_equal_reference(key):
    """The SSD tier's per-layer banks, in the reference's layer order
    (repeat-major, then the remainder), byte for byte."""
    from repro.core.engine_model import extract_layer_banks as jax_extract
    jcfg, jp, cfg, tp = model(key)
    theirs = jax_extract(jcfg, jp)
    ours = list(extract_layer_banks(cfg, tp))
    assert len(ours) == len(theirs) == cfg.num_layers
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for name in a:
            assert a[name].dtype == np.asarray(b[name]).dtype
            assert a[name].tobytes() == np.asarray(b[name]).tobytes()


def test_rows_row_equals_the_row_alone():
    """rows=True: three prompts prefilled together, then decode steps with
    the rows at their own positions (one of them past the ring's 64
    slots), give each row the bits it gets alone."""
    _, _, cfg, tp = model("five")
    rng = np.random.default_rng(33)
    B, S = 3, 10
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    stack = T.init_cache(cfg, B, 128, device="cpu")
    stack["pos"] = torch.zeros(B, dtype=torch.int64)
    logits, stack, aux = T.forward(cfg, tp, tok, cache=stack, mode="prefill",
                                   rows=True)
    caches = []
    for r in range(B):
        c = T.init_cache(cfg, 1, 128, device="cpu")
        lr, c, ar = T.forward(cfg, tp, tok[r:r + 1], cache=c, mode="prefill")
        assert torch.equal(logits[r:r + 1], lr)
        for a, b in zip(aux["active_idx"]["pattern"]
                        + aux["active_idx"]["remainder"],
                        ar["active_idx"]["pattern"]
                        + ar["active_idx"]["remainder"]):
            assert torch.equal(a[r], b)
        caches.append(c)
    # rows at their own positions: row 2 moved 60 tokens on, past the ring
    more = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 60)))
    c2 = T.init_cache(cfg, 1, 128, device="cpu")
    T.forward(cfg, tp, torch.cat([tok[2:3], more], 1), cache=c2,
              mode="prefill")
    caches[2] = c2
    stack = _stack_rows(caches)
    for _ in range(2):
        step = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
        logits, stack, aux = T.forward(cfg, tp, step, cache=stack,
                                       mode="decode", rows=True)
        for r, c in enumerate(caches):
            lr, c, ar = T.forward(cfg, tp, step[r:r + 1], cache=c,
                                  mode="decode")
            assert torch.equal(logits[r:r + 1], lr)
            assert torch.equal(aux["active_idx"]["remainder"][0][r],
                               ar["active_idx"]["remainder"][0])
    assert stack["pos"].tolist() == [12, 12, 72]


def test_serve_cli_equals_reference(monkeypatch, capsys):
    """launch/serve on the CPU prints the reference's modeled summary and
    generates its tokens, from the same weights and prompts."""
    from repro.core.engine import M2CacheEngine as JaxEngine
    from repro.launch import serve as jax_serve
    _, jp, cfg, tp = model()
    argv = ["--arch", ARCH, "--tiny", "--batch", "2", "--prompt-len", "9",
            "--gen-len", "4", "--dram-gb", "0.5"]
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 9), 0,
                                            cfg.vocab_size))
    results = []
    for Engine in (JaxEngine, serve.M2CacheEngine):
        run = Engine.generate
        monkeypatch.setattr(Engine, "generate", lambda self, *a, _run=run,
                            **kw: results.append(_run(self, *a, **kw))
                            or results[-1])
    monkeypatch.setattr(JT, "init_params", lambda *a, **k: jp)
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jax_serve.main()
    theirs = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(serve, "make_prompts", lambda *a: prompts)
    monkeypatch.setattr(serve.T, "init_params", lambda *a, **k: tp)
    serve.main(argv + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out)
    for key in ("tokens_per_s_modeled", "modeled_s", "cache", "carbon_g"):
        assert ours[key] == theirs[key], key
    np.testing.assert_array_equal(results[1].tokens, results[0].tokens)
    assert results[0].tokens.shape == (2, 4)


@pytest.fixture(scope="module")
def server_run():
    """The reference's server CLI and the port's on SHARED's traffic, from
    the same weights: whole-prompt prefill (no KV payloads), stacked in
    rows by --prefill-bucket 8."""
    _, jp, cfg, tp = model()
    theirs, (jrep,) = reference_cli(shared_argv(ARCH), jp)
    ours, rep, eng, _ = server.run(server.parse_args(
        shared_argv(ARCH) + ["--device", "cpu"]), cfg=cfg, params=tp)
    return theirs, jrep, as_json(ours), rep, eng


def _last(sess):
    if sess._batch is not None:
        return sess._batch.last[sess._row]
    return sess.last[0]


def _port_server(argv):
    _, _, cfg, tp = model()
    out, rep, _, _ = server.run(server.parse_args(argv + ["--device", "cpu"]),
                                cfg=cfg, params=tp)
    return out, rep


def test_server_cli_equals_reference(server_run):
    theirs, jrep, ours, rep, eng = server_run
    assert set(ours) == set(theirs) == set(OUT_KEYS)
    for key in OUT_KEYS:
        assert ours[key] == theirs[key], key
    assert _tokens(rep) == _tokens(jrep)
    assert not eng.supports_kv_payloads and eng.prefix_restored_tokens == 0
    assert eng.prefill_dispatches > 0
    for a, b in zip(sorted(rep.requests, key=lambda r: r.rid),
                    sorted(jrep.requests, key=lambda r: r.rid)):
        np.testing.assert_allclose(_last(a.session).numpy(),
                                   np.asarray(_last(b.session)), **TOL)


def test_batched_decode_equals_per_session():
    """A burst that fills the decode batch, prompts stacked four at a time
    in rows mode: the same tokens with batched decode and stacked prefill
    off."""
    burst = shared_argv(ARCH)
    burst = burst[:burst.index("--rate")] + ["--rate", "1e6", "--turns", "1"]
    out, rep = _port_server(burst)
    serial_out, serial = _port_server(burst + ["--no-batched-decode",
                                               "--prefill-bucket", "1"])
    assert _tokens(serial) == _tokens(rep)
    assert serial_out["summary"]["jit_dispatches_per_step"] > \
        out["summary"]["jit_dispatches_per_step"] == 1.0
    assert out["summary"]["total_tokens"] / out["summary"]["decode_steps"] \
        > 1.5
