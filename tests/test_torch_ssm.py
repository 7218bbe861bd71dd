"""The port serves the reference's SSM model, mamba2-370m: attention-free
Mamba-2 blocks (an input projection split into z, xBC and dt, a causal
depthwise conv, the SSD scan in its chunked dual form at prefill and its
recurrent form at decode, a gated RMSNorm, an output projection) and no FFN.
At tiny size on the CPU against the reference: the config field for field;
``_segsum``, ``ssd_chunked``, ``ssd_decode_step`` and ``ssm_block`` within
1e-5 (the port's pairwise products sum in another order than XLA's
einsums); ``forward``'s prefill and decode logits within 1e-4 at prompt
lengths that pad the last chunk, with empty active sets in the reference's
shapes; the runner's greedy tokens, ``launch/serve`` and ``launch/server``
equal to the reference; the SSD tier's files byte for byte. Inside the
port: a prefill then decode steps equal to one longer prefill (the
recurrent form against the chunked one), a ``rows=True`` row bit for bit
equal to the same row alone, batched decode equal to per-session decode."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import as_json, reference_cli, shared_argv, tiny_model
from _torch_tiny import tokens as _tokens
from repro.configs.base import get_config as jax_config
from repro.core.engine_model import RealModelRunner as JaxRunner
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs.base import SERVED, get_config
from repro_torch.core.engine_model import (RealModelRunner, _stack_rows,
                                           extract_layer_banks)
from repro_torch.launch import serve, server
from repro_torch.models import ssm as S_
from repro_torch.models import transformer as T

ARCH = "mamba2-370m"
TOL = dict(rtol=1e-4, atol=1e-4)
#: the SSD pieces alone: fp32 sums in another order
TOL_BLOCK = dict(rtol=1e-5, atol=1e-5)
OUT_KEYS = ("summary", "kv", "cache", "prefix", "persist", "carbon_g")

_MODEL = []


def model():
    """The tiny config's weights in both packages, built once."""
    if not _MODEL:
        _MODEL.append(tiny_model(ARCH))
    return _MODEL[0]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _prompts(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _layer(jp, l=0):
    """Layer ``l`` of the reference's tree as numpy arrays, its SSD leaves
    (``A_log``, ``dt_bias``, ``D``, the conv) drawn so that none is the
    init's constant."""
    rng = np.random.default_rng(80 + l)
    p = {k: np.asarray(v[l]) for k, v in jp["layers"]["pattern"][0].items()}
    for k in ("A_log", "dt_bias", "D", "conv_w", "conv_b", "gnorm_w"):
        p[k] = (rng.standard_normal(p[k].shape) / 2).astype(np.float32)
    return p


def test_config_equals_reference_and_is_served():
    for tiny in (False, True):
        ours, theirs = get_config(ARCH, tiny), jax_config(ARCH, tiny)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    full = get_config(ARCH)
    assert ARCH in SERVED
    assert (full.family, full.num_layers, full.d_model, full.d_inner,
            full.ssm_nheads, full.ssm_head_dim, full.ssm_state,
            full.ssm_chunk, full.d_ff, full.m2_enabled) == (
        "ssm", 48, 1024, 2048, 32, 64, 128, 256, 0, False)
    assert T.pattern_split(full) == (("ssm",), 48, 0)


def test_kv_payload_gate_equals_reference_and_resume_raises():
    """No KV cache: no real KV residency in either package, so the engine
    takes the whole-prompt prefill, and prefill_resume raises."""
    from repro.core.kv_payload import supports_payloads as jax_gate
    from repro_torch.core.kv_payload import supports_payloads
    for tiny in (False, True):
        assert supports_payloads(get_config(ARCH, tiny)) is \
            jax_gate(jax_config(ARCH, tiny)) is False
    _, _, cfg, tp = model()
    c = T.init_cache(cfg, 1, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="prefill_resume"):
        T.forward(cfg, tp, torch.zeros((1, 4), dtype=torch.long), cache=c,
                  mode="prefill_resume")


def test_segsum_matches_reference():
    a = np.random.default_rng(1).standard_normal((2, 3, 11)).astype(
        np.float32)
    got, want = S_._segsum(_t(a)).numpy(), np.asarray(JS._segsum(
        jnp.asarray(a)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL_BLOCK)


def _ssd_inputs(seed, b, s, nh, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, nh)).astype(np.float32)
    A = -rng.uniform(0.2, 2.0, (nh,)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, nh, p, n)).astype(np.float32)
    return x, dt, A, B, C, h0


@pytest.mark.parametrize("s,chunk,with_h0", [(16, 16, False), (16, 16, True),
                                             (64, 16, False), (64, 16, True)])
def test_ssd_chunked_matches_reference(s, chunk, with_h0):
    """One chunk and four (the inter-chunk recurrence carries the state
    across three boundaries), from zero and from a given state."""
    x, dt, A, B, C, h0 = _ssd_inputs(s + with_h0, 2, s, 3, 8, 5)
    kw = dict(chunk=chunk)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                            h0=jnp.asarray(h0) if with_h0 else None, **kw)
    ty, th = S_.ssd_chunked(*map(_t, (x, dt, A, B, C)),
                            h0=_t(h0) if with_h0 else None, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL_BLOCK)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL_BLOCK)


def test_ssd_decode_step_matches_reference():
    x, dt, A, B, C, h0 = _ssd_inputs(7, 3, 1, 4, 8, 6)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], h0)
    jy, jh = JS.ssd_decode_step(*map(jnp.asarray, args))
    ty, th = S_.ssd_decode_step(*map(_t, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL_BLOCK)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL_BLOCK)


@pytest.mark.parametrize("S,with_state", [(1, True), (1, False), (16, False),
                                          (33, True), (96, False)])
def test_ssm_block_matches_reference(S, with_state):
    """The block of the tiny model's first layer, prefill at lengths below,
    past and at whole chunks of 32 (the padding path), and decode."""
    jcfg, jp, cfg, _ = model()
    p = _layer(jp)
    rng = np.random.default_rng(90 + S)
    B, di, n = 2, cfg.d_inner, cfg.ssm_state
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"h": rng.standard_normal(
                     (B, cfg.ssm_nheads, cfg.ssm_head_dim, n)).astype(
                         np.float32),
                 "conv": rng.standard_normal(
                     (B, cfg.ssm_conv_width - 1, di + 2 * n)).astype(
                         np.float32)}
    mode = "decode" if S == 1 else "prefill"
    jy, js = JS.ssm_block(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), None if state is None else {
                              k: jnp.asarray(v) for k, v in state.items()},
                          0, mode=mode)
    ty, ts = S_.ssm_block(cfg, {k: _t(v) for k, v in p.items()}, _t(x),
                          None if state is None else {
                              k: _t(v) for k, v in state.items()}, mode=mode)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL_BLOCK)
    assert (ts is None) is (js is None)
    if js is not None:
        for k in ("h", "conv"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       **TOL_BLOCK)


def test_init_params_follow_reference_rules_and_bridge_keeps_bytes():
    """The port's own init: the reference's leaves and shapes, no ``ffn``,
    A_log 0, dt_bias 0.5, D 1, the conv weights 1 / width (transformer.py:
    271-279); the bridge carries every leaf's bytes, layer by layer."""
    jcfg, jp, cfg, tp = model()
    specs = JT.abstract_params(jcfg, dtype=jnp.float32, m2=True)
    own = T.init_params(cfg, seed=3, device="cpu")
    assert set(own) == set(specs) == {"final_norm", "layers", "embed"}
    want = {k: s.shape[1:] for k, s in specs["layers"]["pattern"][0].items()}
    for l, layer in enumerate(own["layers"]):
        assert {k: tuple(v.shape) for k, v in layer.items()} == want
        assert torch.all(layer["A_log"] == 0) and torch.all(layer["D"] == 1)
        assert torch.all(layer["dt_bias"] == 0.5)
        assert torch.all(layer["conv_w"] == 1.0 / cfg.ssm_conv_width)
        ref = {k: np.asarray(v)[l] for k, v in
               jp["layers"]["pattern"][0].items()}
        assert set(tp["layers"][l]) == set(ref)
        for k, v in tp["layers"][l].items():
            assert v.numpy().tobytes() == ref[k].tobytes()


def _steps(tokens, steps):
    """A whole-prompt prefill, then greedy decode steps (the reference's
    tokens fed to both), in both packages: logits, the cache's leaves and
    the active sets held at every call. Returns the port's logits of every
    call and both packages' greedy tokens."""
    jcfg, jp, cfg, tp = model()
    B = tokens.shape[0]
    jc = JT.init_cache(jcfg, B, 8, dtype=jnp.float32)
    tc = T.init_cache(cfg, B, 8, device="cpu")
    out, greedy, tok, mode = [], [], tokens, "prefill"
    for _ in range(steps + 1):
        jl, jc, ja = JT.forward(jcfg, jp, jnp.asarray(tok), cache=jc,
                                mode=mode, m2=True)
        tl, tc, ta = T.forward(cfg, tp, _t(tok), cache=tc, mode=mode)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for part in ("pattern", "remainder"):
            assert [tuple(a.shape) for a in ta["active_idx"][part]] == \
                [np.asarray(a).shape for a in ja["active_idx"][part]]
        assert [tuple(a.shape) for a in ta["active_idx"]["pattern"]] == \
            [(cfg.num_layers, 0)]
        for k in ("h", "conv"):
            np.testing.assert_allclose(tc["pattern"][0][k].numpy(),
                                       np.asarray(jc["pattern"][0][k]), **TOL)
        assert int(tc["pos"]) == int(jc["pos"])
        jn = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        greedy.append((jn, torch.argmax(tl[:, -1], -1).numpy()))
        out.append(tl)
        tok, mode = jn[:, None], "decode"
    return out, [g[0] for g in greedy], [g[1] for g in greedy]


@pytest.mark.parametrize("S", [16, 33, 96])
def test_forward_prefill_and_decode_match_reference(S):
    """Prompts of half a chunk, a chunk and one token, and three chunks of
    32; then three decode steps."""
    _, _, cfg, _ = model()
    _, theirs, ours = _steps(_prompts(cfg, 70 + S, 2, S), 3)
    np.testing.assert_array_equal(np.stack(ours), np.stack(theirs))


def test_prefill_then_decode_equals_a_longer_prefill():
    """The recurrent form against the chunked one: each decode step's
    logits equal those of one whole-prompt prefill over the prompt and the
    tokens fed so far, at the same position (the state crosses a chunk
    boundary at 32)."""
    _, _, cfg, tp = model()
    tokens = _prompts(cfg, 5, 2, 29)
    logits, theirs, _ = _steps(tokens, 5)
    seq = tokens
    for step in range(1, 6):
        seq = np.concatenate([seq, theirs[step - 1][:, None]], 1)
        c = T.init_cache(cfg, 2, 8, device="cpu")
        whole, _, _ = T.forward(cfg, tp, _t(seq), cache=c, mode="prefill")
        torch.testing.assert_close(logits[step][:, 0], whole[:, -1], **TOL)


def test_runner_tokens_equal_reference():
    jcfg, jp, cfg, tp = model()
    prompts, gen = _prompts(cfg, 32, 2, 10), 4
    jtok, jidx = JaxRunner(jcfg, jp, max_seq=16).generate(prompts, gen)
    runner = RealModelRunner(cfg, tp, max_seq=16, device="cpu")
    ttok, tidx = runner.generate(prompts, gen)
    np.testing.assert_array_equal(ttok, jtok)
    for js, ts in zip(jidx, tidx):
        assert len(ts) == len(js) == cfg.num_layers
        for a, b in zip(js, ts):
            assert a.size == b.size == 0


def test_layer_banks_and_ssd_tier_files_equal_reference(tmp_path):
    """``extract_layer_banks`` gives the reference's ``w_in`` and ``w_out``
    byte for byte; the engines (m2 off: zero surrogates) write the same
    files into their SSD tiers."""
    from repro.core.engine import M2CacheEngine as JaxEngine
    from repro.core.engine_model import extract_layer_banks as jax_extract
    jcfg, jp, cfg, tp = model()
    theirs, ours = jax_extract(jcfg, jp), list(extract_layer_banks(cfg, tp))
    assert len(ours) == len(theirs) == cfg.num_layers
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) == {"w_in", "w_out"}
        for name in a:
            assert a[name].dtype == np.asarray(b[name]).dtype
            assert a[name].tobytes() == np.asarray(b[name]).tobytes()
    JaxEngine(cfg=jcfg, params=jp, ssd_dir=str(tmp_path / "jax"))
    serve.M2CacheEngine(cfg=cfg, params=tp, ssd_dir=str(tmp_path / "torch"),
                        device="cpu")
    files = {d: sorted(p.relative_to(tmp_path / d)
                       for p in (tmp_path / d).rglob("*") if p.is_file())
             for d in ("jax", "torch")}
    assert files["jax"] == files["torch"] and files["jax"]
    for rel in files["jax"]:
        assert (tmp_path / "jax" / rel).read_bytes() == \
            (tmp_path / "torch" / rel).read_bytes()


def test_rows_row_equals_the_row_alone():
    """rows=True: three prompts prefilled together (one past a chunk), then
    decode steps with the rows at their own positions, give each row the
    bits it gets alone."""
    _, _, cfg, tp = model()
    rng = np.random.default_rng(33)
    B, S = 3, 40
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    stack = T.init_cache(cfg, B, 64, device="cpu")
    stack["pos"] = torch.zeros(B, dtype=torch.int64)
    logits, stack, aux = T.forward(cfg, tp, tok, cache=stack, mode="prefill",
                                   rows=True)
    assert tuple(aux["active_idx"]["pattern"][0].shape) == (B, 2, 0)
    caches = []
    for r in range(B):
        c = T.init_cache(cfg, 1, 64, device="cpu")
        lr, c, _ = T.forward(cfg, tp, tok[r:r + 1], cache=c, mode="prefill")
        assert torch.equal(logits[r:r + 1], lr)
        caches.append(c)
    c2 = T.init_cache(cfg, 1, 64, device="cpu")
    T.forward(cfg, tp, torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (1, 7))),
              cache=c2, mode="prefill")
    caches[2] = c2
    stack = _stack_rows(caches)
    for _ in range(2):
        step = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
        logits, stack, _ = T.forward(cfg, tp, step, cache=stack,
                                     mode="decode", rows=True)
        for r, c in enumerate(caches):
            lr, c, _ = T.forward(cfg, tp, step[r:r + 1], cache=c,
                                 mode="decode")
            assert torch.equal(logits[r:r + 1], lr)
            for k in ("h", "conv"):
                assert torch.equal(stack["pattern"][0][k][:, r],
                                   c["pattern"][0][k][:, 0])
    assert stack["pos"].tolist() == [42, 42, 9]


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
    _, _, cfg, tp = model()
    burst = shared_argv(ARCH)
    burst = burst[:burst.index("--rate")] + ["--rate", "1e6", "--turns", "1"]

    def run(argv):
        out, rep, _, _ = server.run(server.parse_args(argv + ["--device",
                                                              "cpu"]),
                                    cfg=cfg, params=tp)
        return out, rep
    out, rep = run(burst)
    serial_out, serial = run(burst + ["--no-batched-decode",
                                      "--prefill-bucket", "1"])
    assert _tokens(serial) == _tokens(rep)
    assert serial_out["summary"]["jit_dispatches_per_step"] > \
        out["summary"]["jit_dispatches_per_step"] == 1.0
    assert out["summary"]["total_tokens"] / out["summary"]["decode_steps"] \
        > 1.5
