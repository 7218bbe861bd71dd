"""The port serves every dense-attention model the reference names:
qwen2.5-32b (G = 5), command-r-35b (parallel attention+FFN block,
layernorm, tied embeddings, G = 4 tiny / 8 full), mistral-large-123b (G = 12
full) and internvl2-1b (family ``vlm``, head dim 64 full, a patch-embedding
prefix), each at tiny size on the CPU against the reference: the config
field for field; prefill, ``prefill_resume`` and decode logits within 1e-4
(fp32 through two layers, sums in another order); active sets, greedy
tokens, the modeled clock and the server's summary exactly. Invariants
inside the port, bit for bit: a ``rows=True`` row equals the same row
alone, scheduler chunking changes no bit, batched decode equals
per-session decode. The tiny configs have G <= 4 and D = 32, so widened
copies (G = 12 and 7 at D = 64) run the plain path against the reference
too."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import as_json, reference_cli, shared_argv, tiny_model
from _torch_tiny import tokens as _tokens
from repro.configs.base import get_config as jax_config
from repro.core.engine_model import RealModelRunner as JaxRunner
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.core.engine_model import RealModelRunner, _stack_rows
from repro_torch.launch import serve, server
from repro_torch.models import transformer as T

ARCHS = ["qwen2.5-32b", "command-r-35b", "mistral-large-123b",
         "internvl2-1b"]
TOL = dict(rtol=1e-4, atol=1e-4)
OUT_KEYS = ("summary", "kv", "cache", "prefix", "persist", "carbon_g")

_MODELS = {}


def model(arch):
    """tiny_model(arch), built once per arch for the module."""
    if arch not in _MODELS:
        _MODELS[arch] = tiny_model(arch)
    return _MODELS[arch]


def _idx(aux):
    return aux["active_idx"]["pattern"][0]


def _prompts(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    for tiny in (False, True):
        ours, theirs = get_config(arch, tiny), jax_config(arch, tiny)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    full = get_config(arch)
    assert full.m2_enabled and not full.num_experts and not full.window_size
    assert (full.num_heads // full.num_kv_heads, full.head_dim) == {
        "qwen2.5-32b": (5, 128), "command-r-35b": (8, 128),
        "mistral-large-123b": (12, 128), "internvl2-1b": (7, 64)}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_payload_gate_and_served_list_agree_with_reference(arch):
    """internvl2-1b is family vlm, and both packages' real KV residency
    admits it, as every dense config."""
    from repro.core.kv_payload import supports_payloads as jax_gate
    from repro_torch.configs.base import SERVED
    from repro_torch.core.kv_payload import supports_payloads
    for tiny in (False, True):
        assert supports_payloads(get_config(arch, tiny)) is \
            jax_gate(jax_config(arch, tiny)) is True
    assert arch in SERVED


def test_unported_arch_error_lists_what_is_served():
    """Every config of the reference is ported: a name that is none of
    them raises KeyError (as the reference's lookup does), listing them."""
    with pytest.raises(KeyError) as err:
        get_config("llama-7b")
    for arch in ["qwen2.5-14b", "mamba2-370m", "musicgen-large"] + ARCHS:
        assert repr(arch) in str(err.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_init_carry_each_archs_leaves(arch):
    """The reference's tree comes over leaf for leaf, bytes kept (banks
    neuron-major); the port's own init builds the same leaves and shapes:
    no norm2 in command-r-35b's parallel block, no unembed for its tied
    table."""
    from repro_torch.core.quantize import to_reference_layout
    jcfg, jp, cfg, tp = model(arch)
    stacked = jp["layers"]["pattern"][0]
    own = T.init_params(cfg, seed=0, device="cpu")
    for layer, mine in zip(tp["layers"], own["layers"]):
        assert set(layer) == set(stacked) == set(mine)
        assert ("norm2" in layer) is (not cfg.parallel_block)
        for name, t in mine["ffn"]["banks"].items():
            assert t.shape == layer["ffn"]["banks"][name].shape
    banks = to_reference_layout(tp["layers"][1]["ffn"]["banks"])
    for name, arr in stacked["ffn"]["banks"].items():
        assert banks[name].numpy().tobytes() == np.asarray(arr[1]).tobytes()
    assert set(tp) == set(own) == set(jp) - {"layers"} | {"layers"}
    assert ("unembed" in tp) is (not cfg.tie_embeddings)


def _prefill_resume_decode(jcfg, jp, cfg, tp, tokens, split, steps=3):
    """prefill of tokens[:, :split], prefill_resume of the rest, then greedy
    decode steps, in both packages: logits, caches and active sets held at
    every call; returns the greedy tokens of each package."""
    B, S = tokens.shape
    buf = S + steps + 1
    jc = JT.init_cache(jcfg, B, buf, dtype=jnp.float32)
    tc = T.init_cache(cfg, B, buf, device="cpu")
    calls = [("prefill", tokens[:, :split]),
             ("prefill_resume", tokens[:, split:])]
    greedy = []
    for i in range(2 + steps):
        mode, tok = calls[i] if i < 2 else ("decode", greedy[-1][0][:, None])
        jl, jc, ja = JT.forward(jcfg, jp, jnp.asarray(tok), cache=jc,
                                mode=mode, m2=True)
        tl, tc, ta = T.forward(cfg, tp, torch.from_numpy(tok.copy()),
                               cache=tc, mode=mode)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(_idx(ta).numpy(),
                                      np.asarray(_idx(ja)))
        for n in ("k", "v"):
            np.testing.assert_allclose(tc["pattern"][0][n].numpy(),
                                       np.asarray(jc["pattern"][0][n]), **TOL)
        assert int(tc["pos"]) == int(jc["pos"])
        greedy.append((np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32),
                       torch.argmax(tl[:, -1], -1).numpy().astype(np.int32)))
    return [g[0] for g in greedy], [g[1] for g in greedy]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_resume_and_decode_match_reference(arch):
    jcfg, jp, cfg, tp = model(arch)
    theirs, ours = _prefill_resume_decode(jcfg, jp, cfg, tp,
                                          _prompts(cfg, 31, 2, 12), 8)
    np.testing.assert_array_equal(np.stack(ours), np.stack(theirs))


@pytest.mark.parametrize("arch", ARCHS)
def test_runner_tokens_and_active_sets_equal_reference(arch):
    jcfg, jp, cfg, tp = model(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_row_equals_the_row_alone(arch):
    """rows=True, each row at its own position with its own active sets: a
    chunk and then a decode step give each row the bits it gets alone."""
    _, _, cfg, tp = model(arch)
    rng = np.random.default_rng(33)
    caches = []
    for p in (0, 8, 16):
        c = T.init_cache(cfg, 1, 32, device="cpu")
        if p:
            T.forward(cfg, tp, torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (1, p))), cache=c,
                mode="prefill")
        caches.append(c)
    stack = _stack_rows(caches)
    for mode, S in (("prefill_resume", 8), ("decode", 1)):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, S)))
        logits, stack, aux = T.forward(cfg, tp, tok, cache=stack, mode=mode,
                                       rows=True)
        for r, c in enumerate(caches):
            lr, c, ar = T.forward(cfg, tp, tok[r:r + 1], cache=c, mode=mode)
            assert torch.equal(logits[r:r + 1], lr)
            assert torch.equal(_idx(aux)[r], _idx(ar))
    assert stack["pos"].tolist() == [9, 17, 25]


def test_internvl2_prefix_matches_reference():
    """forward(prefix=...): the patch embeddings fill the cache's first N
    slots and get no logits, in prefill and prefill_resume; a decode step
    after them; as the reference's forward."""
    jcfg, jp, cfg, tp = model("internvl2-1b")
    assert cfg.family == "vlm" and cfg.num_prefix_embeddings == 16
    rng = np.random.default_rng(34)
    B, N, S = 2, cfg.num_prefix_embeddings, 6
    prefix = (rng.standard_normal((B, N, cfg.d_model)) / 4).astype(np.float32)
    tokens = _prompts(cfg, 35, B, S)
    for mode in ("prefill", "prefill_resume"):
        jc = JT.init_cache(jcfg, B, N + S + 2, dtype=jnp.float32)
        tc = T.init_cache(cfg, B, N + S + 2, device="cpu")
        jl, jc, ja = JT.forward(jcfg, jp, jnp.asarray(tokens),
                                prefix=jnp.asarray(prefix), cache=jc,
                                mode=mode, m2=True)
        tl, tc, ta = T.forward(cfg, tp, torch.from_numpy(tokens),
                               prefix=torch.from_numpy(prefix), cache=tc,
                               mode=mode)
        assert tl.shape == (B, S, cfg.vocab_size) == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(_idx(ta).numpy(), np.asarray(_idx(ja)))
        assert int(tc["pos"]) == int(jc["pos"]) == N + S
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jc, ja = JT.forward(jcfg, jp, jnp.asarray(nxt),
                                prefix=jnp.asarray(prefix), cache=jc,
                                mode="decode", m2=True)
        tl, tc, ta = T.forward(cfg, tp, torch.from_numpy(nxt),
                               prefix=torch.from_numpy(prefix), cache=tc,
                               mode="decode")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(_idx(ta).numpy(), np.asarray(_idx(ja)))
        for n in ("k", "v"):
            np.testing.assert_allclose(tc["pattern"][0][n].numpy(),
                                       np.asarray(jc["pattern"][0][n]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_equals_reference(arch, monkeypatch, capsys):
    """launch/serve on the CPU prints the reference's modeled summary and
    generates its tokens, from the same weights and prompts."""
    from repro.core.engine import M2CacheEngine as JaxEngine
    from repro.launch import serve as jax_serve
    _, jp, cfg, tp = model(arch)
    argv = ["--arch", arch, "--tiny", "--batch", "2", "--prompt-len", "9",
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
def server_runs():
    """Per arch: the reference's server CLI and the port's on SHARED's
    traffic, from the same weights."""
    out = {}

    def get(arch):
        if arch not in out:
            _, jp, cfg, tp = model(arch)
            theirs, (jrep,) = reference_cli(shared_argv(arch), jp)
            ours, rep, eng, _ = server.run(server.parse_args(
                shared_argv(arch) + ["--device", "cpu"]), cfg=cfg, params=tp)
            out[arch] = (theirs, jrep, as_json(ours), rep, eng)
        return out[arch]
    return get


def _last(sess):
    if sess._batch is not None:
        return sess._batch.last[sess._row]
    return sess.last[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_server_cli_equals_reference(server_runs, arch):
    theirs, jrep, ours, rep, eng = server_runs(arch)
    assert set(ours) == set(theirs) == set(OUT_KEYS)
    for key in OUT_KEYS:
        assert ours[key] == theirs[key], key
    assert _tokens(rep) == _tokens(jrep)
    assert ours["summary"]["prefix_hit_tokens"] > 0
    assert eng.prefix_restored_tokens > 0
    for a, b in zip(sorted(rep.requests, key=lambda r: r.rid),
                    sorted(jrep.requests, key=lambda r: r.rid)):
        np.testing.assert_allclose(_last(a.session).numpy(),
                                   np.asarray(_last(b.session)), **TOL)


def _port_server(arch, argv):
    _, _, cfg, tp = model(arch)
    out, rep, _, _ = server.run(server.parse_args(argv + ["--device", "cpu"]),
                                cfg=cfg, params=tp)
    return out, rep


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_chunking_changes_no_bit(server_runs, arch):
    """Prompts prefilled 8 tokens a scheduler step (SHARED) and whole in
    one step: the same tokens, and the same last logits bit for bit."""
    _, _, _, rep, _ = server_runs(arch)
    argv = shared_argv(arch)
    argv[argv.index("--prefill-chunk") + 1] = "4096"
    _, whole = _port_server(arch, argv)
    assert _tokens(whole) == _tokens(rep)
    for a, b in zip(sorted(rep.requests, key=lambda r: r.rid),
                    sorted(whole.requests, key=lambda r: r.rid)):
        assert torch.equal(_last(a.session), _last(b.session))


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_decode_equals_per_session(arch):
    burst = shared_argv(arch)
    burst = burst[:burst.index("--rate")] + ["--rate", "1e6", "--turns", "1"]
    out, rep = _port_server(arch, burst)
    serial_out, serial = _port_server(arch, burst + ["--no-batched-decode",
                                                     "--prefill-bucket", "1"])
    assert _tokens(serial) == _tokens(rep)
    assert serial_out["summary"]["jit_dispatches_per_step"] > \
        out["summary"]["jit_dispatches_per_step"] == 1.0


@pytest.mark.parametrize("G,D", [(12, 64), (7, 64)])
def test_widened_config_matches_reference(G, D):
    """mistral-large-123b's G = 12 and internvl2-1b's G = 7, at head dim 64,
    on a tiny config widened with dataclasses.replace: the plain path's
    prefill, prefill_resume and decode against the reference's."""
    changes = dict(num_heads=2 * G, num_kv_heads=2, head_dim=D,
                   name=f"widened-g{G}-d{D}")
    jcfg = dataclasses.replace(jax_config("mistral-large-123b", tiny=True),
                               **changes)
    cfg = dataclasses.replace(get_config("mistral-large-123b", tiny=True),
                              **changes)
    jp = JT.init_params(jax.random.PRNGKey(G), jcfg, dtype=jnp.float32,
                        m2=True)
    pred = jp["layers"]["pattern"][0]["ffn"]["pred"]
    pred["A"] = jnp.asarray(np.random.default_rng(G).standard_normal(
        pred["A"].shape).astype(np.float32) / 4.0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert tp["layers"][0]["wqkv"].shape == (256, (2 * G + 4) * D)
    theirs, ours = _prefill_resume_decode(jcfg, jp, cfg, tp,
                                          _prompts(cfg, 36, 2, 12), 8)
    np.testing.assert_array_equal(np.stack(ours), np.stack(theirs))
