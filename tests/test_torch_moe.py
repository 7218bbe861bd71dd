"""The port serves the reference's MoE family: grok-1-314b (8 experts, top-2,
gelu, the attention logit softcap 30) and llama4-maverick-400b-a17b (128
experts, top-1, a shared expert), each at tiny size on the CPU against the
reference.

``moe_ffn`` against the reference's at (E, k) = (4, 2), (8, 2), (4, 1) with
a shared expert and (128, 1), at capacity factors 1.25 (drops) and 4.0
(none), with a zero router (every token ties) and a drawn one: each
token's experts, each choice's position and the keep mask exactly, as the
reference's own lines compute them; y within 1e-5; the load-balance loss
and the dropped fraction within 1e-6. End to end, for both configs: the
config field for field; prefill, ``prefill_resume`` and decode logits
within 1e-4 and greedy tokens exactly (also at capacity factor 1.25, where
tokens drop); the runner, ``launch/serve`` and ``launch/server`` (summary,
``kv``, ``cache``, ``prefix``, ``carbon_g``) equal to the reference's; the
SSD bank files byte for byte. Inside the port, bit for bit: a ``rows=True``
row equals the row alone, scheduler chunking and batched decode change no
bit. The plain versions of the three attention kernels take the softcap
as the reference's ``_attend`` does."""
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
from repro.models import common as JC
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs.base import SERVED, get_config
from repro_torch.core.engine_model import (RealModelRunner, _stack_rows,
                                           extract_layer_banks)
from repro_torch.core.predictor import top_k
from repro_torch.kernels import ref as R
from repro_torch.launch import serve, server
from repro_torch.models import common as C
from repro_torch.models import moe
from repro_torch.models import transformer as T

ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]
TOL = dict(rtol=1e-4, atol=1e-4)
OUT_KEYS = ("summary", "kv", "cache", "prefix", "persist", "carbon_g")

_MODELS = {}


def model(arch, zero_router=False):
    """tiny_model(arch), built once per (arch, router) for the module."""
    key = (arch, zero_router)
    if key not in _MODELS:
        _MODELS[key] = tiny_model(arch, zero_router=zero_router)
    return _MODELS[key]


def _prompts(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# moe_ffn


def _reference_routing(x, router_w, E, k, cf):
    """The reference's routing, by its own lines (moe.py:44-60): experts,
    positions, keep and C."""
    B, S, _ = x.shape
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                        router_w.astype(jnp.float32))
    if k == 1:
        _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 1)
    else:
        _, expert_idx = jax.lax.top_k(logits, k)
    C = max(int(S * k / E * cf), 1)
    flat_e = expert_idx.reshape(B, S * k)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos_excl = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.take_along_axis(pos_excl, flat_e[..., None], axis=2)[..., 0]
    return (np.asarray(expert_idx), np.asarray(pos), np.asarray(pos < C), C)


def _moe_inputs(seed, B, S, d, f, E, shared, zero_router):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    router = (np.zeros((d, E), np.float32) if zero_router
              else rng.standard_normal((d, E)).astype(np.float32))
    w = [(rng.standard_normal(s) * sc).astype(np.float32)
         for s, sc in (((E, d, f), 0.25), ((E, d, f), 0.25), ((E, f, d), 0.2))]
    sh = None
    if shared:
        sh = tuple((rng.standard_normal(s) * 0.25).astype(np.float32)
                   for s in ((d, f), (d, f), (f, d)))
    return x, router, w, sh


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("E,k,shared", [(4, 2, False), (8, 2, False),
                                        (4, 1, True), (128, 1, False)])
def test_moe_ffn_matches_reference(E, k, shared, cf, zero_router):
    B, S, d, f = 2, 24, 32, 16
    act = "gelu" if k == 2 else "silu"
    x, router, w, sh = _moe_inputs(E * 10 + k, B, S, d, f, E, shared,
                                   zero_router)
    jy, ja = JM.moe_ffn(jnp.asarray(x), jnp.asarray(router),
                        *map(jnp.asarray, w), num_experts_per_tok=k,
                        capacity_factor=cf, act_name=act,
                        shared=None if sh is None else
                        tuple(map(jnp.asarray, sh)))
    tx, tr = torch.from_numpy(x), torch.from_numpy(router)
    ty, ta = moe.moe_ffn(tx, tr, *map(torch.from_numpy, w),
                         num_experts_per_tok=k, capacity_factor=cf,
                         act_name=act, shared=None if sh is None else
                         tuple(map(torch.from_numpy, sh)))
    e_want, pos_want, keep_want, C = _reference_routing(
        jnp.asarray(x), jnp.asarray(router), E, k, cf)
    _, _, experts, pos, keep, C_got = moe.route(tx, tr, E=E, k=k,
                                                capacity_factor=cf)
    assert C_got == C == moe.capacity(S, k, E, cf)
    np.testing.assert_array_equal(experts.numpy(), e_want)
    np.testing.assert_array_equal(pos.numpy(), pos_want)
    np.testing.assert_array_equal(keep.numpy(), keep_want)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for name in ("lb_loss", "dropped_frac"):
        np.testing.assert_allclose(float(ta[name]), float(ja[name]),
                                   rtol=1e-6, atol=1e-6)
    dropped = float(ta["dropped_frac"])
    if cf == 4.0 and not zero_router:
        assert dropped == 0.0 or k * cf < E
    if zero_router:                   # ties: experts 0..k-1 by lowest index
        assert (experts.numpy() == np.arange(k)).all()
    if cf == 1.25 and (zero_router or E >= 8):
        assert dropped > 0


@pytest.mark.parametrize("k", [1, 2, 5])
def test_top_k_orders_as_jax_lax_top_k(k):
    """Descending, ties by the lowest index, +0.0 above -0.0, NaNs by sign,
    on every row of a 3-D input."""
    rng = np.random.default_rng(k)
    x = rng.integers(-2, 3, (3, 4, 9)).astype(np.float32)
    x[0, 0, :4] = [0.0, -0.0, np.nan, -np.nan]
    x[1, 2] = -0.0
    x[2, 1, 3] = np.inf
    v, i = top_k(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert v.numpy().tobytes() == np.asarray(jv).tobytes()


def test_capacity_equals_reference_formula():
    for S in (1, 16, 128, 4096):
        for k, E in ((2, 8), (1, 128), (2, 4), (1, 4)):
            for cf in (1.25, 4.0):
                assert moe.capacity(S, k, E, cf) == max(int(S * k / E * cf), 1)
    assert moe.capacity(128, 2, 8, 1.25) == 40      # grok's serve prefill
    assert moe.capacity(16, 2, 8, 1.25) == 5        # grok's server chunk
    assert moe.capacity(1, 2, 8, 1.25) == 1         # a decode step


def test_glu_ffn_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = [(rng.standard_normal(s) / 4).astype(np.float32)
         for s in ((32, 24), (32, 24), (24, 32))]
    for act in ("silu", "gelu", "relu"):
        np.testing.assert_allclose(
            C.glu_ffn(torch.from_numpy(x), *map(torch.from_numpy, w),
                      act).numpy(),
            np.asarray(JC.glu_ffn(jnp.asarray(x), *map(jnp.asarray, w), act)),
            rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the softcap in the three attention kernels' plain versions


def _large(rng, *shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_softcap_flash_attention_ref_matches_reference_attend():
    rng = np.random.default_rng(40)
    B, S, Hq, Hkv, D = 2, 19, 6, 2, 32
    q, k, v = (_large(rng, B, S, h, D, scale=s) for h, s in
               ((Hq, 3.0), (Hkv, 3.0), (Hkv, 1.0)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = JC._attend(*map(jnp.asarray, (q, k, v, pos, pos)), softcap=30.0)
    got = R.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    uncapped = R.flash_attention_ref(*map(torch.from_numpy, (q, k, v)))
    assert float((got - uncapped).abs().max()) > 1e-2     # the cap bites


def test_softcap_chunk_attention_ref_matches_reference_attend():
    rng = np.random.default_rng(41)
    B, S, Skv, Hq, Hkv, D = 2, 8, 40, 6, 2, 32
    q = _large(rng, B, S, Hq, D, scale=3.0)
    k = _large(rng, B, Skv, Hkv, D, scale=3.0)
    v = _large(rng, B, Skv, Hkv, D, scale=1.0)
    k[0, 20:] = np.nan                         # above row 0's front
    pos0 = np.array([3, 30], np.int32)
    q_pos = pos0[:, None] + np.arange(S, dtype=np.int32)[None]
    kv_pos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv))
    k_ok = np.where(np.isnan(k), 0.0, k).astype(np.float32)
    want = JC._attend(*map(jnp.asarray, (q, k_ok, v, q_pos, kv_pos)),
                      softcap=30.0)
    got = R.chunk_attention_ref(*map(torch.from_numpy, (q, k_ok, v, pos0)),
                                softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_softcap_flash_decode_ref_matches_reference_attend():
    """The cap goes on the scaled score before the mask: a masked slot
    stays at -1e30 (a row with no valid slot averages V over every slot)."""
    rng = np.random.default_rng(42)
    B, S, Hkv, G, D = 3, 37, 2, 3, 32
    q = _large(rng, B, Hkv, G, D, scale=3.0)
    k = _large(rng, B, S, Hkv, D, scale=3.0)
    v = _large(rng, B, S, Hkv, D, scale=1.0)
    slots = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    slots[1, 4:9] = -1
    slots[2] = -1
    lengths = np.array([36, 20, 10], np.int32)
    valid = (slots >= 0) & (slots <= lengths[:, None])
    want = JC._attend(jnp.asarray(q.reshape(B, 1, Hkv * G, D)),
                      *map(jnp.asarray, (k, v, lengths[:, None], slots)),
                      softcap=30.0, kv_valid=jnp.asarray(valid))
    got = R.flash_decode_ref(*map(torch.from_numpy, (q, k, v, slots,
                                                     lengths)), softcap=30.0)
    np.testing.assert_allclose(got.numpy().reshape(B, 1, Hkv * G, D),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(),
                               np.broadcast_to(v[2].mean(0)[:, None],
                                               (Hkv, G, D)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the configs end to end


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    for tiny in (False, True):
        ours, theirs = get_config(arch, tiny), jax_config(arch, tiny)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    from repro.core.kv_payload import supports_payloads as jax_gate
    from repro_torch.core.kv_payload import supports_payloads
    for tiny in (False, True):
        assert supports_payloads(get_config(arch, tiny)) is \
            jax_gate(jax_config(arch, tiny)) is True
    assert arch in SERVED
    full = get_config(arch)
    assert full.family == "moe" and full.m2_enabled
    assert (full.num_experts, full.num_experts_per_tok,
            full.logit_softcap) == {"grok-1-314b": (8, 2, 30.0),
                                    "llama4-maverick-400b-a17b": (128, 1,
                                                                  0.0)}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_init_carry_moe_leaves(arch):
    """The reference's tree comes over leaf for leaf, bytes kept, no banks;
    the port's own init builds the same leaves and shapes, its router, and
    the unread predictor leaves, at zero as the reference's init does."""
    jcfg, jp, cfg, tp = model(arch, zero_router=True)
    stacked = jp["layers"]["pattern"][0]
    own = T.init_params(cfg, seed=0, device="cpu")
    for i, (layer, mine) in enumerate(zip(tp["layers"], own["layers"])):
        assert set(layer) == set(stacked) == set(mine)
        assert set(layer["ffn"]) == set(stacked["ffn"]) == set(mine["ffn"])
        assert "banks" not in layer["ffn"]
        for name, t in layer["ffn"].items():
            assert t.numpy().tobytes() == np.asarray(
                stacked["ffn"][name][i]).tobytes()
            assert mine["ffn"][name].shape == t.shape
        for name in ("router", "pred_A", "pred_B"):
            assert float(mine["ffn"][name].abs().max()) == 0.0
        assert float(mine["ffn"]["wg"].abs().max()) > 0.0
    assert ("shared_wg" in tp["layers"][0]["ffn"]) is \
        bool(cfg.shared_expert_d_ff)


def _prefill_resume_decode(jcfg, jp, cfg, tp, tokens, split, steps=3):
    """prefill of tokens[:, :split], prefill_resume of the rest, then greedy
    decode steps, in both packages: logits, caches, the load-balance loss
    and the (empty) active sets held at every call; returns the greedy
    tokens of each package."""
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
        np.testing.assert_allclose(float(ta["lb_loss"]), float(ja["lb_loss"]),
                                   rtol=1e-5, atol=1e-5)
        idx = ta["active_idx"]["pattern"][0]
        assert tuple(idx.shape) == np.asarray(
            ja["active_idx"]["pattern"][0]).shape == (cfg.num_layers, 0)
        for n in ("k", "v"):
            np.testing.assert_allclose(tc["pattern"][0][n].numpy(),
                                       np.asarray(jc["pattern"][0][n]), **TOL)
        assert int(tc["pos"]) == int(jc["pos"])
        greedy.append((np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32),
                       torch.argmax(tl[:, -1], -1).numpy().astype(np.int32)))
    return [g[0] for g in greedy], [g[1] for g in greedy]


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_resume_and_decode_match_reference(arch, zero_router):
    jcfg, jp, cfg, tp = model(arch, zero_router)
    theirs, ours = _prefill_resume_decode(jcfg, jp, cfg, tp,
                                          _prompts(cfg, 31, 2, 12), 8)
    np.testing.assert_array_equal(np.stack(ours), np.stack(theirs))


@pytest.mark.parametrize("arch", ARCHS)
def test_dropping_capacity_matches_reference(arch, monkeypatch):
    """The full configs' capacity factor 1.25 on the tiny widths, with a
    drawn router: tokens drop at prefill, and the port drops the same
    ones (logits within 1e-4, greedy tokens exactly)."""
    jcfg, jp, cfg, tp = model(arch)
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=1.25)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    dropped, real = [], moe.moe_ffn

    def counted(*a, **kw):
        y, aux = real(*a, **kw)
        dropped.append(float(aux["dropped_frac"]))
        return y, aux
    monkeypatch.setattr(moe, "moe_ffn", counted)
    theirs, ours = _prefill_resume_decode(jcfg, jp, cfg, tp,
                                          _prompts(cfg, 37, 2, 24), 16)
    np.testing.assert_array_equal(np.stack(ours), np.stack(theirs))
    assert max(dropped[:cfg.num_layers]) > 0        # at the prefill


@pytest.mark.parametrize("arch", ARCHS)
def test_runner_tokens_and_empty_active_sets_equal_reference(arch):
    jcfg, jp, cfg, tp = model(arch)
    prompts, gen = _prompts(cfg, 32, 2, 10), 4
    jtok, jidx = JaxRunner(jcfg, jp, max_seq=16).generate(prompts, gen)
    runner = RealModelRunner(cfg, tp, max_seq=16, device="cpu")
    ttok, tidx = runner.generate(prompts, gen)
    np.testing.assert_array_equal(ttok, jtok)
    for js, ts in zip(jidx, tidx):
        assert len(ts) == len(js) == cfg.num_layers
        for a, b in zip(js, ts):
            assert np.asarray(a).size == np.asarray(b).size == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_bank_files_equal_reference(arch):
    """The SSD tier streams an MoE layer's raw expert weights, byte for
    byte the reference's files (no shared expert)."""
    from repro.core.engine_model import extract_layer_banks as jax_extract
    jcfg, jp, cfg, tp = model(arch)
    theirs = jax_extract(jcfg, jp)
    ours = list(extract_layer_banks(cfg, tp))
    assert len(ours) == len(theirs) == cfg.num_layers
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) == {"wg", "wu", "wd"}
        for name in a:
            assert a[name].dtype == np.asarray(b[name]).dtype
            assert a[name].tobytes() == np.asarray(b[name]).tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_row_equals_the_row_alone(arch):
    """rows=True, each row at its own position: a chunk and then a decode
    step give each row the bits it gets alone; capacity is the row's own."""
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
        assert tuple(aux["active_idx"]["pattern"][0].shape) == (
            3, cfg.num_layers, 0)
        for r, c in enumerate(caches):
            lr, c, ar = T.forward(cfg, tp, tok[r:r + 1], cache=c, mode=mode)
            assert torch.equal(logits[r:r + 1], lr)
            assert torch.equal(aux["lb_loss"][r], ar["lb_loss"])
    assert stack["pos"].tolist() == [9, 17, 25]


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_equals_reference(arch, zero_router, monkeypatch, capsys):
    """launch/serve on the CPU prints the reference's modeled summary and
    generates its tokens, from the same weights and prompts."""
    from repro.core.engine import M2CacheEngine as JaxEngine
    from repro.launch import serve as jax_serve
    _, jp, cfg, tp = model(arch, zero_router)
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
    assert set(ours) == set(theirs)
    for key in ("tokens_per_s_modeled", "modeled_s", "cache", "carbon_g"):
        assert ours[key] == theirs[key], key
    np.testing.assert_array_equal(results[1].tokens, results[0].tokens)
    assert results[0].tokens.shape == (2, 4)
    assert ours["cache"]["hbm_bytes_loaded"] == 0.0    # no active neurons


@pytest.fixture(scope="module")
def server_runs():
    """Per arch: the reference's server CLI and the port's on SHARED's
    traffic, from the same weights (a drawn router)."""
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
