"""The port runs the reference's audio model, musicgen-large, at the model
level: ``forward`` over (B, K, S) codebook tokens (the K codebooks'
embeddings summed, K unembeddings: logits (B, K, S, V)) with conditioning
frames prepended as ``prefix``, LayerNorm, GELU and multi-head attention
(G = 1). At tiny size on the CPU against the reference: the config field
for field; ``embed_tokens`` and ``unembed``; ``forward``'s prefill (with
and without conditioning frames) and decode logits within 1e-4, active sets
exact, also on a copy widened to head dim 64; decode logits equal to a
whole-prompt prefill's where the predictor ties (the reference's zero
init). The reference cannot serve the model (its CLIs draw (B, S) prompts
and its runner's decode broadcasts a (B, K) argmax to (B, K, 1)); the
port's entry points refuse it with that reason."""
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import model_from, reference_cli, tiny_model
from repro.configs.base import get_config as jax_config
from repro.core.engine_model import RealModelRunner as JaxRunner
from repro.models import transformer as JT
from repro_torch.configs.base import SERVED, get_config
from repro_torch.core.engine_model import RealModelRunner
from repro_torch.launch import serve, server
from repro_torch.models import transformer as T

ARCH = "musicgen-large"
TOL = dict(rtol=1e-4, atol=1e-4)

_MODELS = {}


def model(key: str = "tiny"):
    """Built once per key: "tiny" (4 heads of 32, G = 1) and "wide" (the
    tiny config at d = 256 with 4 heads of 64: full width's head dim)."""
    if key not in _MODELS:
        if key == "tiny":
            _MODELS[key] = tiny_model(ARCH)
        else:
            change = dict(d_model=256, head_dim=64, d_ff=512,
                          name=f"{ARCH}-{key}")
            _MODELS[key] = model_from(
                dataclasses.replace(jax_config(ARCH, tiny=True), **change),
                dataclasses.replace(get_config(ARCH, tiny=True), **change))
    return _MODELS[key]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _codes(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, cfg.num_codebooks, S)).astype(np.int32)


def _frames(cfg, seed, B):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)


def test_config_equals_reference_and_is_forward_only():
    for tiny in (False, True):
        ours, theirs = get_config(ARCH, tiny), jax_config(ARCH, tiny)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    full = get_config(ARCH)
    assert ARCH not in SERVED
    assert (full.family, full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim, full.d_ff, full.num_codebooks,
            full.num_prefix_embeddings, full.norm, full.ffn_act) == (
        "audio", 48, 2048, 32, 32, 64, 8192, 4, 64, "layernorm", "gelu")


def test_params_carry_the_codebook_tables():
    """(K, V, d) embeddings and (K, d, V) unembeddings, in the port's own
    init and through the bridge, bytes kept."""
    jcfg, jp, cfg, tp = model()
    K, V, d = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
    own = T.init_params(cfg, seed=0, device="cpu")
    for tree in (own, tp):
        assert tuple(tree["embed"].shape) == (K, V, d)
        assert tuple(tree["unembed"].shape) == (K, d, V)
    for name in ("embed", "unembed"):
        assert tp[name].numpy().tobytes() == np.asarray(jp[name]).tobytes()


def test_embed_and_unembed_match_reference():
    jcfg, jp, cfg, tp = model()
    codes = _codes(cfg, 3, 2, 7)
    x = JT.embed_tokens(jcfg, jp, jnp.asarray(codes))
    ours = T.embed_tokens(cfg, tp, _t(codes))
    assert tuple(ours.shape) == (2, 7, cfg.d_model)
    np.testing.assert_allclose(ours.numpy(), np.asarray(x), rtol=1e-6,
                               atol=1e-6)
    h = np.random.default_rng(4).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    logits = T.unembed(cfg, tp, _t(h))
    assert tuple(logits.shape) == (2, cfg.num_codebooks, 7, cfg.vocab_size)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(JT.unembed(jcfg, jp, jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)


def _steps(key, codes, frames, steps, buf):
    """A prefill of ``codes`` (after ``frames`` where given), then greedy
    decode steps (the reference's tokens, one per codebook, fed to both):
    logits, the K/V cache and the active sets held at every call."""
    jcfg, jp, cfg, tp = model(key)
    B = codes.shape[0]
    jc = JT.init_cache(jcfg, B, buf, dtype=jnp.float32)
    tc = T.init_cache(cfg, B, buf, device="cpu")
    tok, mode, prefix = codes, "prefill", frames
    for _ in range(steps + 1):
        jl, jc, ja = JT.forward(
            jcfg, jp, jnp.asarray(tok), cache=jc, mode=mode, m2=True,
            prefix=None if prefix is None else jnp.asarray(prefix))
        tl, tc, ta = T.forward(cfg, tp, _t(tok), cache=tc, mode=mode,
                               prefix=None if prefix is None else _t(prefix))
        assert tuple(tl.shape) == np.asarray(jl).shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for part in ("pattern", "remainder"):
            for a, b in zip(ta["active_idx"][part], ja["active_idx"][part]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(tc["pattern"][0]["k"].numpy(),
                                   np.asarray(jc["pattern"][0]["k"]), **TOL)
        assert int(tc["pos"]) == int(jc["pos"])
        tok = np.asarray(jnp.argmax(jl[..., -1, :], -1)).astype(
            np.int32)[..., None]                         # (B, K, 1)
        mode, prefix = "decode", None
    return tc


@pytest.mark.parametrize("key,with_frames", [("tiny", False), ("tiny", True),
                                             ("wide", True)])
def test_forward_prefill_and_decode_match_reference(key, with_frames):
    """Prefill of 12 codebook steps (after 8 conditioning frames, where
    given: the cache advances by S + N), then three decode steps."""
    _, _, cfg, _ = model(key)
    frames = _frames(cfg, 6, 2) if with_frames else None
    tc = _steps(key, _codes(cfg, 5, 2, 12), frames, 3, 32)
    assert int(tc["pos"]) == 12 + 3 + (cfg.num_prefix_embeddings
                                       if with_frames else 0)
    assert cfg.num_heads == cfg.num_kv_heads


def test_decode_equals_a_whole_prompt_prefill():
    """With the predictor at the reference's zero init (every active set
    0..k-1 in both paths), each decode step's logits equal those of one
    prefill over the frames, the codes and the codes fed so far."""
    _, _, cfg, tp = model()
    saved = [layer["ffn"]["pred"]["A"] for layer in tp["layers"]]
    for layer in tp["layers"]:
        layer["ffn"]["pred"]["A"] = torch.zeros_like(layer["ffn"]["pred"]["A"])
    try:
        codes, frames = _t(_codes(cfg, 7, 2, 9)), _t(_frames(cfg, 8, 2))
        c = T.init_cache(cfg, 2, 32, device="cpu")
        logits, c, _ = T.forward(cfg, tp, codes, cache=c, mode="prefill",
                                 prefix=frames)
        for _ in range(4):
            nxt = torch.argmax(logits[..., -1, :], -1)[..., None]
            codes = torch.cat([codes, nxt], -1)
            logits, c, _ = T.forward(cfg, tp, nxt, cache=c, mode="decode")
            w = T.init_cache(cfg, 2, 32, device="cpu")
            whole, _, _ = T.forward(cfg, tp, codes, cache=w, mode="prefill",
                                    prefix=frames)
            torch.testing.assert_close(logits[..., 0, :], whole[..., -1, :],
                                       **TOL)
    finally:
        for layer, a in zip(tp["layers"], saved):
            layer["ffn"]["pred"]["A"] = a


def test_entry_points_refuse_audio_as_the_reference_fails():
    """The port's serve, server and runner raise NotImplementedError with
    the reason; the reference's serve and server CLIs and its runner fail
    on the same model (its 2-D prompts, its (B, K) argmax)."""
    jcfg, jp, cfg, tp = model()
    from repro.launch import serve as jax_serve
    argv = ["--arch", ARCH, "--tiny", "--gen-len", "2", "--batch", "2"]
    with pytest.raises(NotImplementedError, match="cannot serve"):
        serve.main(argv + ["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="cannot serve"):
        server.run(server.parse_args(argv[:3] + ["--requests", "2",
                                                 "--device", "cpu"]))
    with pytest.raises(NotImplementedError, match="cannot serve"):
        RealModelRunner(cfg, tp, max_seq=16, device="cpu").generate(
            _codes(cfg, 1, 2, 4), 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "init_params", lambda *a, **k: jp)
        mp.setattr(sys, "argv", ["serve"] + argv)
        mp.setattr(sys, "stdout", io.StringIO())
        with pytest.raises(ValueError, match="inconsistent sizes"):
            jax_serve.main()
    with pytest.raises(ValueError, match="inconsistent sizes"):
        reference_cli(argv[:3] + ["--requests", "2"], jp)
    with pytest.raises(ValueError):
        JaxRunner(jcfg, jp, max_seq=16).generate(_codes(cfg, 1, 2, 4), 2)
