"""Port parity: the model forward (repro_torch.models.transformer vs
repro.models.transformer) for qwen2.5-14b tiny with the M2Cache FFN,
prefill then decode, with the reference's parameters carried over by
repro_torch.bridge. Logits and caches are held at 1e-4 (fp32 through two
layers, sums in another order); active sets must be exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.core.quantize import to_reference_layout
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)


def _params(random_a: bool):
    jcfg = jax_config("qwen2.5-14b", tiny=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32,
                        m2=True)
    if random_a:
        pred = jp["layers"]["pattern"][0]["ffn"]["pred"]
        A = np.random.default_rng(11).standard_normal(pred["A"].shape)
        pred["A"] = jnp.asarray(A.astype(np.float32) / np.sqrt(A.shape[1]))
    return jcfg, jp


def _cache_np(cache):
    return {n: cache["pattern"][0][n] for n in ("k", "v")}


@pytest.mark.parametrize("random_a", [False, True])
def test_forward_prefill_then_decode_matches_reference(random_a):
    jcfg, jp = _params(random_a)
    cfg = get_config("qwen2.5-14b", tiny=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    B, S, buf = 2, 10, 16
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, S))
    tokens = tokens.astype(np.int32)

    jc = JT.init_cache(jcfg, B, buf, dtype=jnp.float32)
    jl, jc, ja = JT.forward(jcfg, jp, jnp.asarray(tokens), cache=jc,
                            mode="prefill", m2=True)
    tc = T.init_cache(cfg, B, buf, device="cpu")
    tl, tc, ta = T.forward(cfg, tp, torch.from_numpy(tokens), cache=tc,
                           mode="prefill")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n, arr in _cache_np(jc).items():
        np.testing.assert_allclose(_cache_np(tc)[n].numpy(), np.asarray(arr),
                                   **TOL)
    want_idx = np.asarray(ja["active_idx"]["pattern"][0])
    np.testing.assert_array_equal(ta["active_idx"]["pattern"][0].numpy(),
                                  want_idx)
    assert ta["active_idx"]["remainder"] == [] == ja["active_idx"]["remainder"]
    assert want_idx.shape == (cfg.num_layers, 154)
    if not random_a:      # the reference's zero predictor: identity prefix
        np.testing.assert_array_equal(want_idx[0], np.arange(154))
    assert tc["pos"] == int(jc["pos"]) == S

    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        jl, jc, ja = JT.forward(jcfg, jp, jnp.asarray(nxt[:, None]), cache=jc,
                                mode="decode", m2=True)
        tl, tc, ta = T.forward(cfg, tp, torch.from_numpy(nxt[:, None].copy()),
                               cache=tc, mode="decode")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(
            ta["active_idx"]["pattern"][0].numpy(),
            np.asarray(ja["active_idx"]["pattern"][0]))
        for n, arr in _cache_np(jc).items():
            np.testing.assert_allclose(_cache_np(tc)[n].numpy(),
                                       np.asarray(arr), **TOL)
        assert tc["pos"] == int(jc["pos"]) == S + step + 1


def test_bridge_keeps_names_and_bytes():
    jcfg, jp = _params(False)
    cfg = get_config("qwen2.5-14b", tiny=True)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree, cfg, "cpu")
    assert len(tp["layers"]) == cfg.num_layers
    stacked = np_tree["layers"]["pattern"][0]
    for l, layer in enumerate(tp["layers"]):
        assert set(layer) == set(stacked)
        assert set(layer["ffn"]["banks"]) == set(stacked["ffn"]["banks"])
        # gate and up are stored neuron-major: the same bytes, transposed
        banks = to_reference_layout(layer["ffn"]["banks"])
        for name, arr in stacked["ffn"]["banks"].items():
            assert banks[name].numpy().tobytes() == arr[l].tobytes(), name
        assert layer["ffn"]["banks"]["wg_i4"].shape == \
            stacked["ffn"]["banks"]["wg_i4"].shape[:0:-1]
        np.testing.assert_array_equal(layer["wqkv"].numpy(), stacked["wqkv"][l])
    for name in ("embed", "unembed", "final_norm"):
        np.testing.assert_array_equal(tp[name].numpy(), np_tree[name])


def test_init_params_follows_reference_rules_and_shapes():
    cfg = get_config("qwen2.5-14b", tiny=True)
    jcfg = jax_config("qwen2.5-14b", tiny=True)
    tp = T.init_params(cfg, seed=3, device="cpu")
    specs = JT.abstract_params(jcfg, dtype=jnp.float32, m2=True)
    flat_specs = jax.tree_util.tree_flatten_with_path(specs)[0]
    for path, sds in flat_specs:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] == "layers":
            assert keys[1] == "pattern" and keys[2] == 0
            for l in range(cfg.num_layers):
                t = tp["layers"][l]
                for k in keys[3:]:
                    t = t[k]
                    if k == "banks":       # stored neuron-major
                        t = to_reference_layout(t)
                assert tuple(t.shape) == sds.shape[1:], keys
                assert str(t.dtype).split(".")[-1] == str(sds.dtype), keys
        else:
            t = tp[keys[0]]
            assert tuple(t.shape) == sds.shape
    layer = tp["layers"][0]
    assert float(layer["ffn"]["pred"]["A"].abs().max()) == 0.0
    assert float(layer["bqkv"].abs().max()) == 0.0
    assert float(layer["ffn"]["pred"]["B"].abs().max()) > 0.0
    # banks are rebuilt from the fp weights
    from repro_torch.core.quantize import quantize_int8
    # (gate is neuron-major (f, d): its scale reduces over d, axis 1)
    q, s = quantize_int8(layer["ffn"]["banks"]["wg_fp"], 1)
    assert torch.equal(q, layer["ffn"]["banks"]["wg_i8"])
    assert torch.equal(s, layer["ffn"]["banks"]["wg_i8_s"])


@pytest.mark.parametrize("change", [dict(m2_enabled=False),
                                    dict(family="hybrid",
                                         block_pattern=("rglru", "attn"),
                                         m2_enabled=False),
                                    dict(family="moe", num_experts=4,
                                         num_experts_per_tok=2,
                                         m2_enabled=False),
                                    dict(family="hybrid",
                                         block_pattern=("ssm", "attn"),
                                         m2_enabled=False),
                                    dict(family="hybrid",
                                         block_pattern=("conv", "attn")),
                                    dict(family="audio", num_codebooks=4,
                                         m2_enabled=False)])
def test_unported_configs_raise(change):
    """Unknown layer kinds raise wherever a model is built. Every other
    config raises on what stays unported, the ``window=`` override in the
    server's ``rows`` (no path of the reference runs it there), and runs
    it elsewhere; its dense FFN (``m2_enabled`` False,
    ``init_params(m2=False)``) is ported with train mode and runs (SSD
    layers and the audio family too: tests/test_torch_ssm.py,
    tests/test_torch_audio.py)."""
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2.5-14b", tiny=True), **change)
    if "conv" in cfg.block_pattern:
        with pytest.raises(NotImplementedError):
            T.init_cache(cfg, 1, 8, device="cpu")
        with pytest.raises(NotImplementedError):
            T.init_params(cfg, device="cpu")
        return
    params = T.init_params(cfg, device="cpu", m2=False)
    shape = (1, cfg.num_codebooks, 4) if cfg.num_codebooks else (1, 4)
    tokens = torch.zeros(shape, dtype=torch.int64)
    logits, _, _ = T.forward(cfg, params, tokens)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(NotImplementedError, match="window"):
        T.forward(cfg, params, tokens, window=8, rows=True)
    logits, _, _ = T.forward(cfg, params, tokens, window=8)
    assert bool(torch.isfinite(logits).all())
