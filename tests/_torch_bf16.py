"""Shared pieces of the bf16 parity tests: a tiny config's reference params
at bf16 (the reference's default ``init_params`` dtype) with a drawn
predictor ``A`` or router, as ``_torch_tiny.model_from`` draws them at
fp32; the run every family makes (a prefill of 2 x 16 tokens, then four
greedy decode steps, ``m2=True``; qwen2.5-14b also two 8-token
``prefill_resume`` chunks); and the reference's run of it in a subprocess
whose XLA keeps every bf16 op at bf16 (``--xla_allow_excess_precision=
false``), read back from an ``.npz`` a family.

XLA's default lets a fusion keep a bf16 op's result in fp32 until the
fusion ends; PyTorch rounds every op. So the default-flag reference
differs from its own eager ops (an attention layer: 16 % of outputs equal,
max |d| 0.36 on qwen2.5-14b tiny, on the CPU) while its eager ops and
the flagged compile agree with the port bit for bit at the layer level.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as jax_config
from repro.models import transformer as JT

#: the families of the bf16 parity, one tiny config each
FAMILIES = ("qwen2.5-14b", "internvl2-1b", "grok-1-314b",
            "llama4-maverick-400b-a17b", "recurrentgemma-2b", "mamba2-370m")
B, S, BUF, PREFIX, DECODES, CHUNK = 2, 16, 32, 4, 4, 8


def reference_params(arch: str):
    """(reference cfg, its bf16 params): ``init_params(PRNGKey(0), bf16,
    m2=True)``, then each pattern position's and remainder layer's
    predictor ``A`` drawn (rng 21 + i, 31 + j) or MoE router (rng 22 + i,
    32 + j), kept at the leaf's own dtype (fp32 for both)."""
    jcfg = jax_config(arch, tiny=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16,
                        m2=True)
    layers = jp["layers"]
    for seed, layer in ([(21 + i, p) for i, p in enumerate(layers["pattern"])]
                        + [(31 + j, p) for j, p in
                           enumerate(layers["remainder"])]):
        ffn = layer.get("ffn", {})
        if "pred" in ffn:
            a = ffn["pred"]["A"]
            ffn["pred"]["A"] = jnp.asarray(
                np.random.default_rng(seed).standard_normal(a.shape)
                .astype(np.float32) / 4.0).astype(a.dtype)
        elif "router" in ffn:
            r = ffn["router"]
            ffn["router"] = jnp.asarray(
                np.random.default_rng(seed + 1).standard_normal(r.shape)
                .astype(np.float32)).astype(r.dtype)
    return jcfg, jp


def inputs(cfg):
    """(prompt tokens (B, S), or (B, K, S) for codebooks; a (B, PREFIX, d)
    fp32 prefix for a vlm config, else None), from rng 0."""
    rng = np.random.default_rng(0)
    shape = ((B, cfg.num_codebooks, S) if cfg.family == "audio" else (B, S))
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    prefix = None
    if cfg.num_prefix_embeddings:
        prefix = rng.standard_normal((B, PREFIX, cfg.d_model)).astype(
            np.float32)
    return tokens, prefix


#: the families whose first layer's GLU the reference also computes (the
#: fused launch's plain version is held to it): silu and gelu
GLU_ARCHS = ("qwen2.5-14b", "recurrentgemma-2b")


def reference_glu(jcfg, jp) -> dict:
    """The first layer's gate and up products and GLU h at bf16, as the
    reference's ``mp_ffn_apply`` computes them for each tier (its weights
    dequantized to bf16, the einsums, the activation, the product), over a
    seeded x (B, S, d) and active set (rng 5): every array as fp32."""
    from repro.core import mp_ffn as JM
    from repro.core.quantize import unpack_int4
    from repro.models.common import activation
    banks = jax.tree.map(lambda a: a[0],
                         jp["layers"]["pattern"][0]["ffn"]["banks"])
    rng = np.random.default_rng(5)
    d, f = banks["wg_fp"].shape
    sizes = JM.tier_sizes(f, jcfg)
    x = jnp.asarray(rng.standard_normal((B, S, d)).astype(np.float32),
                    jnp.bfloat16)
    idx = rng.permutation(f)[:sizes["k"]].astype(np.int32)
    i16, i8 = idx[:sizes["fp16"]], idx[sizes["fp16"]:sizes["fp16"] + sizes["int8"]]
    i4 = idx[sizes["fp16"] + sizes["int8"]:]
    bf = jnp.bfloat16
    out = {"glu_x": np.asarray(x.astype(jnp.float32)), "glu_idx": idx}
    for w in ("wg", "wu"):
        tiers = {"fp": jnp.take(banks[f"{w}_fp"], i16, axis=1).astype(bf),
                 "int8": jnp.take(banks[f"{w}_i8"], i8, axis=1).astype(bf)
                 * banks[f"{w}_i8_s"][i8].astype(bf),
                 "int4": unpack_int4(jnp.take(banks[f"{w}_i4"], i4, axis=1),
                                     0).astype(bf)
                 * banks[f"{w}_i4_s"][i4].astype(bf)}
        for tier, wt in tiers.items():
            out[f"glu_{w}_{tier}"] = jnp.einsum("bsd,dk->bsk", x, wt)
    act = activation(jcfg.ffn_act)
    for tier in ("fp", "int8", "int4"):
        out[f"glu_h_{tier}"] = act(out[f"glu_wg_{tier}"]) * out[f"glu_wu_{tier}"]
    return {k: np.asarray(v.astype(jnp.float32)) if hasattr(v, "astype")
            and k != "glu_idx" else v for k, v in out.items()}


def reference_run(arch: str) -> dict:
    """The reference's logits of every step and its first layer's active
    sets, as numpy (fp32 logits): the prompt (with the vlm prefix at
    bf16), then DECODES greedy steps, each fed the reference's own argmax;
    qwen2.5-14b also a fresh cache filled by two ``prefill_resume``
    chunks of CHUNK tokens."""
    jcfg, jp = reference_params(arch)
    tokens, prefix = inputs(jcfg)
    n_pre = 0 if prefix is None else PREFIX
    out = {}
    cache = JT.init_cache(jcfg, B, BUF + n_pre, dtype=jnp.bfloat16)
    logits, cache, aux = JT.forward(
        jcfg, jp, jnp.asarray(tokens), cache=cache, mode="prefill", m2=True,
        prefix=None if prefix is None else jnp.asarray(prefix, jnp.bfloat16))

    def keep(tag, logits, aux):
        out[f"{tag}_logits"] = np.asarray(logits.astype(jnp.float32))
        idx = aux.get("active_idx", {}).get("pattern") if aux else None
        if idx:
            out[f"{tag}_idx"] = np.asarray(idx[0][0])
    keep("prefill", logits, aux)
    if arch in GLU_ARCHS:
        out.update(reference_glu(jcfg, jp))
    for step in range(DECODES):
        nxt = np.asarray(jnp.argmax(logits[..., -1, :], axis=-1)).astype(
            np.int32)[..., None]
        out[f"decode{step}_tokens"] = nxt
        logits, cache, aux = JT.forward(jcfg, jp, jnp.asarray(nxt),
                                        cache=cache, mode="decode", m2=True)
        keep(f"decode{step}", logits, aux)
    if arch == "qwen2.5-14b":
        cache = JT.init_cache(jcfg, B, BUF, dtype=jnp.bfloat16)
        for c in range(S // CHUNK):
            logits, cache, aux = JT.forward(
                jcfg, jp, jnp.asarray(tokens[:, c * CHUNK:(c + 1) * CHUNK]),
                cache=cache, mode="prefill_resume", m2=True)
            keep(f"chunk{c}", logits, aux)
    return out


def start_reference(out_dir: str) -> subprocess.Popen:
    """The reference's run of every family, in a subprocess whose XLA keeps
    bf16 ops at bf16, each family's arrays written to ``<arch>.npz`` in
    ``out_dir`` as it finishes (``.npz.tmp`` first, then renamed)."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(root, "src"), here]))
    code = ("import os, sys, numpy as np\n"
            "from _torch_bf16 import FAMILIES, reference_run\n"
            "for arch in FAMILIES:\n"
            "    path = os.path.join(sys.argv[1], arch + '.npz')\n"
            "    with open(path + '.tmp', 'wb') as f:\n"
            "        np.savez(f, **reference_run(arch))\n"
            "    os.replace(path + '.tmp', path)\n")
    return subprocess.Popen([sys.executable, "-c", code, out_dir], env=env,
                            cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
