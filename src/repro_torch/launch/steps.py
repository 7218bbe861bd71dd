"""Step functions and input specs for every (arch x input shape) on one card
(``repro/launch/steps.py`` without the mesh).

``build_case`` returns the step callable and its inputs as tensors on the
``meta`` device (shapes and dtypes, nothing allocated): the train step
(``lm_loss``, then AdamW) for ``train_4k``, a prefill step for
``prefill_32k`` and a serve step (one token against a ``seq_len`` KV
cache) for the decode shapes. ``long_500k`` gives an attention model
without a window of its own a sliding window of ``LONG_CONTEXT_WINDOW``
positions, whose cache is a ring of that many slots. The reference's
shardings over a TPU mesh have no counterpart here: a case runs on the
one card its inputs lie on.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step

LONG_CONTEXT_WINDOW = 8192


@dataclasses.dataclass
class Case:
    name: str
    fn: Any                      # the step callable
    args: tuple                  # tensors on the meta device
    donate_argnums: tuple        # the args the step writes in place
    meta: dict


def _window_for(cfg, shape: InputShape) -> int:
    """Sliding-window override for long-context decode on quadratic archs."""
    if shape.name == "long_500k" and cfg.num_heads and not cfg.window_size:
        return LONG_CONTEXT_WINDOW
    return 0


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg, shape: InputShape, *, dtype=torch.float32) -> dict:
    """The token (and vlm/audio prefix) inputs as meta tensors: one token a
    row for a decode shape; else ``seq_len`` positions, of which a config
    with prefix embeddings gives up to a quarter to the prefix."""
    B = shape.global_batch
    n_prefix = 0
    if cfg.num_prefix_embeddings and shape.kind != "decode":
        n_prefix = min(cfg.num_prefix_embeddings, shape.seq_len // 4)
    s_tok = 1 if shape.kind == "decode" else shape.seq_len - n_prefix
    if cfg.family == "audio":
        tok_shape = (B, cfg.num_codebooks, s_tok)
    else:
        tok_shape = (B, s_tok)
    out = {"tokens": _meta(tok_shape, torch.int32)}
    if n_prefix:
        out["prefix"] = _meta((B, n_prefix, cfg.d_model), dtype)
    return out


def build_case(arch: str, shape_name: str, *, variant: str = "dense",
               dtype=torch.float32, remat: bool = True,
               kv_quant: bool = False, tiny: bool = False) -> Case:
    """The step of ``arch`` at ``INPUT_SHAPES[shape_name]``: ``variant``
    "m2" serves with the M2Cache FFN where the config has one (training
    always runs the dense FFN); ``kv_quant`` an int8 K/V cache. Only fp32
    runs: the port's kernels take fp32 alone."""
    if dtype != torch.float32:
        raise NotImplementedError(f"dtype {dtype}: the port's kernels are "
                                  "fp32 only")
    cfg = get_config(arch, tiny=tiny)
    shape = INPUT_SHAPES[shape_name]
    m2 = variant == "m2" and cfg.m2_enabled and shape.kind != "train"
    window = _window_for(cfg, shape)
    p_abs = T.abstract_params(cfg, dtype=dtype, m2=m2)
    batch_abs = batch_specs(cfg, shape, dtype=dtype)
    name = f"{arch}|{shape_name}|{variant}"
    meta = {"arch": arch, "shape": shape_name, "variant": variant,
            "kind": shape.kind, "window": window, "kv_quant": kv_quant,
            "chips": 1, "m2": m2}

    if shape.kind == "train":
        train_step = make_train_step(cfg, AdamWConfig(), remat=remat,
                                     window=window)
        return Case(name=name, fn=train_step,
                    args=(p_abs, init_opt_state(p_abs), batch_abs),
                    donate_argnums=(0, 1), meta=meta)

    cache_len, B = shape.seq_len, shape.global_batch
    if shape.kind == "prefill":

        def prefill_step(params, batch):
            cache = T.init_cache(cfg, B, cache_len, window=window,
                                 dtype=dtype, kv_quant=kv_quant,
                                 device=params["embed"].device)
            logits, cache, _ = T.forward(
                cfg, params, batch["tokens"], prefix=batch.get("prefix"),
                cache=cache, mode="prefill", window=window, m2=m2)
            return logits[..., -1, :], cache

        return Case(name=name, fn=prefill_step, args=(p_abs, batch_abs),
                    donate_argnums=(), meta=meta)

    def serve_step(params, cache, batch):
        logits, cache, _ = T.forward(cfg, params, batch["tokens"],
                                     cache=cache, mode="decode",
                                     window=window, m2=m2)
        return logits[..., 0, :], cache

    cache_abs = T.cache_specs(cfg, B, cache_len, window=window, dtype=dtype,
                              kv_quant=kv_quant)
    return Case(name=name, fn=serve_step,
                args=(p_abs, cache_abs, {"tokens": batch_abs["tokens"]}),
                donate_argnums=(1,), meta=meta)


def input_specs(arch: str, shape_name: str, **kw) -> tuple:
    """Meta-tensor stand-ins for every input of this (arch, shape)'s step:
    no device allocation."""
    return build_case(arch, shape_name, **kw).args
