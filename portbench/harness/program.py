"""The system under test, as the benchmark drives it: the port's
``models.transformer.forward`` in its serving modes with the M2Cache FFN
(``m2=True``), the calls ``launch.steps.build_case`` makes for its serve
and prefill steps, over params built as ``init_params`` builds them (the
bank build ``core.quantize.build_neuron_banks`` + ``to_neuron_major``) from
the benchmark's drawn weights.

This module is the only one of the benchmark that imports the port.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import build_neuron_banks, to_neuron_major
from repro_torch.models import transformer as T

from portbench.harness import weights as W


def model_config(cfg: dict) -> ModelConfig:
    """The port's config of a benchmark configuration (``spec.plain``)."""
    m2 = cfg["m2"]
    return ModelConfig(
        name=cfg["name"], family="dense", num_layers=cfg["layers"],
        d_model=cfg["d"], num_heads=cfg["heads"],
        num_kv_heads=cfg["kv_heads"], d_ff=cfg["ffn"],
        vocab_size=cfg["vocab"], head_dim=cfg["head_dim"],
        qkv_bias=cfg["qkv_bias"], ffn_act=cfg["act"],
        rope_theta=cfg["rope_theta"], m2_enabled=True,
        m2_active_ratio=m2["active_ratio"], m2_ratio_fp16=m2["ratio_fp"],
        m2_ratio_int8=m2["ratio_int8"], m2_ratio_int4=m2["ratio_int4"],
        m2_predictor_rank=m2["predictor_rank"])


@torch.no_grad()
def build_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The port's params from the drawn weights, layer by layer."""
    head = W.head_weights(cfg, seed, device, dtype)
    params = {"embed": head["embed"].clone(),
              "unembed": head["unembed"].clone(),
              "final_norm": head["final_norm"].clone(), "layers": []}
    del head
    for l in range(cfg["layers"]):
        w = W.layer_weights(cfg, seed, l, device, dtype)
        layer = {"norm1": w["norm1"].clone(), "norm2": w["norm2"].clone(),
                 "wqkv": w["wqkv"].clone(), "wo": w["wo"].clone(),
                 "ffn": {"banks": to_neuron_major(build_neuron_banks(
                     w["wg"], w["wu"], w["wd"].clone())),
                     "pred": {"A": w["pred_A"].clone(),
                              "B": w["pred_B"].clone()}}}
        if cfg["qkv_bias"]:
            layer["bqkv"] = w["bqkv"].clone()
        params["layers"].append(layer)
        del w, layer
    return params


@torch.no_grad()
def decode_cache(mc: ModelConfig, cfg: dict, traffic: dict, seed: int,
                 device, dtype=torch.bfloat16) -> Dict:
    """The decode cache, every layer's K and V drawn from the seed
    (``weights.kv_history``), the rows at the history's end."""
    cache = T.init_cache(mc, traffic["sessions"], traffic["slots"],
                         dtype=dtype, device=device)
    entry = cache["pattern"][0]
    for l in range(cfg["layers"]):
        for which in ("k", "v"):
            W.kv_history(cfg, traffic, seed, l, which, entry[which][l])
    cache["pos"] = traffic["history"]
    return cache


def layer_kv(cache: Dict, which: str) -> torch.Tensor:
    """The cache's K or V, (layers, B, slots, hkv, D)."""
    return cache["pattern"][0][which]


def active_sets(aux: Dict) -> torch.Tensor:
    """The forward's rank-ordered active sets, (layers, k)."""
    return aux["active_idx"]["pattern"][0]


def decode_step(mc: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor):
    """One serve step (``build_case``'s ``serve_step``): tokens (B, 1) at
    the cache's position; returns the logits (B, V) and each layer's active
    set (layers, k); the cache takes the step's K/V and moves on one
    position."""
    logits, _, aux = T.forward(mc, params, tokens, cache=cache,
                               mode="decode", m2=True)
    return logits[:, 0, :], active_sets(aux)


def prefill(mc: ModelConfig, params: Dict, tokens: torch.Tensor,
            dtype=torch.bfloat16):
    """A whole-prompt prefill (``build_case``'s ``prefill_step``) of tokens
    (1, S) into a fresh cache sized to the prompt; returns the logits of
    the positions the forward computes ((S, V), a view), the cache and
    each layer's active set (layers, k)."""
    cache = T.init_cache(mc, 1, tokens.shape[1], dtype=dtype,
                         device=tokens.device)
    logits, _, aux = T.forward(mc, params, tokens, cache=cache,
                               mode="prefill", m2=True)
    return logits[0], cache, active_sets(aux)
