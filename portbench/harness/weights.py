"""The seeded inputs of a run: the model's weights and a decode cell's K/V
history, drawn on the device in the dtype they are served in.

Each layer is drawn by a generator of its own, seeded from (seed, what,
layer), in two calls: one for its matrices in the served dtype and one
for its float32 vectors and predictor. So the program's set-up and the
reference, after the program's state is freed, draw any layer alike and
alone.

Scales: a product's weights N(0, 1/fan_in), fan_in the contraction's
width; v's columns of wqkv times ``v_gain`` (so that attention, which
averages many values of random weights, adds to the residual about as
much as the FFN does); the embedding N(0, 1); norm weights, biases N(0,
0.1^2) (a norm scales by 1 + w); the predictor's A N(0, 1/d) and B N(0,
1/rank), both drawn (an undrawn A makes every set 0..k-1).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

VECTOR_STD = 0.1
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def served_dtype(cfg: dict) -> torch.dtype:
    """The dtype a configuration's weights and cache are served in."""
    return DTYPES[cfg["dtype"]]


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for one draw, from the run's seed and the draw's
    names."""
    digest = hashlib.sha256(repr((int(seed),) + names).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, *names) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *names))
    return g


def _carve(flat: torch.Tensor, shapes: Dict[str, tuple]):
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def _draw(shapes, stds, dtype, device, seed, *names):
    """One N(0, 1) draw of every tensor in ``shapes``, each scaled by its
    std; returns views of one buffer."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, 1.0, generator=generator(device, seed, *names))
    parts = _carve(flat, shapes)
    for name, t in parts.items():
        t.mul_(stds[name])
    return parts


def layer_weights(cfg: dict, seed: int, layer: int, device,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s weights: wqkv (d, (hq + 2 hkv) D), wo (hq D, d),
    wg, wu (d, f), wd (f, d) in ``dtype`` (wqkv's v columns scaled by
    ``cfg["draw"]["v_gain"]``); norm1, norm2 (d,), bqkv (where the
    model has it), pred_A (d, r), pred_B (r, f) in float32. The matrices
    are views of one buffer: clone what is kept."""
    d, f, r = cfg["d"], cfg["ffn"], cfg["m2"]["predictor_rank"]
    hq, hkv, D = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    mats = {"wqkv": (d, (hq + 2 * hkv) * D), "wo": (hq * D, d),
            "wg": (d, f), "wu": (d, f), "wd": (f, d)}
    w = _draw(mats, {"wqkv": d ** -0.5, "wo": (hq * D) ** -0.5,
                     "wg": d ** -0.5, "wu": d ** -0.5, "wd": f ** -0.5},
              dtype, device, seed, "layer", layer)
    w["wqkv"][:, (hq + hkv) * D:].mul_(cfg["draw"]["v_gain"])
    w["wd"].mul_(cfg["draw"]["ffn_gain"])
    vecs = {"norm1": (d,), "norm2": (d,), "pred_A": (d, r), "pred_B": (r, f)}
    if cfg["qkv_bias"]:
        vecs["bqkv"] = ((hq + 2 * hkv) * D,)
    w.update(_draw(vecs, {"norm1": VECTOR_STD, "norm2": VECTOR_STD,
                          "bqkv": VECTOR_STD, "pred_A": d ** -0.5,
                          "pred_B": r ** -0.5},
                   torch.float32, device, seed, "layer_vectors", layer))
    return w


def head_weights(cfg: dict, seed: int, device,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """embed (V, d) N(0, 1), unembed (V, d) N(0, 1/d) in ``dtype``;
    final_norm (d,) in float32."""
    V, d = cfg["vocab"], cfg["d"]
    w = _draw({"embed": (V, d), "unembed": (V, d)},
              {"embed": 1.0, "unembed": d ** -0.5}, dtype, device, seed,
              "head")
    w.update(_draw({"final_norm": (d,)}, {"final_norm": VECTOR_STD},
                   torch.float32, device, seed, "head_vectors"))
    return w


def kv_history(cfg: dict, traffic: dict, seed: int, layer: int, which: str,
               out: torch.Tensor) -> torch.Tensor:
    """Fill ``out`` (B, slots, hkv, D), contiguous, with layer ``layer``'s
    ``which`` ("k" or "v") history, N(0, std^2) at the traffic's std, in
    place."""
    std = traffic[f"history_{which}_std"]
    out.normal_(0.0, std, generator=generator(out.device, seed, "kv", which,
                                              layer))
    return out
