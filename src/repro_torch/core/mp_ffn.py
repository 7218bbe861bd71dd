"""Dynamic sparse mixed-precision FFN (``repro/core/mp_ffn.py``), the
serving path of the paper's MP Inference (§5.2).

Per forward call:
  1. the predictor scores every FFN neuron from the block input,
  2. the top ``k = active_ratio·f`` neurons form the active set, sorted by
     score: batch-shared, or one per batch row where each row is its own
     request (the server's path, where the reference vmaps a one-row graph),
  3. the top ``r_fp16·k`` ranks come from the fp bank, the next
     ``r_int8·k`` ranks from the INT8 bank, the rest from the packed INT4
     bank,
  4. the gathered mixed-precision neurons run the GLU FFN: on the card
     through the gathered qmatmul kernel straight from the banks, on the
     CPU through the reference's gather/dequantize/concatenate/einsum.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.predictor import predictor_scores, shared_topk_indices
from repro_torch.kernels import ops
from repro_torch.models.common import (activation, data_idle, each_row,
                                       model_idle_data, off_model, on_model,
                                       shard_on)

#: a layer's places in the model's layer pattern (``mp_ffn_apply``'s ``place``)
PLACES = ("scan", "carry", "remainder")


def tier_sizes(f: int, cfg) -> Dict[str, int]:
    k = max(int(round(f * cfg.m2_active_ratio)), 8)
    k = min(k, f)
    k16 = int(round(k * cfg.m2_ratio_fp16))
    k8 = int(round(k * cfg.m2_ratio_int8))
    k4 = max(k - k16 - k8, 0)
    return {"k": k16 + k8 + k4, "fp16": k16, "int8": k8, "int4": k4}


def mp_ffn_apply(cfg, banks, pred, x, *, rows: bool = False,
                 place: str = "carry"):
    """x: (B, S, d) — serving activations. banks/pred: one layer's params.
    ``rows``: each batch row takes its own active set over its own S
    positions (idx (B, k)) instead of one shared set (idx (k,)).
    ``place``: the layer's place in the model's layer pattern (one of
    ``PLACES``), which sets where GSPMD puts its products on a mesh:
    "scan", a pattern repeat's layer whose output stays inside the repeat;
    "carry", a repeat's last layer, whose output is the reference's scan
    carry (the default: a layer alone); "remainder", a layer past the
    repeats. On a mesh (a DTensor x) the predictor reads x with its
    features on "model", as the reference's activations come; a remainder
    layer's one row (its rows leave "data" idle) contracts the whole d,
    x and A whole over "model". On a mesh whose "model" dim is one device
    (``models.common.model_idle_data``) x's d lies on the idle "data" dim
    for the predictor and the gate and up products instead, and but for
    "carry" the down banks' d too, so the down product writes its d there.

    Returns (y, info) where info carries the rank-sorted active indices and
    the per-step weight bytes the tiers move."""
    B, S, d = x.shape
    f = banks["wg_i8_s"].shape[-1]
    sizes = tier_sizes(f, cfg)
    k, k16, k8, k4 = sizes["k"], sizes["fp16"], sizes["int8"], sizes["int4"]
    if place not in PLACES:
        raise ValueError(f"mp_ffn_apply: place {place!r} not in {PLACES}")
    i = model_idle_data(x)
    whole_d = i < 0 and place == "remainder" and data_idle(x)
    x = shard_on(x, i, -1)
    if i >= 0 and place != "carry":
        banks = {n: shard_on(t, i, 1) if n.startswith("wd_") and t.dim() == 2
                 else t for n, t in banks.items()}

    def top_k(xs):                                            # rank-sorted
        if i >= 0:
            scores = predictor_scores(xs, pred["A"], pred["B"])
        elif whole_d:
            scores = predictor_scores(off_model(xs), off_model(pred["A"]),
                                      pred["B"])
        else:
            scores = predictor_scores(on_model(xs), pred["A"], pred["B"])
        return shared_topk_indices(scores, k)
    idx = each_row(lambda xr: top_k(xr)[None], x) if rows else top_k(x)
    y = ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)
    bytes_moved = 3 * d * (k16 * 2 + k8 * 1 + k4 * 0.5)
    info = {"active_idx": idx, "bytes_weights": bytes_moved, "sizes": sizes}
    return y, info


def mp_ffn_reference(cfg, wg, wu, wd, pred, x):
    """Oracle: the dense FFN masked to the same batch-shared active set at
    full precision (reference :98-110), to bound the quantization error of
    :func:`mp_ffn_apply`. wg, wu: (d, f); wd: (f, d) (the reference's
    layout); x: (B, S, d)."""
    f = wg.shape[-1]
    idx = shared_topk_indices(predictor_scores(x, pred["A"], pred["B"]),
                              tier_sizes(f, cfg)["k"])
    mask = torch.zeros(f, dtype=torch.bool, device=x.device)
    mask[idx] = True
    act = activation(cfg.ffn_act)
    h = act(torch.einsum("bsd,df->bsf", x, wg))
    h = h * torch.einsum("bsd,df->bsf", x, wu)
    h = torch.where(mask, h, 0.0).to(x.dtype)
    return torch.einsum("bsf,fd->bsd", h, wd)
