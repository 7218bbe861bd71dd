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

from repro_torch.core.predictor import predictor_scores, shared_topk_indices
from repro_torch.kernels import ops
from repro_torch.models.common import each_row


def tier_sizes(f: int, cfg) -> Dict[str, int]:
    k = max(int(round(f * cfg.m2_active_ratio)), 8)
    k = min(k, f)
    k16 = int(round(k * cfg.m2_ratio_fp16))
    k8 = int(round(k * cfg.m2_ratio_int8))
    k4 = max(k - k16 - k8, 0)
    return {"k": k16 + k8 + k4, "fp16": k16, "int8": k8, "int4": k4}


def mp_ffn_apply(cfg, banks, pred, x, *, rows: bool = False):
    """x: (B, S, d) — serving activations. banks/pred: one layer's params.
    ``rows``: each batch row takes its own active set over its own S
    positions (idx (B, k)) instead of one shared set (idx (k,)).

    Returns (y, info) where info carries the rank-sorted active indices and
    the per-step weight bytes the tiers move."""
    B, S, d = x.shape
    f = banks["wg_i8_s"].shape[-1]
    sizes = tier_sizes(f, cfg)
    k, k16, k8, k4 = sizes["k"], sizes["fp16"], sizes["int8"], sizes["int4"]

    def top_k(xs):                                            # rank-sorted
        return shared_topk_indices(predictor_scores(xs, pred["A"], pred["B"]),
                                   k)
    idx = each_row(lambda xr: top_k(xr)[None], x) if rows else top_k(x)
    y = ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)
    bytes_moved = 3 * d * (k16 * 2 + k8 * 1 + k4 * 0.5)
    info = {"active_idx": idx, "bytes_weights": bytes_moved, "sizes": sizes}
    return y, info
