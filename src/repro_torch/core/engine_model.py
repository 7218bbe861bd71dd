"""Real-model execution for the serving engine (``repro/core/engine_model.py``).

``RealModelRunner`` runs prefill and greedy decode through the M2Cache
forward and surfaces per-layer active-neuron indices so the multi-level
cache manager replays *actual* predictor behaviour. The reference's
``jit``-compiled closures become plain methods: PyTorch runs eagerly.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T


def flatten_active_idx(cfg, aux_idx) -> List[np.ndarray]:
    """aux['active_idx'] -> flat per-layer list in layer order.

    Pattern entries are stacked (F, k); layer l = repeat*len(pat)+pos.
    """
    pat, F, rem = T.pattern_split(cfg)
    out: List[np.ndarray] = []
    pattern = [np.asarray(a.cpu()) for a in aux_idx["pattern"]]
    for r in range(F):
        for p in range(len(pat)):
            arr = pattern[p]
            out.append(arr[r] if arr.size else np.zeros((0,), np.int64))
    for a in aux_idx["remainder"]:
        a = np.asarray(a.cpu())
        out.append(a if a.size else np.zeros((0,), np.int64))
    return out


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RealModelRunner:
    def __init__(self, cfg, params, *, max_seq: int, dtype=torch.float32,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.dtype = dtype
        self.device = resolve_device(device)
        have = params["embed"].device
        if have.type != self.device.type:
            raise ValueError(f"params live on {have}, runner asked for "
                             f"{self.device}")
        self.last_logits = None          # (B, V) logits after generate()
        self.wall_s = {"prefill": 0.0, "decode": []}   # per-step wall seconds

    @torch.no_grad()
    def _prefill(self, params, tokens):
        B = tokens.shape[0]
        cache = T.init_cache(self.cfg, B, max_seq=self.max_seq,
                             dtype=self.dtype, device=self.device)
        logits, cache, aux = T.forward(self.cfg, params, tokens, cache=cache,
                                       mode="prefill", m2=True)
        return logits[..., -1, :], cache, aux["active_idx"]

    @torch.no_grad()
    def _decode(self, params, cache, tok):
        logits, cache, aux = T.forward(self.cfg, params, tok, cache=cache,
                                       mode="decode", m2=True)
        return logits[..., 0, :], cache, aux["active_idx"]

    @torch.no_grad()
    def generate(self, prompts, gen_len: int
                 ) -> Tuple[np.ndarray, List[List[np.ndarray]]]:
        """Greedy decode. Returns (tokens (B, gen_len), active-idx per step)."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                  device=self.device)
        t0 = time.perf_counter()
        last, cache, _ = self._prefill(self.params, prompts)
        _sync(self.device)
        self.wall_s = {"prefill": time.perf_counter() - t0, "decode": []}
        outs, idx_steps = [], []
        for _ in range(gen_len):
            t0 = time.perf_counter()
            nxt = torch.argmax(last, dim=-1)
            outs.append(nxt.to(torch.int32).cpu().numpy())
            last, cache, aux_idx = self._decode(self.params, cache,
                                                nxt[:, None])
            idx_steps.append(flatten_active_idx(self.cfg, aux_idx))
            self.wall_s["decode"].append(time.perf_counter() - t0)
        self.last_logits = last
        return np.stack(outs, axis=-1), idx_steps


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy with the tensor's exact bytes (numpy has no bf16: bf16 is
    written as its uint16 bit pattern)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def extract_layer_banks(cfg, params) -> List[dict]:
    """Per-layer quantized neuron banks (numpy) for the SSD tier, in layer
    order."""
    return [{k: _to_numpy(v) for k, v in layer["ffn"]["banks"].items()}
            for layer in params["layers"]]
