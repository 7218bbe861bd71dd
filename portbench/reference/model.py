"""The plain reference of the benchmark's models: a dense decoder whose FFN
is M2Cache's sparse mixed-precision GLU, in float32 PyTorch with TF32 off.

It follows the block the port runs (its configuration files name the
widths):

    x = embed[token]
    per layer:
        h = rms(x) * (1 + norm1)
        q, k, v = h @ wqkv (+ bqkv), RoPE (split halves) on q and k
        x = x + attention(q, cached K/V and k, v) @ wo
        h = rms(x) * (1 + norm2)
        scores = (h @ A) @ B, summed over the rows that share a set
        the top k = round(ratio * f) neurons by score (ties: lower index
        first); ranks [0, k_fp) from the fp weights, the next k_int8 from
        int8 weights, the rest from int4 weights, each quantized from the fp
        weights per neuron over d (scale = max|w| / 127 or / 7, round half
        to even)
        x = x + (silu(h Wg) * (h Wu)) Wd over those neurons
    logits = (rms(x) * (1 + final_norm)) @ unembed.T   (``Head``)

Everything the program derives (int8/int4 banks, scores, sets, tiers, the
K/V it writes) is worked out again here from the same drawn fp weights.
``precision="fp8"`` is the control: every product's operands (weights,
activations, q, k, v, the probabilities, the FFN's hidden units) rounded to
float8 e4m3 with a scale per row, the rest as above.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

#: the port's RMSNorm epsilon
NORM_EPS = 1e-6
INT8_MAX = 127.0
INT4_MAX = 7.0
FP8_MAX = 448.0


def no_tf32():
    """float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude maps to 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Rounding:
    """What the products' operands pass through: nothing at float32, or
    :func:`fp8` for the control."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def __call__(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return fp8(t, dim) if self.precision == "fp8" else t


def tier_sizes(f: int, m2: dict) -> Dict[str, int]:
    """Active neurons and their split by rank (M2Cache's ratios)."""
    k = min(max(int(round(f * m2["active_ratio"])), 8), f)
    k_fp = int(round(k * m2["ratio_fp"]))
    k_i8 = int(round(k * m2["ratio_int8"]))
    return {"k": k, "fp": k_fp, "int8": k_i8, "int4": k - k_fp - k_i8}


def quantized(rows: torch.Tensor, qmax: float) -> torch.Tensor:
    """Each row (a neuron's weights over d) quantized symmetrically to
    ``qmax`` levels with its own scale, then dequantized: float32."""
    scale = (rows.abs().amax(dim=1, keepdim=True) / qmax).clamp_min(1e-8)
    q = torch.clamp(torch.round(rows / scale), -qmax, qmax)
    return q * scale


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + NORM_EPS) * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, H, D) at absolute positions ``pos`` (..., T); the two
    halves of D rotate together. Angles in float64."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = pos.double()[..., None, None] * inv
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Layer:
    """One layer's weights in float32, from the drawn fp weights ``w``
    (``harness.weights.layer_weights``' keys, any float dtype)."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict,
                 rnd: Rounding):
        self.cfg, self.rnd = cfg, rnd
        f32 = {n: t.float() for n, t in w.items()}
        self.norm1, self.norm2 = f32["norm1"], f32["norm2"]
        self.bqkv = f32.get("bqkv")
        self.wqkv_t = rnd(f32["wqkv"].t().contiguous())      # (out, d)
        self.wo_t = rnd(f32["wo"].t().contiguous())          # (d, hq*hd)
        self.A, self.B = f32["pred_A"], f32["pred_B"]
        # neuron-major: gate and up (f, d), down (f, d)
        self.fp = {"wg": f32["wg"].t().contiguous(),
                   "wu": f32["wu"].t().contiguous(), "wd": f32["wd"]}
        self.sizes = tier_sizes(self.fp["wd"].shape[0], cfg["m2"])

    # -- attention ---------------------------------------------------------
    def qkv(self, x: torch.Tensor, pos: torch.Tensor):
        """x (N, d) at positions pos (N,) -> q (N, hq, D), k, v (N, hkv, D),
        q and k rotated."""
        c = self.cfg
        h = rms_norm(x, self.norm1)
        y = self.rnd(h) @ self.wqkv_t.t()
        if self.bqkv is not None:
            y = y + self.bqkv
        hq, hkv, D = c["heads"], c["kv_heads"], c["head_dim"]
        q, k, v = torch.split(y, [hq * D, hkv * D, hkv * D], dim=-1)
        q = rope(q.reshape(-1, hq, D), pos, c["rope_theta"])
        k = rope(k.reshape(-1, hkv, D), pos, c["rope_theta"])
        return q, k, v.reshape(-1, hkv, D)

    def attend(self, q, k, v, q_pos, k_pos, chunk: int = 1024):
        """Causal attention of q (S, hq, D) at q_pos (S,) over k, v (T, hkv,
        D) at k_pos (T,): a key takes part at or before the query's
        position. Returns (S, hq * D)."""
        S, hq, D = q.shape
        hkv = k.shape[1]
        G = hq // hkv
        kk = self.rnd(k).permute(1, 2, 0)                    # (hkv, D, T)
        vv = self.rnd(v).permute(1, 0, 2)                    # (hkv, T, D)
        outs = []
        for s0 in range(0, S, chunk):
            qc = self.rnd(q[s0:s0 + chunk])                  # (s, hq, D)
            s = qc.shape[0]
            qg = qc.reshape(s, hkv, G, D).permute(1, 0, 2, 3).reshape(
                hkv, s * G, D)
            sc = torch.bmm(qg, kk) / math.sqrt(D)            # (hkv, s*G, T)
            qp = q_pos[s0:s0 + chunk].repeat_interleave(G)
            mask = k_pos[None, :] <= qp[:, None]
            sc = sc.masked_fill(~mask[None], float("-inf"))
            p = torch.softmax(sc, dim=-1)
            o = torch.bmm(self.rnd(p), vv)                   # (hkv, s*G, D)
            outs.append(o.reshape(hkv, s, G, D).permute(1, 0, 2, 3).reshape(
                s, hq * D))
        return torch.cat(outs)

    def attn_out(self, x, a):
        return x + self.rnd(a) @ self.wo_t.t()

    # -- the M2Cache FFN ---------------------------------------------------
    def ffn_in(self, x: torch.Tensor) -> torch.Tensor:
        """The FFN's normed input h of the residual x (N, d)."""
        return rms_norm(x, self.norm2)

    def scores(self, h: torch.Tensor) -> torch.Tensor:
        """The predictor's scores (f,) of rows h (N, d), summed over the
        rows that share a set."""
        scores = (h @ self.A) @ self.B                       # (N, f)
        return scores[0] if scores.shape[0] == 1 else scores.sum(dim=0)

    def active(self, h: torch.Tensor) -> torch.Tensor:
        """The rank-ordered active set of rows h (N, d), shared by them."""
        order = torch.sort(self.scores(h), descending=True,
                           stable=True).indices
        return order[:self.sizes["k"]]

    def ffn(self, x: torch.Tensor, h: torch.Tensor,
            order: torch.Tensor) -> torch.Tensor:
        """The residual x (N, d) after the FFN of its normed rows h over the
        rank-ordered active set ``order`` (k,) that the N rows share."""
        z = self.sizes
        bounds = (("fp", 0, z["fp"]), ("int8", z["fp"], z["fp"] + z["int8"]),
                  ("int4", z["fp"] + z["int8"], z["k"]))
        hr = self.rnd(h)
        y = torch.zeros_like(x)
        for tier, a, b in bounds:
            if a == b:
                continue
            sel = order[a:b].long()
            w = {n: t.index_select(0, sel) for n, t in self.fp.items()}
            if tier != "fp":
                qmax = INT8_MAX if tier == "int8" else INT4_MAX
                w = {n: quantized(t, qmax) for n, t in w.items()}
            else:
                w = {n: self.rnd(t) for n, t in w.items()}
            g = hr @ w["wg"].t()
            u = hr @ w["wu"].t()
            y = y + self.rnd(torch.nn.functional.silu(g) * u) @ w["wd"]
        return x + y


class Head:
    """The embedding, the final norm and the unembedding's table (V, d) in
    float32."""

    def __init__(self, w: Dict[str, torch.Tensor], rnd: Rounding):
        self.rnd = rnd
        self.embed = w["embed"]                              # kept as drawn
        self.norm = w["final_norm"].float()
        self.table = w["unembed"].float()

    def embed_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        e = self.embed.index_select(0, tokens.long()).float()
        return self.rnd(e)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The logits (N, V) of final residuals x (N, d): the final norm,
        then the unembedding."""
        h = rms_norm(x, self.norm)
        return self.rnd(h) @ self.rnd(self.table).t()
