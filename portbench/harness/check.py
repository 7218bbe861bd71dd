"""The comparison that decides ``correct``: a sample of what the timed
path produced, drawn from the seed, against the plain reference
(``portbench/reference``) on the same drawn weights and inputs, through
every layer of the step.

What the timed path produces and the comparison reads: the K and V each
layer wrote into the cache, each layer's rank-ordered active set of the
M2Cache FFN (the forward's ``active_idx``), and the logits of the
positions it served, with the tokens it served. The reference works out
each layer again in float32 (embedding, norms, QKV, RoPE, attention over
the cache, the predictor's scores, the int8/int4 banks, the GLU, the final
norm and the unembedding) and, layer by layer:

- ``kv_rel``: holds the layer's K and V to its own: the largest
  ||K - K_ref|| / ||K_ref|| of one decode step's rows, or of one prompt, in
  any layer;
- ``set_gap``: judges the layer's active set by its own scores: for each
  tier's boundary (fp, int8, the set's end), how far the best neuron the
  set leaves below it outscores the worst one inside it, over the
  scores' standard deviation; 0 where the set is the reference's own;
- then runs the layer's FFN over that judged set, so that the next
  layer starts from the program's choice of neurons. A bf16 rounding moves
  a few of 4147 or 8602 neurons across a boundary among near-ties; each
  such swap changes a layer's output as much as any active neuron does,
  so a reference that chose its own sets would drift from a sound program
  layer by layer, as far as the float8 control lies, within 8 layers.
  Following the judged sets keeps the K/V of every layer comparable; the
  selection that this follows is held by itself by ``set_gap``;
- ``logit_rel`` and ``logit_gap``: at the positions whose logits the
  sample holds, ||logits - ref|| / ||ref||, and how far the served token's
  reference logit lies below the reference's best.

A decode step attends over the history (drawn again from the seed), the
K/V that the segment's earlier steps wrote (the program's, read from its
cache: the reference cannot run every step of the window), and the
step's own. The segment's first step, which reads no K/V the program
wrote, is always in the sample.

The control (``harness.main.compare``'s "fp8"): the reference computed in
float8 in the program's place, choosing its own sets; its K/V, sets and
logits are judged by a float32 reference as the program's are.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from portbench.harness import traffic as TR
from portbench.harness import weights as W
from portbench.reference import model as R

NUMBERS = ("kv_rel", "set_gap", "logit_rel", "logit_gap")


def sample_steps(steps: List[dict], n: int, tail: int, seed: int
                 ) -> List[int]:
    """Indices of ``n`` decode steps of the last segment: its first, its
    last ``tail`` and the rest drawn from the seed."""
    seg = steps[-1]["segment"]
    idx = [i for i, s in enumerate(steps) if s["segment"] == seg]
    if len(idx) <= n:
        return idx
    fixed = {idx[0], *idx[-tail:]}
    rest = [i for i in idx if i not in fixed]
    mid = TR.rng(seed, "check").choice(rest, n - len(fixed), replace=False)
    return sorted(fixed | set(mid.tolist()))


def sample_requests(traffic: dict, n: int, seed: int) -> List[int]:
    """Indices of ``n`` requests, drawn before the window from the seed
    among the first block of the mix (every length once), the longest
    among them."""
    sizes = traffic["sizes"]
    pool = max(sizes, n)
    lengths = [TR.prompt_length(traffic, seed, i) for i in range(sizes)]
    longest = lengths.index(max(lengths))
    rest = [i for i in range(pool) if i != longest]
    pick = TR.rng(seed, "check").choice(rest, n - 1, replace=False)
    return sorted([longest, *pick.tolist()])


class Numbers:
    """The largest of each number over a stream's layers and cases, and
    ``kv_rel`` by layer."""

    def __init__(self, layers: int):
        self.top = {n: 0.0 for n in NUMBERS}
        self.by_layer = [0.0] * layers

    def add(self, name: str, value: float, layer: Optional[int] = None):
        self.top[name] = _larger(self.top[name], value)
        if layer is not None:
            self.by_layer[layer] = _larger(self.by_layer[layer], value)


def _larger(a: float, b: float) -> float:
    """The larger of a and b; a NaN in either stays."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over the whole tensors."""
    g, r = got.float().flatten(), ref.float().flatten()
    return float((g - r).norm() / r.norm())


def set_gap(scores: torch.Tensor, order: torch.Tensor,
            sizes: Dict[str, int]) -> float:
    """How far the rank-ordered set ``order`` (k,) departs from the order of
    ``scores`` (f,): at each tier's boundary b, max(0, the best score
    outside the first b - the worst inside them), over the scores' standard
    deviation. inf for a set that is not k distinct neurons."""
    f, k = scores.shape[0], sizes["k"]
    order = order.to(scores.device).long().flatten()
    if order.numel() != k or order.min() < 0 or order.max() >= f \
            or torch.unique(order).numel() != k:
        return math.inf
    worst = 0.0
    for b in (sizes["fp"], sizes["fp"] + sizes["int8"], k):
        if b == 0 or b == f:
            continue
        inside = torch.zeros(f, dtype=torch.bool, device=scores.device)
        inside[order[:b]] = True
        gap = scores[~inside].max() - scores[inside].min()
        worst = max(worst, float(gap))
    return worst / float(scores.std())


class Case:
    """One decode step or one prompt as the comparison takes it: ``tokens``
    (N,) and ``pos`` (N,); for a decode step, N rows each at its own
    sequence's end (``rows`` True), for a prompt one sequence of N tokens.
    ``kv``: {"k", "v"} (layers, N, hkv, D) and ``sets`` (layers, k): what
    the program wrote and chose; ``logits`` (n, V) of the positions
    ``logit_rows`` (n,) and the tokens ``served`` (n,) there, or None."""

    def __init__(self, tokens, pos, rows, kv, sets, logits=None,
                 logit_rows=None, served=None):
        self.tokens, self.pos, self.rows = tokens, pos, rows
        self.kv, self.sets = kv, sets
        self.logits, self.logit_rows, self.served = \
            logits, logit_rows, served


class Context:
    """What a decode step attends over before its own K/V: the history
    (drawn again from the seed, a layer at a time, held in the served
    dtype and taken to float32 a row at a time) and the segment's
    slots the program wrote (``segment``: {"k", "v"} (layers, B, n, hkv,
    D), from slot ``base`` on). None for prompts."""

    def __init__(self, cfg, traffic, seed, device, segment):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.segment = device, segment
        self.base = traffic["reset_to"]
        self.hist = None

    def load(self, layer: int):
        t, c = self.traffic, self.cfg
        self.hist = {}
        for which in ("k", "v"):
            buf = torch.empty((t["sessions"], t["slots"], c["kv_heads"],
                               c["head_dim"]), dtype=W.served_dtype(c),
                              device=self.device)
            W.kv_history(c, t, self.seed, layer, which, buf)
            self.hist[which] = buf[:, :t["history"]]
            del buf

    def keys(self, layer: int, b: int, pos: int, which: str,
             own: torch.Tensor) -> torch.Tensor:
        seg = self.segment[which][layer, b, :pos - self.base].float()
        return torch.cat([self.hist[which][b].float(), seg, own])


def _attend(layer: R.Layer, q, k, v, case: Case, ctx: Optional[Context],
            l: int) -> torch.Tensor:
    if not case.rows:
        return layer.attend(q, k, v, case.pos, case.pos)
    out = []
    for b in range(q.shape[0]):
        pos = int(case.pos[b])
        kpos = torch.arange(pos + 1, device=q.device)
        kk = ctx.keys(l, b, pos, "k", k[b:b + 1])
        vv = ctx.keys(l, b, pos, "v", v[b:b + 1])
        out.append(layer.attend(q[b:b + 1], kk, vv, kpos[-1:], kpos))
    return torch.cat(out)


def serve_layer(layer: R.Layer, x, case: Case, ctx, l: int):
    """The reference in the program's place at one layer: (x after it, k,
    v, its own rank-ordered set)."""
    q, k, v = layer.qkv(x, case.pos)
    x = layer.attn_out(x, _attend(layer, q, k, v, case, ctx, l))
    h = layer.ffn_in(x)
    order = layer.active(h)
    return layer.ffn(x, h, order), k, v, order


def follow_layer(layer: R.Layer, x, case: Case, ctx, l: int, served: Dict,
                 nums: Numbers) -> torch.Tensor:
    """The float32 reference at one layer, judging what was served there
    (``served``: "k", "v" (N, hkv, D), "set" (k,)); the FFN over the served
    set. Returns x after the layer."""
    q, k, v = layer.qkv(x, case.pos)
    nums.add("kv_rel", max(rel(served["k"], k), rel(served["v"], v)), l)
    x = layer.attn_out(x, _attend(layer, q, k, v, case, ctx, l))
    h = layer.ffn_in(x)
    nums.add("set_gap", set_gap(layer.scores(h), served["set"],
                                layer.sizes))
    return layer.ffn(x, h, served["set"].to(x.device))


def judge_logits(head: R.Head, x, logits, served, nums: Numbers):
    ref = head.logits(x)
    got = logits.float().to(ref.device)
    nums.add("logit_rel", float(((got - ref).norm(dim=-1)
                                 / ref.norm(dim=-1)).max()))
    tok = served.to(ref.device).long()
    gap = ref.max(dim=-1).values - ref.gather(1, tok[:, None])[:, 0]
    nums.add("logit_gap", float(gap.max()))


@torch.no_grad()
def compare(cfg: dict, seed: int, device, cases: Sequence[Case],
            ctx: Optional[Context] = None, control: bool = False
            ) -> Dict[str, Dict]:
    """The numbers of the program's cases and, with ``control``, of the
    reference computed in float8 in the program's place on the same
    inputs: {"fp32": {"numbers", "kv_by_layer"}, "fp8": ...}. Runs a layer
    at a time, each drawn again from the seed."""
    R.no_tf32()
    L = cfg["layers"]
    dt = W.served_dtype(cfg)
    hw = W.head_weights(cfg, seed, device, dt)
    head = R.Head(hw, R.Rounding("fp32"))
    head8 = R.Head(hw, R.Rounding("fp8")) if control else None
    del hw
    toks = [c.tokens.to(device) for c in cases]
    for c in cases:
        c.pos = c.pos.to(device)
    nums = {"fp32": Numbers(L)}
    x = {"fp32": [head.embed_rows(t) for t in toks]}
    if control:
        nums["fp8"] = Numbers(L)
        x["fp8"] = [head8.embed_rows(t) for t in toks]      # serves
        x["fp8_judge"] = [head.embed_rows(t) for t in toks]
    for l in range(L):
        w = W.layer_weights(cfg, seed, l, device, dt)
        ref = R.Layer(w, cfg, R.Rounding("fp32"))
        ref8 = R.Layer(w, cfg, R.Rounding("fp8")) if control else None
        del w
        if ctx is not None:
            ctx.load(l)
        for i, c in enumerate(cases):
            if control:
                x["fp8"][i], k8, v8, s8 = serve_layer(ref8, x["fp8"][i], c,
                                                      ctx, l)
                x["fp8_judge"][i] = follow_layer(
                    ref, x["fp8_judge"][i], c, ctx, l,
                    {"k": k8, "v": v8, "set": s8}, nums["fp8"])
            served = {"k": c.kv["k"][l], "v": c.kv["v"][l],
                      "set": c.sets[l]}
            x["fp32"][i] = follow_layer(ref, x["fp32"][i], c, ctx, l,
                                        served, nums["fp32"])
        del ref, ref8
    for i, c in enumerate(cases):
        if c.logits is None:
            continue
        at = c.logit_rows.to(device)
        judge_logits(head, x["fp32"][i][at], c.logits, c.served,
                     nums["fp32"])
        if control:
            got = head8.logits(x["fp8"][i][at])
            judge_logits(head, x["fp8_judge"][i][at], got,
                         got.argmax(dim=-1), nums["fp8"])
    return {p: {"numbers": n.top, "kv_by_layer": n.by_layer}
            for p, n in nums.items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN or a missing one
    fails)."""
    return all(numbers.get(n, float("nan")) <= lim
               for n, lim in limits.items())
