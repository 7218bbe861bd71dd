"""AdamW with a linear warmup and a cosine schedule (``repro/training/
optimizer.py``), over the port's params: nested dictionaries and lists of
tensors.

Every number is computed as the reference computes it: the schedule and
the bias corrections in fp32 tensors, the moments and the update in the
same fp32 operations in the same order, so that the same gradients give
the same parameters to fp32 rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map
from repro_torch.models.transformer import pattern_split


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32, ()
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int tensor), an fp32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params) -> AdamWState:
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def reference_ndims(params, model_cfg) -> List[int]:
    """Each leaf's number of axes in the reference's tree, in
    ``tree.tree_leaves``' order: the reference stacks the layers of each
    pattern position over its F repeats (``layers.pattern``), one axis
    deeper than the port's per-layer leaves; the remainder layers and the
    leaves outside the layers are as the port has them."""
    pat, F, _ = pattern_split(model_cfg)
    stacked = F * len(pat)
    out = []
    for name, sub in params.items():
        if name != "layers":
            out += [t.dim() for t in tree_leaves(sub)]
            continue
        for l, layer in enumerate(sub):
            out += [t.dim() + (l < stacked) for t in tree_leaves(layer)]
    return out


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig,
                  model_cfg):
    """One AdamW step (reference :52-82) over a model's params (leaves in
    ``tree.tree_leaves``' order) with ``grads`` of the same structure (zeros
    at non-float leaves). The gradients are clipped to ``cfg.grad_clip``
    by their global norm. Weight decay applies to the leaves the
    reference's tree holds with two axes or more (:73): with
    ``model_cfg``'s layers stacked there (:func:`reference_ndims`), that
    includes the norms and biases of the pattern layers. Non-float leaves
    (int8 banks) are not changed. Writes the new params and moments into
    the given tensors (the reference donates them) and returns (params,
    AdamWState(step + 1, m, v), {"grad_norm", "lr"})."""
    g_leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in g_leaves))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    for p, g, m, v, ndim in zip(tree_leaves(params), g_leaves,
                                tree_leaves(state.m), tree_leaves(state.v),
                                reference_ndims(params, model_cfg)):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        if not p.is_floating_point():
            continue                        # int8 banks are not trained
        u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        wd = cfg.weight_decay if ndim >= 2 else 0.0
        pf = p.float()
        p.copy_((pf - lr * (u + wd * pf)).to(p.dtype))
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                        "lr": lr}
