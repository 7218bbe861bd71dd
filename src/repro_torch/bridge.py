"""Carry the reference's parameters over to the port.

``jax.random`` cannot be reproduced with ``torch.Generator``s, so parity
tests initialise with ``repro.models.transformer.init_params``, turn every
leaf into a numpy array (``jax.tree.map(np.asarray, params)``) and load the
result here. This module itself only sees numpy.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer as T


def to_tensor(a, device) -> torch.Tensor:
    """numpy -> torch, bytewise (int8 banks keep their exact bytes; bf16
    arrives as ml_dtypes' bfloat16 and is carried as its 16-bit pattern)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _map(tree: Any, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(np_tree, cfg, device) -> dict:
    """The reference's param pytree (numpy leaves) -> the port's params.

    ``layers.pattern[i]``'s leading F axis is unstacked into one dictionary
    per layer, in layer order; every leaf keeps its name."""
    dev = torch.device(device)
    pat, F, rem = T.pattern_split(cfg)
    layers = []
    for r in range(F):
        for i in range(len(pat)):
            layers.append(_map(np_tree["layers"]["pattern"][i],
                               lambda a: to_tensor(np.asarray(a)[r], dev)))
    for i in range(rem):
        layers.append(_map(np_tree["layers"]["remainder"][i],
                           lambda a: to_tensor(a, dev)))
    out = {"layers": layers}
    for name in ("final_norm", "embed", "unembed"):
        if name in np_tree:
            out[name] = to_tensor(np_tree[name], dev)
    return out
