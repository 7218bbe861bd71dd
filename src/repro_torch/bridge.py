"""Carry parameters between the reference's layout and the port's.

``jax.random`` cannot be reproduced with ``torch.Generator``s, so parity
tests initialise with ``repro.models.transformer.init_params``, turn every
leaf into a numpy array (``jax.tree.map(np.asarray, params)``) and load the
result here (:func:`params_from_jax`); :func:`params_to_jax` gives the port's
params back in the reference's layout (checkpoints, tests). This module
itself only sees numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantize import to_neuron_major, to_reference_layout
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map


def to_tensor(a, device) -> torch.Tensor:
    """numpy -> torch, bytewise (int8 banks keep their exact bytes; bf16
    arrives as ml_dtypes' bfloat16 and is carried as its 16-bit pattern)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_tree, cfg, device) -> dict:
    """The reference's param pytree (numpy leaves) -> the port's params.

    ``layers.pattern[i]``'s leading F axis is unstacked into one dictionary
    per layer, in layer order; every leaf keeps its name and its bytes, and
    each layer's M2Cache FFN banks are stored neuron-major
    (``core.quantize.to_neuron_major``). Leaves come over as the tree has
    them: a parallel block's layer has no ``norm2``, a tied model's tree no
    ``unembed``, an MoE layer's FFN its experts, router and predictor
    leaves and no banks, a dense (``m2=False``) layer's FFN its (d, f)
    ``wg``/``wu`` and (f, d) ``wd`` as they are, an SSD layer no ``ffn``
    at all."""
    dev = torch.device(device)
    pat, F, rem = T.pattern_split(cfg)
    layers = []
    for r in range(F):
        for i in range(len(pat)):
            layers.append(tree_map(lambda a: to_tensor(np.asarray(a)[r], dev),
                                   np_tree["layers"]["pattern"][i]))
    for i in range(rem):
        layers.append(tree_map(lambda a: to_tensor(a, dev),
                               np_tree["layers"]["remainder"][i]))
    for layer in layers:
        if "banks" in layer.get("ffn", {}):
            layer["ffn"]["banks"] = to_neuron_major(layer["ffn"]["banks"])
    out = {"layers": layers}
    for name in ("final_norm", "embed", "unembed"):
        if name in np_tree:
            out[name] = to_tensor(np_tree[name], dev)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy on the host, bytewise."""
    return t.detach().cpu().numpy()


def params_to_jax(params, cfg) -> dict:
    """The port's params (or a tree of the same structure, such as AdamW's
    moments) -> the reference's pytree with numpy leaves: the inverse of
    :func:`params_from_jax`. The layers of pattern position i over the F
    repeats (layers r * len(pattern) + i) are stacked on a leading axis in
    ``layers.pattern[i]``, the remainder layers kept apart in
    ``layers.remainder``, and each M2Cache FFN's banks go back to the
    reference's layout (``core.quantize.to_reference_layout``)."""
    pat, F, rem = T.pattern_split(cfg)
    n = len(pat)
    if F == 0:
        raise ValueError(f"{cfg.name}: fewer layers than its pattern")
    layers = []
    for layer in params["layers"]:
        if "banks" in layer.get("ffn", {}):
            layer = dict(layer, ffn=dict(
                layer["ffn"], banks=to_reference_layout(layer["ffn"]["banks"])))
        layers.append(tree_map(to_numpy, layer))

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)
    out = {"layers": {
        "pattern": [stack([layers[r * n + i] for r in range(F)])
                    for i in range(n)],
        "remainder": layers[F * n:F * n + rem]}}
    for name in ("final_norm", "embed", "unembed"):
        if name in params:
            out[name] = to_numpy(params[name])
    return out
