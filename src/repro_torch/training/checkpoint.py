"""Checkpoints in the reference's format (``repro/training/checkpoint.py``):
a directory of ``params.npz`` and ``opt_state.npz``, each leaf stored as
``leaf_{i}`` in ``jax.tree.flatten``'s order of the reference's pytree
(dictionary keys sorted, the stacked pattern layers before the remainder,
the optimiser state as AdamWState(step, m, v)), and ``meta.json``. A
checkpoint saved by either package loads in the other: the port goes
through ``bridge.params_to_jax`` and ``bridge.params_from_jax``.
"""
from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np
import torch

from repro_torch.bridge import params_from_jax, params_to_jax, to_numpy
from repro_torch.training.optimizer import AdamWState
from repro_torch.tree import tree_leaves


def _refill(tree, it: Iterator):
    """``tree`` with its leaves replaced, in ``jax.tree.flatten``'s order,
    by the next items of ``it``."""
    if isinstance(tree, dict):
        new = {k: _refill(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_refill(v, it) for v in tree]
    return next(it)


def _opt_tree(opt_state: AdamWState, cfg) -> list:
    return [to_numpy(opt_state.step), params_to_jax(opt_state.m, cfg),
            params_to_jax(opt_state.v, cfg)]


def _save_npz(path: str, tree):
    leaves = tree_leaves(tree, sort_keys=True)
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def save(path: str, params, opt_state: AdamWState = None,
         metadata: dict = None, *, cfg):
    """Save the port's ``params`` (and ``opt_state``) of model ``cfg``."""
    os.makedirs(path, exist_ok=True)
    _save_npz(os.path.join(path, "params.npz"), params_to_jax(params, cfg))
    if opt_state is not None:
        _save_npz(os.path.join(path, "opt_state.npz"),
                  _opt_tree(opt_state, cfg))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(metadata or {}, f)


def _restore(npz_path: str, template):
    """``template`` (a numpy tree) filled from the file, each leaf cast to
    the template's dtype; raises where a shape differs."""
    with np.load(npz_path) as data:
        leaves = []
        for i, old in enumerate(tree_leaves(template, sort_keys=True)):
            new = data[f"leaf_{i}"].astype(old.dtype)
            if new.shape != old.shape:
                raise ValueError(f"{npz_path}: leaf_{i} has shape "
                                 f"{new.shape}, the template {old.shape}")
            leaves.append(new)
    return _refill(template, iter(leaves))


def load(path: str, params_template, opt_template: AdamWState = None, *,
         cfg):
    """Restore into the port's templates (shapes and dtypes must match),
    on the template's device. Returns (params, opt_state or None, meta)."""
    device = tree_leaves(params_template)[0].device
    tree = _restore(os.path.join(path, "params.npz"),
                    params_to_jax(params_template, cfg))
    params = params_from_jax(tree, cfg, device)
    opt_state = None
    if opt_template is not None and \
            os.path.exists(os.path.join(path, "opt_state.npz")):
        step, m, v = _restore(os.path.join(path, "opt_state.npz"),
                              _opt_tree(opt_template, cfg))
        opt_state = AdamWState(torch.from_numpy(step).to(device),
                               params_from_jax(m, cfg, device),
                               params_from_jax(v, cfg, device))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, meta
