"""Training loop (``repro/training/train_loop.py``): a train-step factory
(``lm_loss`` under ``torch.autograd``, then AdamW) and a simple host loop.
The model runs in ``forward``'s train mode: attention through the plain
``chunked_attention`` and the FFNs as PyTorch products on every device, as
the reference trains in plain jnp (no kernel of either package has a
backward)."""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.data.pipeline import batches
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.training.optimizer import (AdamWConfig, apply_updates,
                                            init_opt_state)


def make_train_step(cfg, opt_cfg: AdamWConfig, *, remat: bool = True,
                    window: int = 0, policy=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: the loss (attention within a sliding ``window``
    where one is given, and the mesh ``policy``'s activation constraints,
    a no-op on plain tensors, as ``lm_loss`` takes them) and the gradients
    of every float leaf, then :func:`apply_updates`, which writes into
    ``params`` and the moments. ``batch`` holds tensors on the params' device.
    metrics: {"nll", "lb_loss", "loss", "grad_norm", "lr"}."""

    def train_step(params, opt_state, batch):
        trained = [t for t in tree_leaves(params) if t.is_floating_point()]
        for t in trained:
            t.requires_grad_(True)
        try:
            loss, metrics = T.lm_loss(cfg, params, batch, remat=remat,
                                      window=window, policy=policy)
            grads = dict(zip(map(id, trained), torch.autograd.grad(
                loss, trained, allow_unused=True)))
        finally:
            for t in trained:
                t.requires_grad_(False)
        # a leaf the loss does not read (an int8 bank, an unused predictor)
        # has a zero gradient, as jax.grad gives it
        grad_tree = tree_map(
            lambda p: grads.get(id(p)) if grads.get(id(p)) is not None
            else torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)
        params, opt_state, opt_metrics = apply_updates(
            params, grad_tree, opt_state, opt_cfg, cfg)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), **opt_metrics)
        return params, opt_state, metrics

    return train_step


def train(cfg, *, steps: int, batch_size: int, seq_len: int,
          opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
          dtype=torch.float32, log_every: int = 10, remat: bool = True,
          device=None):
    """Single-host training loop: the port's dense (``m2=False``) params
    from ``init_params(seed=seed)``, drawn on the CPU and moved to
    ``device`` (default cuda), so that a seed starts every device from the
    same weights; the synthetic corpus's batches of ``seed``; ``steps``
    AdamW steps. Returns (params, opt_state, history); a history entry
    (every ``log_every`` steps and the last) holds the metrics as floats,
    "step" and "wall"."""
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    params = tree_map(lambda t: t.to(device),
                      T.init_params(cfg, seed=seed, device="cpu", dtype=dtype,
                                    m2=False))
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, remat=remat)

    history = []
    it = batches(cfg, batch_size=batch_size, seq_len=seq_len, seed=seed)
    t0 = time.time()
    for i, batch in zip(range(steps), it):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"], m["wall"] = i, time.time() - t0
            history.append(m)
            print(f"step {i:5d} loss {m['loss']:.4f} "
                  f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f}")
    return params, opt_state, history
