"""Step functions, input specs and shardings for every (arch x input shape)
(``repro/launch/steps.py``).

``build_case`` returns the step callable, its inputs as tensors on the
``meta`` device (shapes and dtypes, nothing allocated) and, given a
``DeviceMesh``, the PartitionSpec trees of its inputs and outputs under the
reference's ``ShardingPolicy``: the train step (``lm_loss``, then AdamW)
for ``train_4k``, a prefill step for ``prefill_32k`` and a serve step (one
token against a ``seq_len`` KV cache) for the decode shapes.
``long_500k`` gives an attention model without a window of its own a
sliding window of ``LONG_CONTEXT_WINDOW`` positions, whose cache is a ring
of that many slots. With a mesh the step passes the policy to the model,
whose activation constraints then apply to DTensor inputs
(``launch/dryrun.py`` distributes the args by ``in_shardings``); on plain
tensors the step runs as without one, on the card its inputs lie on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config
from repro_torch.models import transformer as T
from repro_torch.sharding import P, ShardingPolicy
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            init_opt_state)
from repro_torch.training.train_loop import make_train_step

LONG_CONTEXT_WINDOW = 8192


@dataclasses.dataclass
class Case:
    name: str
    fn: Any                      # the step callable
    args: tuple                  # tensors on the meta device
    donate_argnums: tuple        # the args the step writes in place
    meta: dict
    in_shardings: Any = None     # PartitionSpec trees of the args (a mesh)
    out_shardings: Any = None    # ... and of the outputs
    policy: Optional[ShardingPolicy] = None


def _window_for(cfg, shape: InputShape) -> int:
    """Sliding-window override for long-context decode on quadratic archs."""
    if shape.name == "long_500k" and cfg.num_heads and not cfg.window_size:
        return LONG_CONTEXT_WINDOW
    return 0


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _sharded_zeros(meta_tree, spec_tree, policy):
    """A tree of zero DTensors of ``meta_tree``'s shapes, each device
    making its own block (no collective); a non-tensor leaf as it is."""
    from torch.distributed.tensor import zeros
    if isinstance(meta_tree, dict):
        return {k: _sharded_zeros(v, spec_tree[k], policy)
                for k, v in meta_tree.items()}
    if isinstance(meta_tree, list):
        return [_sharded_zeros(v, s, policy)
                for v, s in zip(meta_tree, spec_tree)]
    if not isinstance(meta_tree, torch.Tensor):
        return meta_tree
    return zeros(meta_tree.shape, dtype=meta_tree.dtype,
                 device_mesh=policy.mesh,
                 placements=policy.placements(spec_tree))


def batch_specs(cfg, shape: InputShape, policy=None, *,
                dtype=torch.float32) -> dict:
    """name -> (meta tensor, PartitionSpec or None without a ``policy``):
    the tokens, one a row for a decode shape, else ``seq_len`` positions,
    of which a config with prefix embeddings gives up to a quarter to the
    (vlm/audio) prefix; batch over ("pod", "data")."""
    B = shape.global_batch
    n_prefix = 0
    if cfg.num_prefix_embeddings and shape.kind != "decode":
        n_prefix = min(cfg.num_prefix_embeddings, shape.seq_len // 4)
    s_tok = 1 if shape.kind == "decode" else shape.seq_len - n_prefix

    def spec(sh):
        if policy is None:
            return None
        return policy.spec(sh, ("pod", "data"), *[None] * (len(sh) - 1))
    if cfg.family == "audio":
        tok_shape = (B, cfg.num_codebooks, s_tok)
    else:
        tok_shape = (B, s_tok)
    out = {"tokens": (_meta(tok_shape, torch.int32), spec(tok_shape))}
    if n_prefix:
        pshape = (B, n_prefix, cfg.d_model)
        out["prefix"] = (_meta(pshape, dtype), spec(pshape))
    return out


def build_case(arch: str, shape_name: str, mesh=None, *,
               variant: str = "dense", dtype=torch.float32, fsdp: bool = True,
               remat: bool = True, pod_fsdp: bool = False,
               shard_kv_seq: Optional[bool] = None,
               expert_data_shard: bool = False, kv_quant: bool = False,
               tiny: bool = False, num_layers: Optional[int] = None) -> Case:
    """The step of ``arch`` at ``INPUT_SHAPES[shape_name]``: ``variant``
    "m2" serves with the M2Cache FFN where the config has one (training
    always runs the dense FFN); ``kv_quant`` an int8 K/V cache. ``dtype``
    (fp32, or bf16 as the reference's default) is the weights', the
    prefix's and the cache's; vectors, norms, scales and the predictor stay
    fp32, as the reference's param specs keep them. ``mesh`` (a ``DeviceMesh``
    with axes among "pod", "data", "model") and the policy's knobs give
    ``in_shardings``/``out_shardings`` (launch/steps.py:78-198);
    ``shard_kv_seq`` defaults to on for the decode shapes. ``num_layers``
    cuts the config's depth (the dry run's trip-count weighting)."""
    cfg = get_config(arch, tiny=tiny)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    shape = INPUT_SHAPES[shape_name]
    m2 = variant == "m2" and cfg.m2_enabled and shape.kind != "train"
    if shard_kv_seq is None:
        shard_kv_seq = shape.kind == "decode"
    policy = None if mesh is None else ShardingPolicy(
        mesh, fsdp=fsdp, pod_fsdp=pod_fsdp, shard_kv_seq=shard_kv_seq,
        expert_data_shard=expert_data_shard)
    window = _window_for(cfg, shape)
    p_abs = T.abstract_params(cfg, dtype=dtype, m2=m2)
    bspecs = batch_specs(cfg, shape, policy, dtype=dtype)
    batch_abs = {k: v[0] for k, v in bspecs.items()}
    name = f"{arch}|{shape_name}|{variant}"
    meta = {"arch": arch, "shape": shape_name, "variant": variant,
            "kind": shape.kind, "window": window, "kv_quant": kv_quant,
            "chips": 1 if mesh is None else int(mesh.size()), "m2": m2}
    case = dict(name=name, meta=meta, policy=policy)
    if policy is not None:
        p_spec = T.param_shardings(cfg, policy, dtype=dtype, m2=m2)
        batch_spec = {k: v[1] for k, v in bspecs.items()}

    if shape.kind == "train":
        train_step = make_train_step(cfg, AdamWConfig(), remat=remat,
                                     window=window, policy=policy)
        if policy is not None:
            opt_spec = AdamWState(step=P(), m=p_spec, v=p_spec)
            metrics = {k: P() for k in ("nll", "lb_loss", "loss",
                                        "grad_norm", "lr")}
            case.update(in_shardings=(p_spec, opt_spec, batch_spec),
                        out_shardings=(p_spec, opt_spec, metrics))
        return Case(fn=train_step,
                    args=(p_abs, init_opt_state(p_abs), batch_abs),
                    donate_argnums=(0, 1), **case)

    cache_len, B = shape.seq_len, shape.global_batch
    if policy is not None:
        cache_spec = T.cache_shardings(cfg, policy, B, cache_len,
                                       window=window, dtype=dtype,
                                       kv_quant=kv_quant)
        logit_shape = ((B, cfg.num_codebooks, cfg.vocab_size)
                       if cfg.family == "audio" else (B, cfg.vocab_size))
        logits_spec = policy.spec(logit_shape, ("pod", "data"))
    if shape.kind == "prefill":

        def prefill_step(params, batch):
            from torch.distributed.tensor import DTensor
            if policy is not None and isinstance(params["embed"], DTensor):
                cache = _sharded_zeros(T.cache_specs(
                    cfg, B, cache_len, window=window, dtype=dtype,
                    kv_quant=kv_quant), cache_spec, policy)
            else:
                cache = T.init_cache(cfg, B, cache_len, window=window,
                                     dtype=dtype, kv_quant=kv_quant,
                                     device=params["embed"].device)
            logits, cache, _ = T.forward(
                cfg, params, batch["tokens"], prefix=batch.get("prefix"),
                cache=cache, mode="prefill", window=window, m2=m2,
                policy=policy)
            return logits[..., -1, :], cache

        if policy is not None:
            case.update(in_shardings=(p_spec, batch_spec),
                        out_shardings=(logits_spec, cache_spec))
        return Case(fn=prefill_step, args=(p_abs, batch_abs),
                    donate_argnums=(), **case)

    def serve_step(params, cache, batch):
        logits, cache, _ = T.forward(cfg, params, batch["tokens"],
                                     cache=cache, mode="decode",
                                     window=window, m2=m2, policy=policy)
        return logits[..., 0, :], cache

    cache_abs = T.cache_specs(cfg, B, cache_len, window=window, dtype=dtype,
                              kv_quant=kv_quant)
    if policy is not None:
        case.update(in_shardings=(p_spec, cache_spec,
                                  {"tokens": batch_spec["tokens"]}),
                    out_shardings=(logits_spec, cache_spec))
    return Case(fn=serve_step,
                args=(p_abs, cache_abs, {"tokens": batch_abs["tokens"]}),
                donate_argnums=(1,), **case)


def input_specs(arch: str, shape_name: str, mesh=None, **kw) -> tuple:
    """Meta-tensor stand-ins for every input of this (arch, shape)'s step:
    no device allocation."""
    return build_case(arch, shape_name, mesh, **kw).args
