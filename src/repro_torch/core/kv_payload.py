"""Real KV-block payloads (``repro/core/kv_payload.py``): token ranges of the
port's KV-cache dict, copied out as host numpy arrays and written back on
demand.

This is the byte-level substrate of real KV residency in the tiered
HBM→DRAM→SSD cache: demoting a block copies its token slice out of every KV
leaf into a payload dict, promoting it writes the same bytes back at the
same positions. Block-chunked prefill (``mode="prefill_resume"``) makes a
block's KV a pure function of the tokens at and before it, so a payload
taken from one request's prefill can be injected into another request's
fresh cache (the radix prefix-cache hit path), bit for bit.

The port's cache dict already has the reference's layout
(``{"pattern": [{"k", "v"}], "remainder": [], "pos"}``), so the leaves are
walked directly; payload keys are the reference's ``keystr`` strings
(``"['pattern'][0]['k']"``). Only leaves with a token axis are payloaded:
``k``/``v`` (…, S, kvH, Dh) and the kv-quant scales ``k_s``/``v_s``
(…, S, kvH). Extract, inject and scrub update the cache in place.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

#: leaf name -> token axis (negative: independent of stacked lead axes)
_TOKEN_AXIS = {"k": -3, "v": -3, "k_s": -2, "v_s": -2}


def supports_payloads(cfg) -> bool:
    """Can this architecture's KV state be sliced per token block?"""
    if cfg is None or getattr(cfg, "family", "") == "audio":
        return False
    if getattr(cfg, "window_size", 0):
        return False                     # ring slots alias positions
    from repro_torch.models import transformer as T
    return all(kind == "attn" for kind in T.pattern_of(cfg))


def _walk(tree, path: str) -> Iterator[Tuple[str, str, object]]:
    """(keystr, leaf name, leaf) in ``jax.tree_util`` flatten order: dict
    keys sorted, lists in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _walk(item, f"{path}[{i}]")
    else:
        name = path[path.rfind("[") + 2:-2] if path.endswith("']") else ""
        yield path, name, tree


def _kv_leaves(cache):
    """Yield (path_key, token_axis, leaf) for every KV leaf."""
    for key, name, leaf in _walk(cache, ""):
        ax = _TOKEN_AXIS.get(name)
        if ax is not None:
            yield key, ax, leaf


def _index(ndim: int, ax: int, start: int, stop: int,
           row: Optional[int]) -> tuple:
    """Token slice ``[start, stop)``; with ``row``, only that row of the
    batch axis (just before the token axis), kept as a length-1 axis: the
    port stacks a decode batch's rows on the cache's own batch axis, so a
    row's payload has the shape of a one-row session's."""
    idx = [slice(None)] * ndim
    idx[ax] = slice(start, stop)
    if row is not None:
        idx[ax - 1] = slice(row, row + 1)
    return tuple(idx)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def extract(cache, start: int, stop: int, *,
            row: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Copy token positions ``[start, stop)`` of every KV leaf to host numpy
    arrays. ``row`` selects one row of a stacked cache, e.g. a DecodeBatch
    member."""
    return {key: _host(leaf[_index(leaf.dim(), ax, start, stop, row)])
            for key, ax, leaf in _kv_leaves(cache)}


def inject(cache, payload: Dict[str, np.ndarray], start: int, *,
           row: Optional[int] = None):
    """Write a payload back at token position ``start``, in place; returns
    the cache. Inverse of :func:`extract`."""
    for key, ax, leaf in _kv_leaves(cache):
        if key not in payload:
            continue
        arr = np.ascontiguousarray(payload[key])
        if arr.dtype.name == "bfloat16":
            src = torch.from_numpy(arr.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            src = torch.from_numpy(arr.copy())
        stop = start + arr.shape[ax]     # negative axis: row-free payload
        leaf[_index(leaf.dim(), ax, start, stop, row)] = src.to(
            device=leaf.device, dtype=leaf.dtype)
    return cache


def scrub(cache, start: int, stop: int, *, row: Optional[int] = None):
    """Zero token positions ``[start, stop)`` of every KV leaf, in place —
    demotion really removes the bytes from the device copy, so a broken
    promotion path corrupts decode instead of silently passing."""
    for _, ax, leaf in _kv_leaves(cache):
        leaf[_index(leaf.dim(), ax, start, stop, row)] = 0
    return cache


def payload_nbytes(payload: Dict[str, np.ndarray]) -> int:
    return sum(a.nbytes for a in payload.values())


def token_nbytes(specs) -> float:
    """Real KV bytes one token pins, from a cache-spec dict
    (``T.cache_specs``, leaves with ``shape`` and ``dtype``): per KV leaf,
    total bytes / token-axis length."""
    total = 0.0
    for _, ax, leaf in _kv_leaves(specs):
        nbytes = float(np.prod(leaf.shape)) * leaf.element_size()
        total += nbytes / leaf.shape[ax]
    return total
