"""KV-block payload support (the gate only, so far).

The reference's ``repro/core/kv_payload.py`` also slices a KV cache into
per-block host payloads for the tiered KV cache; that lands with the
server's path. The engine's constructor only needs the gate.
"""
from __future__ import annotations


def supports_payloads(cfg) -> bool:
    """Can this architecture's KV state be sliced per token block?"""
    if cfg is None or getattr(cfg, "family", "") == "audio":
        return False
    if getattr(cfg, "window_size", 0):
        return False                     # ring slots alias positions
    from repro_torch.models import transformer as T
    return all(kind == "attn" for kind in T.pattern_of(cfg))
