"""Two-level DRAM cache (paper §5.4, Fig. 8).

*Fixed area*: the first ``n_fixed`` layers are pinned — they are needed at
the start of every token's forward pass, so re-loading them each token would
waste SSD bandwidth.

*Dynamic area*: FIFO over the layers ahead of the compute front; capacity-
bounded in bytes. The preloader inserts layer ℓ+lookahead while layer ℓ
computes; eviction pops the oldest non-fixed layer.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict



class DRAMCache:
    def __init__(self, capacity_bytes: int, n_fixed: int = 2,
                 byte_scale: float = 1.0):
        self.capacity = int(capacity_bytes)
        self.n_fixed = n_fixed
        # analytic mode stores size-capped surrogate files; byte_scale maps
        # file bytes back to the real model's bytes for capacity/accounting
        self.byte_scale = byte_scale
        self.fixed: Dict[int, dict] = {}
        self.dynamic: "OrderedDict[int, dict]" = OrderedDict()
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    def _nbytes(self, banks: dict) -> int:
        return int(sum(a.nbytes for a in banks.values()) * self.byte_scale)

    def __contains__(self, layer: int) -> bool:
        return layer in self.fixed or layer in self.dynamic

    def get(self, layer: int) -> Optional[dict]:
        if layer in self.fixed:
            self.hits += 1
            return self.fixed[layer]
        if layer in self.dynamic:
            self.hits += 1
            return self.dynamic[layer]
        self.misses += 1
        return None

    def insert(self, layer: int, banks: dict) -> int:
        """Insert a layer; returns bytes evicted to make room."""
        if layer in self:
            return 0
        nb = self._nbytes(banks)
        evicted = 0
        if layer < self.n_fixed:
            self.fixed[layer] = banks
            self.used_bytes += nb
            return 0
        while self.used_bytes + nb > self.capacity and self.dynamic:
            _, old = self.dynamic.popitem(last=False)     # FIFO
            ob = self._nbytes(old)
            self.used_bytes -= ob
            evicted += ob
            self.evictions += 1
        self.dynamic[layer] = banks
        self.used_bytes += nb
        return evicted

    def drop(self, layer: int):
        if layer in self.dynamic:
            self.used_bytes -= self._nbytes(self.dynamic.pop(layer))

    @property
    def hit_ratio(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def reset_stats(self):
        self.hits = self.misses = self.evictions = 0
