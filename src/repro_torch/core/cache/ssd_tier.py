"""SSD tier — file-backed full-model store (paper §5.4).

Every layer's neuron banks live in one ``np.memmap`` file per tensor; reads
are *real* file I/O on the container's disk. The tier exposes a pluggable
interface (`read_layer` / `read_neurons`) so alternative flash caches
(CacheLib, Kangaroo, FairyWREN — paper §5.4) could be slotted in.

Byte accounting is kept here so the transfer clock and the carbon model can
price SSD traffic.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np


class SSDTier:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._meta_path = os.path.join(root, "meta.json")
        self._meta: Dict[str, dict] = {}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._meta = json.load(f)
        self._maps: Dict[str, np.memmap] = {}
        self.bytes_read = 0
        self.bytes_written = 0
        self.reads = 0

    # ------------------------------------------------------------------
    def _key(self, layer: int, tensor: str) -> str:
        return f"L{layer:04d}.{tensor}"

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".bin")

    def write_layer(self, layer: int, banks: Dict[str, np.ndarray],
                    flush_meta: bool = True):
        """``flush_meta=False`` skips the metadata rewrite — for transient
        tenants (KV block swaps) that never reload across processes, a
        per-write O(all keys) json dump is pure overhead."""
        for tensor, arr in banks.items():
            key = self._key(layer, tensor)
            arr = np.ascontiguousarray(arr)
            mm = np.memmap(self._path(key), dtype=arr.dtype, mode="w+",
                           shape=arr.shape)
            mm[...] = arr
            mm.flush()
            self._meta[key] = {"dtype": str(arr.dtype), "shape": list(arr.shape)}
            self.bytes_written += arr.nbytes
        if flush_meta:
            self.flush_meta()

    def flush_meta(self):
        with open(self._meta_path, "w") as f:
            json.dump(self._meta, f)

    def _map(self, key: str) -> np.memmap:
        if key not in self._maps:
            m = self._meta[key]
            self._maps[key] = np.memmap(self._path(key), dtype=m["dtype"],
                                        mode="r", shape=tuple(m["shape"]))
        return self._maps[key]

    # ------------------------------------------------------------------
    def tensors_of(self, layer: int) -> List[str]:
        pre = f"L{layer:04d}."
        return [k[len(pre):] for k in self._meta if k.startswith(pre)]

    def layer_nbytes(self, layer: int) -> int:
        total = 0
        for t in self.tensors_of(layer):
            m = self._meta[self._key(layer, t)]
            total += int(np.prod(m["shape"])) * np.dtype(m["dtype"]).itemsize
        return total

    def read_layer(self, layer: int) -> Dict[str, np.ndarray]:
        out = {}
        for t in self.tensors_of(layer):
            arr = np.asarray(self._map(self._key(layer, t)))
            out[t] = arr
            self.bytes_read += arr.nbytes
            self.reads += 1
        return out

    def read_neurons(self, layer: int, tensor: str,
                     idx: Sequence[int], axis: int) -> np.ndarray:
        """Gather specific neurons straight from flash (cache-miss path)."""
        mm = self._map(self._key(layer, tensor))
        arr = np.take(mm, np.asarray(idx), axis=axis)
        self.bytes_read += arr.nbytes
        self.reads += 1
        return arr

    def delete_layer(self, layer: int, flush_meta: bool = True):
        """Remove a layer's files, metadata and cached memmaps (KV blocks
        and other transient tenants must not accumulate on flash)."""
        for t in self.tensors_of(layer):
            key = self._key(layer, t)
            self._maps.pop(key, None)
            del self._meta[key]
            try:
                os.remove(self._path(key))
            except FileNotFoundError:
                pass
        if flush_meta:
            self.flush_meta()

    def reset_stats(self):
        self.bytes_read = self.bytes_written = self.reads = 0
