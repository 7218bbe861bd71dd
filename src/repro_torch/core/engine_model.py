"""Real-model execution for the serving engine (``repro/core/engine_model.py``).

``RealModelRunner`` runs prefill and greedy decode through the M2Cache
forward and surfaces per-layer active-neuron indices so the multi-level
cache manager replays *actual* predictor behaviour. The reference's
``jit``-compiled closures become plain methods: PyTorch runs eagerly.

The reference's row entry points vmap a one-row graph, so every row of a
stacked batch has its own position and its own predictor top-k. The port
runs such rows as one batch through ``forward(..., rows=True)``: per-row
positions in ``cache["pos"]`` and per-row FFN active sets, so a row's
tokens do not depend on which rows run beside it. Rows are stacked on the
cache's own batch axis, (F, B, S, kvH, Dh).

``DecodeBatch`` is the batched decode path: sessions in the same
seq-length bucket share one stacked KV cache and one forward per step.
Its row capacity grows in powers of two as the reference's does; rows
that hold no session are not computed.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T


def flatten_active_idx(cfg, aux_idx) -> List[np.ndarray]:
    """aux['active_idx'] -> flat per-layer list in layer order.

    Pattern entries are stacked (F, k); layer l = repeat*len(pat)+pos.
    """
    pat, F, rem = T.pattern_split(cfg)
    out: List[np.ndarray] = []
    pattern = [np.asarray(a.cpu()) for a in aux_idx["pattern"]]
    for r in range(F):
        for p in range(len(pat)):
            arr = pattern[p]
            out.append(arr[r] if arr.size else np.zeros((0,), np.int64))
    for a in aux_idx["remainder"]:
        a = np.asarray(a.cpu())
        out.append(a if a.size else np.zeros((0,), np.int64))
    return out


def flatten_active_idx_batched(cfg, aux_idx) -> List[np.ndarray]:
    """Per-row aux['active_idx'] -> per-layer (C, k) row-major arrays.
    Pattern entries arrive as (C, F, k), remainder as (C, k)."""
    pat, F, rem = T.pattern_split(cfg)
    out: List[np.ndarray] = []
    pattern = [np.asarray(a.cpu()) for a in aux_idx["pattern"]]
    for r in range(F):
        for p in range(len(pat)):
            arr = pattern[p]
            out.append(arr[:, r] if arr.size else
                       np.zeros((arr.shape[0], 0), np.int64))
    for a in aux_idx["remainder"]:
        a = np.asarray(a.cpu())
        out.append(a if a.size else np.zeros((a.shape[0], 0), np.int64))
    return out


# --- row scatter/gather over a cache dict whose rows sit on the batch axis


def _kv(cache):
    return cache["pattern"][0]


def _scatter_row(stack, row, i: int):
    """Write a one-row cache into row ``i`` of a stacked cache, in place."""
    for n in ("k", "v"):
        _kv(stack)[n][:, i] = _kv(row)[n][:, 0].to(_kv(stack)[n].dtype)
    stack["pos"][i] = int(row["pos"])
    return stack


def _gather_row(stack, i: int):
    """A copy of row ``i`` of a stacked cache as a one-row cache."""
    return {"pattern": [{n: _kv(stack)[n][:, i:i + 1].clone()
                         for n in ("k", "v")}],
            "remainder": [], "pos": int(stack["pos"][i])}


def _stack_rows(rows):
    """Stack one-row caches into one cache with per-row positions (the
    transient grouping the block-chunked prefill uses per dispatch;
    decode's persistent stacking lives in :class:`DecodeBatch`)."""
    return {"pattern": [{n: torch.cat([_kv(r)[n] for r in rows], dim=1)
                         for n in ("k", "v")}],
            "remainder": [],
            "pos": torch.tensor([int(r["pos"]) for r in rows],
                                dtype=torch.int64)}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RealModelRunner:
    def __init__(self, cfg, params, *, max_seq: int, dtype=torch.float32,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.dtype = dtype
        self.device = resolve_device(device)
        have = params["embed"].device
        if have.type != self.device.type:
            raise ValueError(f"params live on {have}, runner asked for "
                             f"{self.device}")
        self.last_logits = None          # (B, V) logits after generate()
        self.wall_s = {"prefill": 0.0, "decode": []}   # per-step wall seconds

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        return tokens.to(device=self.device, dtype=torch.long)

    @torch.no_grad()
    def _prefill(self, params, tokens):
        tokens = self._tokens(tokens)
        B = tokens.shape[0]
        cache = T.init_cache(self.cfg, B, max_seq=self.max_seq,
                             dtype=self.dtype, device=self.device)
        logits, cache, aux = T.forward(self.cfg, params, tokens, cache=cache,
                                       mode="prefill", m2=True)
        return logits[..., -1, :], cache, aux["active_idx"]

    @torch.no_grad()
    def _decode(self, params, cache, tok):
        logits, cache, aux = T.forward(self.cfg, params, tok, cache=cache,
                                       mode="decode", m2=True)
        return logits[..., 0, :], cache, aux["active_idx"]

    @torch.no_grad()
    def _decode_batched(self, params, stack, last):
        """One decode step of every row of a stacked cache: each row's
        greedy token from its last logits (C, V), then one forward at the
        rows' own positions. Returns (last (C, V), stack, tokens (C,),
        per-row active idx)."""
        nxt = torch.argmax(last, dim=-1)
        logits, stack, aux = T.forward(self.cfg, params, nxt[:, None],
                                       cache=stack, mode="decode", m2=True,
                                       rows=True)
        return logits[:, -1, :], stack, nxt, aux["active_idx"]

    @torch.no_grad()
    def _prefill_rows(self, params, tokens):
        """Prefill G same-width prompts (G, S), each with its own active
        sets, into one stacked cache with per-row positions."""
        tokens = self._tokens(tokens)
        G = tokens.shape[0]
        cache = T.init_cache(self.cfg, G, max_seq=self.max_seq,
                             dtype=self.dtype, device=self.device)
        cache["pos"] = torch.zeros(G, dtype=torch.int64)
        logits, cache, aux = T.forward(self.cfg, params, tokens, cache=cache,
                                       mode="prefill", m2=True, rows=True)
        return logits[:, -1, :], cache, aux["active_idx"]

    @torch.no_grad()
    def _prefill_block(self, params, cache, tokens, n_valid: int):
        """One block-chunk of one prompt: ``tokens`` (bt,) right-padded past
        ``n_valid`` is written into the cache at ``cache["pos"]`` and
        attends over the whole buffer (``mode="prefill_resume"``). The
        chunk's outputs are a pure function of the buffer below pos and the
        chunk's tokens, so a chunk recomputed from scratch and one run after
        a prefix-KV restore are bitwise identical. Pad positions write
        garbage K/V past the prompt; the causal mask hides it and decode
        overwrites it in place."""
        p0 = int(cache["pos"])
        logits, cache, aux = T.forward(self.cfg, params,
                                       self._tokens(tokens)[None],
                                       cache=cache, mode="prefill_resume",
                                       m2=True)
        cache["pos"] = p0 + int(n_valid)
        return logits[0, n_valid - 1, :], cache, aux["active_idx"]

    @torch.no_grad()
    def _prefill_block_rows(self, params, stack, tokens, n_valid):
        """:meth:`_prefill_block` for every row of a stacked cache: tokens
        (G, bt), n_valid (G,); rows may sit at different positions."""
        p0 = T.row_positions(stack, len(n_valid))
        nv = torch.as_tensor(np.asarray(n_valid), dtype=torch.int64)
        stack["pos"] = p0
        logits, stack, aux = T.forward(self.cfg, params, self._tokens(tokens),
                                       cache=stack, mode="prefill_resume",
                                       m2=True, rows=True)
        stack["pos"] = p0 + nv
        last = logits[torch.arange(len(nv), device=logits.device),
                      (nv - 1).to(logits.device)]
        return last, stack, aux["active_idx"]

    @torch.no_grad()
    def generate(self, prompts, gen_len: int
                 ) -> Tuple[np.ndarray, List[List[np.ndarray]]]:
        """Greedy decode. Returns (tokens (B, gen_len), active-idx per step)."""
        prompts = self._tokens(prompts)
        t0 = time.perf_counter()
        last, cache, _ = self._prefill(self.params, prompts)
        _sync(self.device)
        self.wall_s = {"prefill": time.perf_counter() - t0, "decode": []}
        outs, idx_steps = [], []
        for _ in range(gen_len):
            t0 = time.perf_counter()
            nxt = torch.argmax(last, dim=-1)
            outs.append(nxt.to(torch.int32).cpu().numpy())
            last, cache, aux_idx = self._decode(self.params, cache,
                                                nxt[:, None])
            idx_steps.append(flatten_active_idx(self.cfg, aux_idx))
            self.wall_s["decode"].append(time.perf_counter() - t0)
        self.last_logits = last
        return np.stack(outs, axis=-1), idx_steps


class DecodeBatch:
    """Persistent stacked decode state for one seq-length bucket.

    Sessions join by scattering their one-row KV cache and last-token
    logits into a free row of the stacked cache; they leave by gathering
    the row back out (so a preempted session resumes from exactly the state
    it left with). The row capacity is a power of two, as the reference's
    is; rows that hold no session are not computed, and modeled cost is
    charged for members only, by the engine.
    """

    def __init__(self, runner: "RealModelRunner"):
        self.runner = runner
        self.capacity = 0
        self.rows: List[Optional[object]] = []     # row -> DecodeSession
        self.stack = None                          # stacked cache dict
        self.last = None                           # (C, V) last logits

    @property
    def members(self) -> List[object]:
        return [s for s in self.rows if s is not None]

    def _ensure_capacity(self, n: int):
        cap = 1
        while cap < n:
            cap *= 2
        if cap <= self.capacity:
            return
        r = self.runner
        grown = T.init_cache(r.cfg, cap, max_seq=r.max_seq, dtype=r.dtype,
                             device=r.device)
        grown["pos"] = torch.zeros(cap, dtype=torch.int64)
        last = torch.zeros((cap, r.cfg.vocab_size), dtype=torch.float32,
                           device=r.device)
        if self.stack is not None:
            c = self.capacity
            for n in ("k", "v"):
                _kv(grown)[n][:, :c] = _kv(self.stack)[n]
            grown["pos"][:c] = self.stack["pos"]
            last[:c] = self.last
        self.stack, self.last = grown, last
        self.rows.extend([None] * (cap - self.capacity))
        self.capacity = cap

    def join(self, sess):
        """Pack one prefilled session into a free row (scatter)."""
        if sess._batch is self:
            return
        assert sess._batch is None, "session already in another batch"
        try:
            i = self.rows.index(None)
        except ValueError:
            self._ensure_capacity(self.capacity + 1)
            i = self.rows.index(None)
        _scatter_row(self.stack, sess.cache, i)
        self.last[i] = sess.last[0].to(self.last.dtype)
        # the row is now the live state: drop the per-session copies so a
        # batch member neither doubles its KV footprint nor exposes stale
        # pre-join state (evict() restores both from the row)
        sess.cache = None
        sess.last = None
        self.rows[i] = sess
        sess._batch = self
        sess._row = i

    def evict(self, sess):
        """Unpack one session's row back into the session (gather), so a
        preempted request can later resume — possibly in another row."""
        assert sess._batch is self
        i = sess._row
        sess.cache = _gather_row(self.stack, i)
        sess.last = self.last[i][None].clone()
        self.rows[i] = None
        sess._batch = None
        sess._row = -1

    def sync(self, members: List[object]):
        """Reconcile rows with this step's decode set: sessions that left
        the continuous batch (finished/preempted) are gathered out first,
        then joiners are scattered in — eager eviction keeps a leaver's
        row from being stepped (and corrupted) after its departure."""
        present = {id(s) for s in members}
        for s in list(self.rows):
            if s is not None and id(s) not in present:
                self.evict(s)
        n = sum(1 for s in members if s._batch is not self)
        self._ensure_capacity(len(self.members) + n)
        for s in members:
            self.join(s)

    def step(self, params) -> Tuple[np.ndarray, dict]:
        """One decode forward over the occupied rows. Returns the (C,)
        greedy tokens the step consumed and the per-row active-idx aux,
        both over all C rows (rows without a session read 0)."""
        occ = [i for i, s in enumerate(self.rows) if s is not None]
        if len(occ) == self.capacity:
            self.last, self.stack, nxt, aux = self.runner._decode_batched(
                params, self.stack, self.last)
            return nxt.cpu().numpy(), aux
        sel = torch.tensor(occ, dtype=torch.int64)
        sel_dev = sel.to(self.last.device)
        sub = {"pattern": [{n: _kv(self.stack)[n].index_select(1, sel_dev)
                            for n in ("k", "v")}],
               "remainder": [], "pos": self.stack["pos"][sel]}
        last, sub, nxt, aux = self.runner._decode_batched(
            params, sub, self.last.index_select(0, sel_dev))
        for n in ("k", "v"):
            _kv(self.stack)[n].index_copy_(1, sel_dev, _kv(sub)[n])
        self.stack["pos"][sel] = sub["pos"]
        self.last.index_copy_(0, sel_dev, last)
        tokens = np.zeros(self.capacity, np.int64)
        tokens[occ] = nxt.cpu().numpy()
        full = {"pattern": [], "remainder": []}
        for a in aux["pattern"]:
            z = torch.zeros((self.capacity,) + tuple(a.shape[1:]),
                            dtype=a.dtype, device=a.device)
            z[sel_dev] = a
            full["pattern"].append(z)
        return tokens, full


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy with the tensor's exact bytes (numpy has no bf16: bf16 is
    written as its uint16 bit pattern)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def extract_layer_banks(cfg, params) -> List[dict]:
    """Per-layer quantized neuron banks (numpy) for the SSD tier, in layer
    order."""
    return [{k: _to_numpy(v) for k, v in layer["ffn"]["banks"].items()}
            for layer in params["layers"]]
