"""Radix-tree prefix cache: KV reuse across requests over the tiered
HBM→DRAM→SSD hierarchy.

Chat-style traffic repeats prompt prefixes constantly — a hot system
prompt is shared by thousands of requests, a multi-turn conversation
re-sends its whole history every turn. Recomputing that KV state per
request wastes exactly the resource M2Cache's hierarchy exists to
stretch. This module deduplicates prompt KV at **block granularity**:

* a **radix tree** keyed on token-ID prefixes. Each node's edge is a
  run of whole KV blocks (``block_tokens`` tokens each); children are
  keyed by their first block's token tuple, so lookup walks block by
  block and never compares partial blocks. A prompt "hits" the tokens
  of every node whose *entire* edge it matches (partial-edge overlap is
  not counted — a later insert that diverges mid-edge splits the node,
  after which the shared half becomes independently matchable);
* **refcounted node ownership of TieredKVCache block ranges**: every
  node owns its edge's blocks under a private (negative) rid in the
  same :class:`~repro_torch.serving.kv_cache.TieredKVCache` that pages
  request KV. While any admitted request *locks* a node, its rid is
  ``pin()``-ned — the blocks cannot be evicted from HBM mid-decode.
  When the last locker releases, the node unpins: a hot system-prompt
  prefix stays in HBM, warm conversation histories age to DRAM, and
  cold prefixes demote all the way to flash under the normal LRU +
  transfer-clock pricing. A later hit pays ``ensure_resident`` (modeled
  PCIe/NVMe seconds) instead of prefill recompute — the tiered-reuse
  trade at the heart of the design;
* **copy-on-write forks**: shared blocks are immutable. A request that
  diverges from a cached prefix computes fresh blocks for its suffix
  under its own rid (never writing shared state); when its prefill
  completes it donates the *full prompt blocks* past the matched point
  back to the tree via ``TieredKVCache.adopt_blocks`` (an ownership
  move, not a copy — the KV bytes stay where they are). Divergence
  inside an existing edge splits the node at the matched block
  boundary, partitioning its block range between parent and child;
* **carbon-aware admission**: caching is storage — it spends DRAM/SSD
  residency (and displacement pressure) now to avoid prefill compute
  later. When a :class:`~repro_torch.core.carbon.CarbonIntensityTrace` says
  the grid is dirty *now* but a window below the threshold opens within
  ``defer_horizon_s``, recompute-later is greener than store-now and
  the insert is skipped (the same guardrail pattern as
  ``policy.CarbonAwarePolicy``: a grid that never improves is no reason
  to skip caching);
* **LRU reclaim**: ``capacity_tokens`` bounds the tree. Over budget,
  unlocked *leaf* nodes are freed coldest-first (``kv.free`` releases
  their blocks from every tier); locked nodes and interior nodes with
  surviving children are never reclaimed.

Full-prompt matches are capped one block short of the prompt length so
at least one suffix token is always recomputed — the engine needs the
last position's logits to start decoding (the standard paged-prefix
rule).

All "seconds" charged by this module come from ``TieredKVCache`` calls
the *scheduler* makes (``ensure_resident`` on hit, normal paging on
demotion); the tree itself is bookkeeping and charges nothing.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.carbon import CarbonIntensityTrace
# payload_checksum moved to faults.py (shared with TieredKVCache's
# demote/promote verification); re-exported here for back-compat
from repro_torch.serving.faults import payload_checksum  # noqa: F401
from repro_torch.serving.kv_cache import TieredKVCache

BlockKey = Tuple[int, ...]

#: on-disk tree format. v2 added per-payload checksums + this version
#: handshake; load() refuses anything else (v1 trees predate both and
#: cannot be verified — recomputing their prefixes is always safe,
#: serving silently corrupted KV never is).
PERSIST_FORMAT_VERSION = 2


@dataclasses.dataclass
class RadixNode:
    """One edge of the radix tree: a run of whole KV blocks.

    Two reference sets with different lifetimes: ``holders`` are every
    request holding a ref (admission → finish, surviving preemption) —
    they protect the node from reclaim; ``lockers`` ⊆ holders are the
    *running* holders — they pin the node's blocks in HBM. Preemption
    moves a rid out of ``lockers`` but never out of ``holders``.
    """
    rid: int                                   # TieredKVCache rid (< 0)
    blocks: List[BlockKey]                     # edge token content
    parent: Optional["RadixNode"] = None
    children: Dict[BlockKey, "RadixNode"] = \
        dataclasses.field(default_factory=dict)
    holders: set = dataclasses.field(default_factory=set)
    lockers: set = dataclasses.field(default_factory=set)
    last_used: float = 0.0                     # modeled s (LRU reclaim)

    @property
    def ntokens(self) -> int:
        return sum(len(b) for b in self.blocks)

    def is_leaf(self) -> bool:
        return not self.children


@dataclasses.dataclass
class MatchResult:
    hit_tokens: int                            # whole-block matched tokens
    nodes: List[RadixNode]                     # fully-matched path nodes


class PrefixCache:
    """Radix-tree KV prefix cache over one :class:`TieredKVCache`.

    The scheduler drives it per request: :meth:`match` (size the KV
    admission check), :meth:`lock` (take refs on the hit path at
    admission), :meth:`insert` (donate the finished prefill's prompt
    blocks), :meth:`suspend`/:meth:`resume` (preemption unpins/repins
    without dropping refs), :meth:`release` (drop refs at finish).
    """

    def __init__(self, kv: TieredKVCache, *,
                 capacity_tokens: int = 65536,
                 carbon_trace: Optional[CarbonIntensityTrace] = None,
                 carbon_threshold_g_kwh: float = 300.0,
                 defer_horizon_s: float = 1800.0,
                 insert_precision: Optional[str] = None):
        self.kv = kv
        self.block_tokens = kv.block_tokens
        self.capacity_tokens = int(capacity_tokens)
        self.carbon_trace = carbon_trace
        self.carbon_threshold = carbon_threshold_g_kwh
        self.defer_horizon_s = defer_horizon_s
        # storage precision for donated prefix KV (quantized KV tiers
        # only): "int8" / "int4" fix it, "carbon" picks per insert from
        # the grid — a clean window keeps int8 (cheap storage, low
        # drift), a dirty one drops to int4 (max stretch per stored
        # byte). None stores whatever precision the donor blocks carry.
        if insert_precision not in (None, "int8", "int4", "carbon"):
            raise ValueError(
                f"insert_precision must be None, 'int8', 'int4' or "
                f"'carbon', got {insert_precision!r}")
        self.insert_precision = insert_precision
        self.root = RadixNode(rid=0, blocks=[])
        self._locked: Dict[int, List[RadixNode]] = {}   # rid -> path nodes
        self._next_node_rid = -2            # negative: never a request rid
        self.cached_tokens = 0
        self.nodes = 0
        # lifetime counters (benchmarks snapshot/diff them per run)
        self.lookups = 0
        self.hit_requests = 0
        self.hit_tokens_total = 0
        self.lookup_tokens_total = 0
        self.inserted_tokens = 0
        self.insert_skips_carbon = 0
        self.inserts_int8 = 0
        self.inserts_int4 = 0
        self.reclaimed_tokens = 0
        self.splits = 0
        self.load_rejects = 0
        self.invalidations = 0
        self.invalidated_tokens = 0
        # obs hook (attach_obs): None -> zero-cost no-ops
        self._obs_trace = None
        self._obs_clock = None

    # ------------------------------------------------------------------
    def attach_obs(self, trace, clock=None):
        """Emit hit/miss/insert/reclaim instants on the ``prefix`` track
        of ``trace`` (a :class:`~repro.obs.TraceRecorder`). ``clock``
        returns the current raw modeled time (the tree's own ``now``
        arguments are run-rebased and would mis-place events)."""
        self._obs_trace = trace
        self._obs_clock = clock

    def _obs(self, name: str, **args):
        if self._obs_trace is None:
            return
        t = self._obs_clock() if self._obs_clock is not None else None
        self._obs_trace.instant("prefix", name, t, **args)

    # ------------------------------------------------------------------
    def _query_blocks(self, tokens: Tuple[int, ...]) -> List[BlockKey]:
        """Whole matchable blocks of a prompt, capped one block short of
        the full length so ≥1 suffix token is always recomputed."""
        bt = self.block_tokens
        usable = ((len(tokens) - 1) // bt) * bt if tokens else 0
        return [tuple(tokens[i:i + bt]) for i in range(0, usable, bt)]

    def _walk(self, qb: List[BlockKey]) -> Tuple[List[RadixNode], int, int]:
        """Walk fully-matched nodes. Returns (path, matched_blocks,
        partial) where ``partial`` is how many leading blocks of the
        *next* child's edge also match (0 = clean divergence)."""
        path: List[RadixNode] = []
        node, i = self.root, 0
        while i < len(qb):
            child = node.children.get(qb[i])
            if child is None:
                return path, i, 0
            j = 0
            while j < len(child.blocks) and i + j < len(qb) \
                    and child.blocks[j] == qb[i + j]:
                j += 1
            if j < len(child.blocks):
                return path, i, j            # ends inside child's edge
            path.append(child)
            i += j
            node = child
        return path, i, 0

    # ------------------------------------------------------------------
    def match(self, tokens: Tuple[int, ...]) -> MatchResult:
        """Pure lookup (no refs): whole-block hit length + path nodes."""
        path, matched, _ = self._walk(self._query_blocks(tokens))
        return MatchResult(hit_tokens=matched * self.block_tokens,
                           nodes=path)

    def lock(self, rid: int, tokens: Tuple[int, ...], *,
             now: float = 0.0) -> MatchResult:
        """Match and take refs on the hit path for ``rid``: each path
        node gains a locker and its blocks are pinned against HBM
        eviction until :meth:`release`."""
        assert rid not in self._locked, f"rid {rid} already holds locks"
        m = self.match(tokens)
        self._locked[rid] = list(m.nodes)
        for node in m.nodes:
            if not node.lockers:
                self.kv.pin(node.rid)
            node.holders.add(rid)
            node.lockers.add(rid)
            node.last_used = max(node.last_used, now)
        self.lookups += 1
        self.lookup_tokens_total += len(tokens)
        if m.hit_tokens:
            self.hit_requests += 1
            self.hit_tokens_total += m.hit_tokens
        self._obs("hit" if m.hit_tokens else "miss", rid=rid,
                  hit_tokens=m.hit_tokens, lookup_tokens=len(tokens),
                  path_nodes=len(m.nodes))
        return m

    def node_rids(self, rid: int) -> List[int]:
        """KV rids of the nodes ``rid`` currently locks (root→leaf
        order) — what the scheduler must keep resident for its decode."""
        return [n.rid for n in self._locked.get(rid, [])]

    def release(self, rid: int, *, now: float = 0.0):
        """Drop ``rid``'s refs; nodes with no lockers left unpin (their
        blocks re-enter normal LRU aging toward DRAM/SSD), nodes with no
        holders left become reclaimable."""
        for node in self._locked.pop(rid, []):
            node.holders.discard(rid)
            node.lockers.discard(rid)
            node.last_used = max(node.last_used, now)
            if not node.lockers:
                self.kv.unpin(node.rid)

    def suspend(self, rid: int):
        """Preemption: unpin ``rid``'s path. The rid stays a *holder* of
        every path node — a parked request's prefix may age out of HBM
        but can never be reclaimed out from under it."""
        for node in self._locked.get(rid, []):
            node.lockers.discard(rid)
            if not node.lockers:
                self.kv.unpin(node.rid)

    def resume(self, rid: int):
        """Resume after preemption: re-pin the held path."""
        for node in self._locked.get(rid, []):
            if not node.lockers:
                self.kv.pin(node.rid)
            node.lockers.add(rid)

    # ------------------------------------------------------------------
    def _should_cache(self, now: float) -> bool:
        """Carbon-aware admission: skip caching when the grid is dirty
        *now* and a cleaner window inside ``defer_horizon_s`` makes
        recompute-later greener than store-now."""
        if self.carbon_trace is None:
            return True
        if self.carbon_trace.intensity_at(now) <= self.carbon_threshold:
            return True
        return self.carbon_trace.next_window_below(
            now, self.carbon_threshold,
            horizon_s=self.defer_horizon_s) is None

    def _pick_precision(self, now: float) -> Optional[str]:
        """Storage precision for this insert. ``"carbon"`` mode reads
        the grid: a clean window affords int8 (half the storage, low
        drift), a dirty one drops to int4 — the prefix is stored at a
        quarter width so the carbon spent keeping it resident is
        minimal. Without a trace, int8 is the safe default."""
        if self.insert_precision != "carbon":
            return self.insert_precision
        if self.carbon_trace is None:
            return "int8"
        clean = self.carbon_trace.intensity_at(now) <= self.carbon_threshold
        return "int8" if clean else "int4"

    def _split(self, node: RadixNode, at_blocks: int) -> RadixNode:
        """Copy-on-write fork: split ``node``'s edge after ``at_blocks``
        blocks. ``node`` keeps the head; a new child takes the tail
        (blocks partitioned via ``adopt_blocks`` — no bytes move) along
        with the old children, holders and lockers (every holder of
        ``node`` matched its whole edge, so it holds the tail too —
        including preempted holders, whose resume must re-pin both
        halves)."""
        assert 0 < at_blocks < len(node.blocks)
        tail = RadixNode(rid=self._next_node_rid,
                         blocks=node.blocks[at_blocks:], parent=node,
                         children=node.children,
                         holders=set(node.holders),
                         lockers=set(node.lockers),
                         last_used=node.last_used)
        self._next_node_rid -= 1
        for child in tail.children.values():
            child.parent = tail
        self.kv.adopt_blocks(node.rid, tail.rid,
                             len(node.blocks) - at_blocks,
                             start_block=at_blocks)
        node.blocks = node.blocks[:at_blocks]
        node.children = {tail.blocks[0]: tail}
        for r in tail.holders:
            held = self._locked[r]
            held.insert(held.index(node) + 1, tail)
        if tail.lockers:
            self.kv.pin(tail.rid)
        self.nodes += 1
        self.splits += 1
        return tail

    def insert(self, rid: int, tokens: Tuple[int, ...], *,
               prefix_hit: int, now: float = 0.0) -> int:
        """Donate ``rid``'s freshly-prefilled full prompt blocks to the
        tree. ``prefix_hit`` is the whole-block hit the request was
        admitted with — its own KV blocks cover ``[prefix_hit, ...)``.
        New nodes are locked for ``rid`` (the request keeps reading the
        donated blocks until it finishes). Returns donated tokens."""
        if not self._should_cache(now):
            self.insert_skips_carbon += 1
            self._obs("insert_skip_carbon", rid=rid)
            return 0
        qb = self._query_blocks(tokens)
        path, matched, partial = self._walk(qb)
        if partial:
            # divergence inside an edge: fork at the matched boundary so
            # the shared head becomes matchable on its own
            child = path[-1].children[qb[matched]] if path \
                else self.root.children[qb[matched]]
            self._split(child, partial)
            path.append(child)
            matched += partial
        donate_from = matched * self.block_tokens
        # the tree may have grown past our admission-time hit (another
        # request inserted the same prefix first); our duplicate blocks
        # for [prefix_hit, donate_from) stay owned by the request
        if donate_from < prefix_hit or matched >= len(qb):
            return 0
        nblocks = len(qb) - matched
        start_block = (donate_from - prefix_hit) // self.block_tokens
        node = RadixNode(rid=self._next_node_rid, blocks=qb[matched:],
                         parent=path[-1] if path else self.root,
                         last_used=now)
        self._next_node_rid -= 1
        # real KV residency: capture host copies of the donated blocks'
        # actual tensor bytes (device_get from the donor's cache) before
        # ownership moves — these are what a later hit restores, and what
        # save() persists to flash. With quantized tiers the host master
        # is encoded at the (possibly carbon-chosen) insert precision.
        prec = self._pick_precision(now)
        self.kv.materialize(rid, start_block, nblocks, precision=prec)
        if prec == "int8":
            self.inserts_int8 += 1
        elif prec == "int4":
            self.inserts_int4 += 1
        self.kv.adopt_blocks(rid, node.rid, nblocks,
                             start_block=start_block)
        node.parent.children[node.blocks[0]] = node
        self.nodes += 1
        ntok = node.ntokens
        self.cached_tokens += ntok
        self.inserted_tokens += ntok
        # the donor keeps reading these blocks: hold + pin immediately
        node.holders.add(rid)
        node.lockers.add(rid)
        self._locked.setdefault(rid, []).append(node)
        self.kv.pin(node.rid)
        self._obs("insert", rid=rid, node_rid=node.rid, tokens=ntok,
                  precision=prec)
        self._reclaim(now)
        return ntok

    # ------------------------------------------------------------------
    def invalidate(self, node_rid: int, *, now: float = 0.0) -> int:
        """Poisoned-subtree recovery (docs/RELIABILITY.md): the node
        owning KV rid ``node_rid`` lost a block payload unrecoverably,
        so the node *and every descendant* (their KV extends the lost
        prefix — unusable without it) leave the tree. Holders' lock
        lists are scrubbed so suspend/resume/release never touch the
        freed rids; future lookups miss and recompute, which is always
        safe. Returns the invalidated token count."""
        target = None
        stack = [self.root]
        while stack and target is None:
            n = stack.pop()
            for c in n.children.values():
                if c.rid == node_rid:
                    target = c
                    break
                stack.append(c)
        if target is None:
            return 0
        del target.parent.children[target.blocks[0]]
        freed = 0
        stack = [target]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.kv.free(n.rid)              # drops pin + every tier
            for r in list(n.holders):
                held = self._locked.get(r)
                if held is not None and n in held:
                    held.remove(n)
            freed += n.ntokens
            self.nodes -= 1
        self.cached_tokens -= freed
        self.invalidations += 1
        self.invalidated_tokens += freed
        self._obs("invalidate", node_rid=node_rid, tokens=freed)
        return freed

    # ------------------------------------------------------------------
    def _reclaim(self, now: float):
        """Free coldest unheld leaves until under ``capacity_tokens``.
        Nodes with any holder — running *or preempted* — are immune.
        One tree traversal seeds a min-heap of candidates; freeing a
        leaf may expose its parent, which re-enters the heap."""
        if self.cached_tokens <= self.capacity_tokens:
            return
        heap = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self.root and not node.holders \
                    and node.is_leaf():
                heapq.heappush(heap, (node.last_used, id(node), node))
        while self.cached_tokens > self.capacity_tokens and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            self.kv.free(victim.rid)
            del parent.children[victim.blocks[0]]
            self.cached_tokens -= victim.ntokens
            self.reclaimed_tokens += victim.ntokens
            self._obs("reclaim", node_rid=victim.rid,
                      tokens=victim.ntokens)
            self.nodes -= 1
            if parent is not self.root and not parent.holders \
                    and parent.is_leaf():
                heapq.heappush(heap, (parent.last_used, id(parent),
                                      parent))

    # ------------------------------------------------------------------
    # flash persistence: the tree survives server restarts.
    #
    # Crash consistency (docs/RELIABILITY.md): every save is an atomic
    # *epoch* — the whole tree (structure + payload files) is written
    # into ``<dir>/.tmp-epoch-N`` and then renamed to
    # ``<dir>/epoch-N`` in one directory rename. A crash mid-save
    # leaves only a ``.tmp-*`` directory (cleaned up by the next save),
    # never a half-written epoch; load() takes the newest epoch that
    # fully verifies and falls back to older ones, so the worst a crash
    # costs is one save interval of tree growth.

    @staticmethod
    def _epoch_dirs(dir_path: str) -> List[str]:
        """Epoch subdirectories of a save root, oldest → newest."""
        import os
        import re
        if not os.path.isdir(dir_path):
            return []
        found = []
        for name in os.listdir(dir_path):
            m = re.fullmatch(r"epoch-(\d+)", name)
            if m and os.path.isdir(os.path.join(dir_path, name)):
                found.append((int(m.group(1)),
                              os.path.join(dir_path, name)))
        return [p for _, p in sorted(found)]

    @classmethod
    def latest_epoch_dir(cls, dir_path: str) -> Optional[str]:
        """Newest epoch directory under ``dir_path``; the root itself
        when it holds a legacy flat (pre-epoch) save; None when there is
        nothing to load."""
        import os
        epochs = cls._epoch_dirs(dir_path)
        if epochs:
            return epochs[-1]
        if os.path.exists(os.path.join(dir_path, "tree.json")):
            return dir_path
        return None

    @classmethod
    def has_save(cls, dir_path: str) -> bool:
        """Does ``dir_path`` hold anything :meth:`load` could try?"""
        return cls.latest_epoch_dir(dir_path) is not None

    def save(self, dir_path: str, *, keep_epochs: int = 2) -> Dict[str, int]:
        """Persist the radix tree as a fresh atomic epoch under
        ``dir_path``: the node structure as ``tree.json`` plus every
        node block's actual KV payload as memmap files (the same
        on-disk format as the SSD weight tier), written to a temp
        directory and renamed into place. A restarted server
        :meth:`load`-s the tree SSD-resident — first hits pay NVMe+PCIe
        promotion instead of prefill compute, the warm-restart story of
        the flash-resident prefix cache. Surrogate (analytic) blocks
        persist structure-only. The newest ``keep_epochs`` epochs are
        kept (older ones + stale temp dirs are pruned). Returns
        counters."""
        import json
        import os
        import shutil
        from repro_torch.core.cache.ssd_tier import SSDTier
        os.makedirs(dir_path, exist_ok=True)
        epochs = self._epoch_dirs(dir_path)
        nxt = 1 + (int(os.path.basename(epochs[-1]).split("-")[1])
                   if epochs else 0)
        tmp = os.path.join(dir_path, f".tmp-epoch-{nxt:06d}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        store = SSDTier(tmp)
        # persistence reads are startup/shutdown copies, not serving-time
        # promotion traffic: keep the tier's flash-read stats clean (the
        # mirror of adopt_external's bytes_written guard)
        read0, reads0 = self.kv.ssd.bytes_read, self.kv.ssd.reads
        nodes, ids = [], {id(self.root): 0}
        stack = [self.root]
        pid = 0
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self.root:
                continue
            ids[id(node)] = nid = len(nodes) + 1
            payloads, checksums = [], []
            for bid in self.kv.table.get(node.rid, []):
                # persist the *stored* (possibly int8/int4-packed) form:
                # the crc covers exactly the bytes on disk, and a reload
                # adopts the packed payload without a decode/re-encode
                # round-trip (which would compound quantization error)
                payload = self.kv.block_payload(bid, raw=True)
                if payload is None:
                    payloads.append(None)
                    checksums.append(None)
                else:
                    store.write_layer(pid, payload, flush_meta=False)
                    payloads.append(pid)
                    checksums.append(payload_checksum(payload))
                    pid += 1
            nodes.append({"id": nid, "parent": ids[id(node.parent)],
                          "blocks": [list(b) for b in node.blocks],
                          "last_used": node.last_used,
                          "payloads": payloads,
                          "checksums": checksums})
        store.flush_meta()
        self.kv.ssd.bytes_read, self.kv.ssd.reads = read0, reads0
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"format_version": PERSIST_FORMAT_VERSION,
                       "block_tokens": self.block_tokens,
                       "nodes": nodes}, f)
        # the commit point: one atomic rename publishes the epoch
        os.rename(tmp, os.path.join(dir_path, f"epoch-{nxt:06d}"))
        for name in os.listdir(dir_path):
            if name.startswith(".tmp-epoch-"):
                shutil.rmtree(os.path.join(dir_path, name),
                              ignore_errors=True)
        for old in self._epoch_dirs(dir_path)[:-keep_epochs]:
            shutil.rmtree(old, ignore_errors=True)
        self._obs("save", nodes=len(nodes), payload_blocks=pid,
                  epoch=nxt)
        return {"nodes": len(nodes), "payload_blocks": pid,
                "epoch": nxt}

    def _reject_load(self, reason: str) -> Dict[str, int]:
        self.load_rejects += 1
        self._obs("load_rejected", reason=reason)
        return {"nodes": 0, "payload_blocks": 0, "rejected": reason}

    def load(self, dir_path: str) -> Dict[str, int]:
        """Rebuild a :meth:`save`-d tree into this (empty) cache,
        trying the newest epoch first and falling back to older
        consistent epochs (then a legacy flat-layout save). Every
        reloaded node's blocks are created *flash-resident* in the
        TieredKVCache (`adopt_external`): the warm-started server pays
        real NVMe reads + modeled promotion seconds on first hit, and
        match results are identical to the pre-restart tree's.

        Checksum + version handshake per candidate: every payload file
        is verified against the crc recorded at save time *before
        anything is adopted*. A version mismatch, a missing/truncated
        file or a crc mismatch rejects that candidate — the next older
        epoch is tried; with none left the cache stays empty (prompts
        recompute, which is always safe) and the result carries a
        ``rejected`` reason; ``load_rejected`` trace instants are
        emitted when a recorder is attached."""
        import os
        assert self.nodes == 0, "load() requires an empty prefix cache"
        cands = list(reversed(self._epoch_dirs(dir_path)))
        if os.path.exists(os.path.join(dir_path, "tree.json")):
            cands.append(dir_path)          # legacy flat (pre-epoch) save
        if not cands:
            return self._reject_load("no saved tree found")
        res = None
        for cand in cands:
            res = self._load_one(cand)
            if "rejected" not in res:
                return res
        return res

    def _load_one(self, dir_path: str) -> Dict[str, int]:
        """Verify-then-adopt one save directory (an epoch dir or a
        legacy flat layout); rejection leaves the cache untouched."""
        import json
        import os
        from repro_torch.core.cache.ssd_tier import SSDTier
        try:
            with open(os.path.join(dir_path, "tree.json")) as f:
                spec = json.load(f)
        except (OSError, ValueError):
            return self._reject_load(
                f"tree.json unreadable in {os.path.basename(dir_path)}")
        version = spec.get("format_version")
        if version != PERSIST_FORMAT_VERSION:
            return self._reject_load(
                f"format_version {version!r} != {PERSIST_FORMAT_VERSION}"
                " (unverifiable tree)")
        if spec["block_tokens"] != self.block_tokens:
            return self._reject_load(
                f"block_tokens {spec['block_tokens']} != "
                f"{self.block_tokens} (different KV block granularity)")
        store = SSDTier(dir_path)
        # pass 1 — verify every payload file before adopting anything
        banks_by_pid: Dict[int, dict] = {}
        for entry in spec["nodes"]:
            for pid, crc in zip(entry["payloads"], entry["checksums"]):
                if pid is None:
                    continue
                try:
                    banks = {k: np.array(v) for k, v in
                             store.read_layer(int(pid)).items()}
                except (OSError, ValueError):
                    return self._reject_load(
                        f"payload {pid} unreadable")
                if not banks:
                    return self._reject_load(f"payload {pid} missing")
                if payload_checksum(banks) != crc:
                    return self._reject_load(
                        f"payload {pid} checksum mismatch")
                banks_by_pid[int(pid)] = banks
        # pass 2 — adopt the verified tree
        by_id: Dict[int, RadixNode] = {0: self.root}
        tok0 = {0: 0}
        for entry in sorted(spec["nodes"], key=lambda e: e["id"]):
            parent = by_id[entry["parent"]]
            blocks = [tuple(b) for b in entry["blocks"]]
            node = RadixNode(rid=self._next_node_rid, blocks=blocks,
                             parent=parent,
                             last_used=float(entry["last_used"]))
            self._next_node_rid -= 1
            payloads = [None if pid is None else banks_by_pid[int(pid)]
                        for pid in entry["payloads"]]
            self.kv.adopt_external(node.rid, payloads,
                                   tok0=tok0[entry["parent"]])
            tok0[entry["id"]] = tok0[entry["parent"]] \
                + len(blocks) * self.block_tokens
            parent.children[blocks[0]] = node
            by_id[entry["id"]] = node
            self.nodes += 1
            self.cached_tokens += node.ntokens
        self._reclaim(now=0.0)
        self._obs("load", nodes=len(spec["nodes"]),
                  payload_blocks=len(banks_by_pid))
        return {"nodes": len(spec["nodes"]),
                "payload_blocks": len(banks_by_pid)}

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_nodes": self.nodes,
            "prefix_cached_tokens": self.cached_tokens,
            "prefix_lookups": self.lookups,
            "prefix_hit_requests": self.hit_requests,
            "prefix_hit_tokens": self.hit_tokens_total,
            "prefix_lookup_tokens": self.lookup_tokens_total,
            "prefix_hit_rate": self.hit_tokens_total
            / max(self.lookup_tokens_total, 1),
            "prefix_inserted_tokens": self.inserted_tokens,
            "prefix_insert_skips_carbon": self.insert_skips_carbon,
            "prefix_inserts_int8": self.inserts_int8,
            "prefix_inserts_int4": self.inserts_int4,
            "prefix_reclaimed_tokens": self.reclaimed_tokens,
            "prefix_splits": self.splits,
            "prefix_load_rejects": self.load_rejects,
            "prefix_invalidations": self.invalidations,
            "prefix_invalidated_tokens": self.invalidated_tokens,
        }
