"""Tiered per-request KV cache over the M2Cache hierarchy (HBM→DRAM→SSD).

The paper's three-level weight cache extends naturally to KV state: decode
reads every resident KV block once per step, so blocks of *running*
requests want HBM, blocks of preempted/queued requests can wait in DRAM,
and cold blocks spill to flash. This module implements exactly that:

* a **block table** — fixed-size blocks of ``block_tokens`` tokens per
  request (paged-attention style), each tracked with its current tier;
* **LRU eviction** HBM→DRAM through the existing :class:`DRAMCache`
  (dynamic area, FIFO spill) and DRAM→SSD through the existing
  :class:`SSDTier` (real file I/O);
* **real KV residency** (``store_payloads=True`` — the default when the
  engine serves a real tiny model on a payload-capable arch): the
  block's *actual tensor bytes* move with it. HBM-resident blocks live
  in the owning session's cache dict; demoting one device_gets
  its token slice out of every KV leaf (``core/kv_payload.py``) and
  scrubs the device copy, DRAM holds the materialized numpy arrays, and
  the DRAM→SSD spill serializes them to real memmap files. Promotion
  reverses each step and device_puts the same bits back. Rids without a
  registered provider (analytic engines, prefix-tree nodes after their
  donor finished, recurrent archs) page surrogates / host masters with
  identical accounting;
* **transfer-clock pricing** — every swap returns modeled seconds
  (PCIe for HBM⇄DRAM, NVMe for DRAM⇄SSD) for the *actual bytes moved*
  that the scheduler charges to the engine clock, so KV paging shows up
  in ``modeled_s`` and therefore in token rates, latency percentiles
  and carbon;
* **mixed-precision tiers** (``precision_map``, default all-fp16):
  precision decays as blocks age down the hierarchy — demotion
  quantizes the captured payload for the destination tier with the
  ``core/quantize.py`` KV codec (HBM fp16 → DRAM int8 → SSD packed
  int4, per-group scales stored alongside in the same flat payload
  dict), the DRAM→SSD spill re-quantizes int8 down to int4, and
  promotion dequantizes before the device_put. The transfer clock, the
  swap/pin byte counters and the DRAM/SSD capacity checks all price the
  *quantized* byte counts, so the savings are real modeled savings;
  precision never re-widens while stored (an int4 block stays int4
  until promoted). With quantization on, restored KV is no longer
  bit-exact — ``eval/divergence.py`` + ``benchmarks/serving_mixedprec.py``
  hold the drift under the acceptance gate.

Units and clock semantics: every public mutator (``alloc`` / ``extend`` /
``append_token`` / ``ensure_resident`` / ``swap_out``) returns **modeled
seconds** of transfer time for the caller to charge to the engine clock
via ``M2CacheEngine.advance_clock`` — the cache never advances a clock
itself. Capacities and ``stats()`` byte counters are **real (unscaled)
bytes**; on-disk surrogate files are smaller by ``byte_scale``. ``tokens``
counts prompt + generated tokens currently stored per request.

**Async prefetch**: with a shared :class:`PrefetchEngine` attached, the
scheduler can call :meth:`prefetch_resident` for requests it predicts
will join the next decode batch — block promotions are then *issued* on
the modeled SSD/PCIe channels (contending with the weight preloader on
the same flash bus) and overlap with the current step's compute.
A later ``ensure_resident(..., now=clock)`` charges only the residual
stall of still-in-flight transfers instead of the full serial swap time.

**Prefix sharing** (``serving/prefix_cache.py``): radix-tree nodes own
block ranges under their own (negative) rids. :meth:`adopt_blocks`
transfers block ownership between rids (a metadata move, no transfer
charged — the bytes do not move tiers), which is how a finished prefill
donates its prompt blocks to the tree and how a node split partitions
an edge. :meth:`pin`/:meth:`unpin` protect a rid's blocks from HBM
eviction for as long as some running request reads them (refcounted
prefix blocks must not be demoted mid-decode); unpinned node blocks age
out of HBM through the normal LRU path, so cold prefixes demote to
DRAM and then flash under the same transfer-clock pricing as request KV.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core import quantize as Q
from repro_torch.core.cache.dram_cache import DRAMCache
from repro_torch.core.cache.preloader import (PCIE_CHANNEL, SSD_CHANNEL,
                                        PrefetchEngine)
from repro_torch.core.cache.ssd_tier import SSDTier
from repro_torch.core.hw import HOST, HostHW
from repro_torch.serving.faults import KVBlockLostError, payload_checksum

#: per-tier KV storage precision maps. HBM is always fp16 — the device
#: pytree is native-width; quantization happens at the demote boundary.
FP16_PRECISION = {"hbm": "fp16", "dram": "fp16", "ssd": "fp16"}
MIXED_PRECISION = {"hbm": "fp16", "dram": "int8", "ssd": "int4"}

#: modeled stored-bytes fraction per precision vs the tier-native
#: payload — sizes surrogate (analytic-engine) payloads; real payloads
#: measure their actual packed nbytes instead
PRECISION_FRACTION = {"fp16": 1.0, "int8": 0.5, "int4": 0.25}


def parse_precision_map(spec) -> Dict[str, str]:
    """``"hbm:fp16,dram:int8,ssd:int4"`` (or ``"mixed"`` / ``"fp16"`` /
    a dict / None) → a full validated tier→precision map."""
    if spec is None:
        return dict(FP16_PRECISION)
    if isinstance(spec, str):
        if spec == "mixed":
            return dict(MIXED_PRECISION)
        if spec == "fp16":
            return dict(FP16_PRECISION)
        parsed = {}
        for part in spec.split(","):
            tier, _, prec = part.strip().partition(":")
            parsed[tier] = prec
        spec = parsed
    out = dict(FP16_PRECISION)
    for tier, prec in spec.items():
        if tier not in out:
            raise ValueError(f"unknown KV tier {tier!r} "
                             f"(expected one of {sorted(out)})")
        if prec not in PRECISION_FRACTION:
            raise ValueError(f"unknown KV precision {prec!r} "
                             f"(expected one of {sorted(PRECISION_FRACTION)})")
        out[tier] = prec
    if out["hbm"] != "fp16":
        raise ValueError("the HBM tier must stay fp16 — device KV is "
                         "native-width; quantization happens on demote")
    if PRECISION_FRACTION[out["ssd"]] > PRECISION_FRACTION[out["dram"]]:
        raise ValueError("precision must decay down the hierarchy "
                         f"(dram={out['dram']} → ssd={out['ssd']} widens)")
    return out


@dataclasses.dataclass
class KVBlock:
    bid: int
    rid: int
    nbytes: float                 # real (unscaled) bytes *as stored now*
                                  # — quantized tiers shrink it; promotion
                                  # restores full_nbytes
    tier: str                     # "hbm" | "dram" | "ssd"
    tok0: int = 0                 # absolute first token position covered
    data: Optional[dict] = None   # host payload (real-residency mode):
                                  # set while the block's canonical bytes
                                  # live host-side (DRAM tier, or an
                                  # HBM-tier prefix-node block whose
                                  # master copy is this dict — possibly
                                  # quantized); None when they live in a
                                  # session's device pytree or SSD files
    real: bool = False            # a real payload was ever captured
    precision: str = "fp16"       # storage precision of the current bytes
    full_nbytes: float = 0.0      # HBM-resident (fp16-tier) size
    checksum: Optional[int] = None  # crc32 of the stored payload form,
                                  # computed when the bytes cross a
                                  # storage boundary (demote / spill),
                                  # verified when they come back

    def __post_init__(self):
        if not self.full_nbytes:
            self.full_nbytes = self.nbytes


class TieredKVCache:
    def __init__(self, *, num_layers: int, d_model: int,
                 hbm_capacity_bytes: float, dram_capacity_bytes: float,
                 ssd_dir: str, hw: HostHW = HOST, block_tokens: int = 16,
                 bytes_per_token: float = None,
                 max_file_bytes: int = 65536,
                 prefetch: Optional[PrefetchEngine] = None,
                 store_payloads: bool = False,
                 precision_map: Optional[Dict[str, str]] = None,
                 prefetch_headroom_frac: float = 0.05,
                 faults=None,
                 ssd_retry_limit: int = 2,
                 ssd_retry_backoff_s: float = 2e-3,
                 ssd_breaker_threshold: int = 3,
                 ssd_probe_cooldown_s: float = 0.5,
                 ssd_probe_cooldown_max_s: float = 8.0):
        self.hw = hw
        # per-tier storage precision (fp16 everywhere by default —
        # byte-identical paging); any quantized tier flips self.quantized
        self.precision = parse_precision_map(precision_map)
        self.quantized = any(p != "fp16" for p in self.precision.values())
        # prefetch never evicts, but it must not fill HBM to the brim
        # either: admissions stop above (1 - headroom) of the budget so
        # running requests can still append tokens without evictions
        self.prefetch_headroom_frac = float(prefetch_headroom_frac)
        # shared modeled DMA engine (None -> all swaps priced serially)
        self.prefetch = prefetch
        if prefetch is not None:
            prefetch.add_channel(SSD_CHANNEL, hw.ssd_bw)
            prefetch.add_channel(PCIE_CHANNEL, hw.pcie_bw)
        self.block_tokens = block_tokens
        self.bytes_per_token = bytes_per_token if bytes_per_token \
            else 2.0 * num_layers * d_model * 2.0          # fp16 K+V
        self.block_bytes = self.block_tokens * self.bytes_per_token
        # real-residency mode: demotions carry the actual KV tensor bytes
        # (device_get from the owning session on demote, device_put back
        # on promote, real files on flash) — sizes are the true payload
        # sizes, so no surrogate byte-scaling applies
        self.store_payloads = store_payloads
        if store_payloads:
            stored = int(self.block_bytes)
            self.byte_scale = 1.0
        else:
            # surrogate payloads cap file size; byte_scale maps to real
            stored = int(min(self.block_bytes, max_file_bytes))
            self.byte_scale = self.block_bytes / stored
        self._stored = stored
        self.hbm_capacity = float(hbm_capacity_bytes)
        self.dram = DRAMCache(int(dram_capacity_bytes), n_fixed=0,
                              byte_scale=self.byte_scale)
        os.makedirs(ssd_dir, exist_ok=True)
        self.ssd = SSDTier(ssd_dir)

        self.blocks: Dict[int, KVBlock] = {}
        self.table: Dict[int, List[int]] = {}      # rid -> block ids
        self.tokens: Dict[int, int] = {}           # rid -> tokens stored
        self.pinned: set = set()                   # rids exempt from eviction
        self._hbm_lru: "OrderedDict[int, None]" = OrderedDict()
        self.hbm_used = 0.0
        self._next_bid = 0
        # real-residency plumbing: per-rid providers export/import the
        # actual tensor bytes of a block (the owning session's KV slices);
        # _next_tok0 assigns each new block its absolute token range
        # (a prefix-hit request's own blocks start past the hit)
        self._providers: Dict[int, object] = {}
        self._next_tok0: Dict[int, int] = {}
        # swap accounting (real bytes / modeled seconds)
        self.swap_out_bytes = 0.0
        self.swap_in_bytes = 0.0
        self.swap_s = 0.0
        self.preempt_swaps = 0
        # mixed-precision accounting: transfer bytes the quantized tiers
        # avoided (vs full-width payloads) and the fp16-equivalent bytes
        # behind each SSD spill write (capacity-stretch numerator)
        self.quant_saved_bytes = 0.0
        self.ssd_write_full_bytes = 0.0
        # prefetch accounting (real bytes / modeled seconds)
        self.prefetch_issued_bytes = 0.0
        self.prefetch_overlap_bytes = 0.0
        self.prefetch_stall_s = 0.0
        self.resume_sync_s = 0.0         # serial (unprefetched) promotions
        # obs hooks (attach_obs): None -> zero-cost no-ops
        self._obs_trace = None           # repro.obs.TraceRecorder
        self._obs_blocks = None          # repro.obs.BlockTraceCollector
        self._obs_clock = None           # () -> raw modeled seconds
        # fault injection + graceful degradation (docs/RELIABILITY.md):
        # transient SSD IO errors get bounded retry-with-backoff; a run
        # of consecutive failures trips the circuit breaker, which
        # quarantines the flash tier (DRAM-only paging, over-commit
        # tracked) until the process restarts
        self.faults = faults             # repro_torch.serving.faults.FaultInjector
        self.ssd_retry_limit = int(ssd_retry_limit)
        self.ssd_retry_backoff_s = float(ssd_retry_backoff_s)
        self.ssd_breaker_threshold = int(ssd_breaker_threshold)
        self.ssd_quarantined = False
        self._ssd_consec_failures = 0
        # quarantine re-probe: after a cooldown on the modeled clock the
        # tier is probed once; success rejoins it, failure doubles the
        # cooldown (bounded). Needs a clock (set_clock / attach_obs) —
        # without one the tier stays quarantined, the pre-probe behavior.
        self.ssd_probe_cooldown_s = float(ssd_probe_cooldown_s)
        self.ssd_probe_cooldown_max_s = float(ssd_probe_cooldown_max_s)
        self._kv_clock = None            # () -> raw modeled seconds
        self._probe_cooldown = self.ssd_probe_cooldown_s
        self._next_probe_at: Optional[float] = None
        self.ssd_probes = 0
        self.ssd_probe_failures = 0
        self.ssd_rejoins = 0
        self.ssd_read_retries = 0
        self.ssd_write_retries = 0
        self.ssd_write_aborts = 0        # spills aborted (victim kept in DRAM)
        self.retry_backoff_s = 0.0       # modeled seconds spent backing off
        self.checksum_failures = 0
        self.blocks_lost = 0
        self.provider_faults = 0
        self.prefetch_skips = 0          # prefetch reads skipped on faults
        self.dram_overcommit_max = 0.0   # worst DRAM bytes over capacity
        self._pending_fault_s = 0.0      # provider-retry backoff to fold
                                         # into the next public charge

    # ------------------------------------------------------------------
    # observability: every tier transition as a block-access event

    def set_clock(self, clock):
        """Give the cache a raw modeled-clock reader (the scheduler's
        engine clock). Only consulted for quarantine re-probe timing —
        never to advance anything."""
        self._kv_clock = clock

    def attach_obs(self, *, trace=None, block_trace=None, clock=None):
        """Attach a :class:`~repro.obs.TraceRecorder` (Chrome-trace ``kv``
        instants) and/or a :class:`~repro.obs.BlockTraceCollector` (the
        replay stream for the replacement-policy lab). ``clock`` returns
        the current raw modeled time; events stamp it at emission.
        Recording never moves the modeled clock."""
        self._obs_trace = trace
        self._obs_blocks = block_trace
        self._obs_clock = clock

    def _emit(self, op: str, blk: KVBlock, *, prev_tier=None, cause=None,
              chrome: bool = True, precision: Optional[str] = None):
        """``precision`` labels the bytes that *moved* (a promote's
        stored precision, already re-widened on ``blk``); default: the
        block's current storage precision."""
        if self._obs_trace is None and self._obs_blocks is None:
            return
        t = self._obs_clock() if self._obs_clock is not None else 0.0
        prec = precision or blk.precision
        if self._obs_blocks is not None:
            self._obs_blocks.emit(t, op, blk.bid, blk.rid, blk.tier,
                                  prev_tier=prev_tier,
                                  nbytes=int(blk.nbytes), tok0=blk.tok0,
                                  cause=cause, precision=prec)
        if self._obs_trace is not None and chrome:
            self._obs_trace.instant("kv", op, t, bid=blk.bid, rid=blk.rid,
                                    tier=blk.tier, prev=prev_tier,
                                    cause=cause, nbytes=int(blk.nbytes),
                                    precision=prec)

    # ------------------------------------------------------------------
    def _payload(self, precision: str = "fp16") -> dict:
        n = max(int(self._stored * PRECISION_FRACTION[precision]), 1)
        return {"kv": np.zeros(n, np.int8)}

    def _quantize_for(self, blk: KVBlock, payload: Optional[dict],
                      tier: str):
        """Re-encode a block's payload for a destination tier. Returns
        ``(payload, precision, stored_nbytes)`` — the bytes the transfer
        clock and the tier's capacity accounting should price. Precision
        only decays (see ``kv_requantize_payload``); with quantization
        off everything passes through at the block's current size."""
        target = self.precision[tier]
        if not self.quantized:
            return payload, blk.precision, blk.nbytes
        if payload is None:
            prec = target
            if PRECISION_FRACTION[prec] > PRECISION_FRACTION[blk.precision]:
                prec = blk.precision          # surrogates never re-widen
            return None, prec, blk.full_nbytes * PRECISION_FRACTION[prec]
        q = Q.kv_requantize_payload(payload, target)
        prec = Q.kv_payload_precision(q)
        if q is payload and prec == blk.precision:
            return payload, prec, blk.nbytes
        return q, prec, float(Q.kv_payload_nbytes(q))

    def _charge(self, dt: float) -> float:
        # fold in any provider-retry backoff accrued since the last
        # public-API boundary, so fault handling shows up on the clock
        dt += self._pending_fault_s
        self._pending_fault_s = 0.0
        self.swap_s += dt
        return dt

    # ------------------------------------------------------------------
    # fault injection + graceful degradation

    def attach_faults(self, injector):
        """Consult ``injector`` at every storage/transfer boundary, and
        wire it into the shared :class:`PrefetchEngine` so DMA-channel
        stalls/failures hit the modeled async path too."""
        self.faults = injector
        if self.prefetch is not None and injector is not None:
            self.prefetch.attach_faults(injector)

    def _lost(self, blk: KVBlock, reason: str):
        """A block's payload is unrecoverably gone — count it, trace it,
        and raise for the scheduler's request-level recovery."""
        self.blocks_lost += 1
        self._emit("lost", blk, cause=reason)
        raise KVBlockLostError(blk.rid, blk.bid, reason)

    def _note_ssd_failure(self):
        self._ssd_consec_failures += 1
        if not self.ssd_quarantined and \
                self._ssd_consec_failures >= self.ssd_breaker_threshold:
            # circuit breaker: the flash tier has failed
            # ssd_breaker_threshold times in a row — quarantine it and
            # degrade to DRAM-only paging (spills stop; blocks already
            # on flash stay readable so nothing is stranded)
            self.ssd_quarantined = True
            # arm the re-probe schedule (fresh cooldown per quarantine)
            self._probe_cooldown = self.ssd_probe_cooldown_s
            now = self._now()
            self._next_probe_at = (now + self._probe_cooldown
                                   if now is not None else None)
            if self._obs_trace is not None:
                t = self._obs_clock() if self._obs_clock else 0.0
                self._obs_trace.instant(
                    "kv", "ssd_quarantine", t,
                    consecutive_failures=self._ssd_consec_failures)

    def _note_ssd_success(self):
        self._ssd_consec_failures = 0

    def _now(self) -> Optional[float]:
        if self._kv_clock is not None:
            return self._kv_clock()
        if self._obs_clock is not None:
            return self._obs_clock()
        return None

    def _ssd_usable(self) -> bool:
        """True when spills may use the flash tier: not quarantined, or
        quarantined but a cooldown-gated probe just succeeded."""
        return not self.ssd_quarantined or self._maybe_reprobe()

    def _maybe_reprobe(self) -> bool:
        """Bounded background re-probe of a quarantined flash tier on
        the modeled clock. At most one probe per cooldown window; a
        failed probe doubles the cooldown (capped), a successful one
        rejoins the tier and resets the breaker. Returns True iff the
        tier rejoined. Probes are control-plane: they never advance the
        modeled clock and never touch data blocks."""
        now = self._now()
        if now is None or self._next_probe_at is None \
                or now < self._next_probe_at:
            return False
        self.ssd_probes += 1
        fired = self.faults is not None and self.faults.fire(
            "ssd.write", detail={"probe": True}) is not None
        if fired:
            self.ssd_probe_failures += 1
            self._probe_cooldown = min(self._probe_cooldown * 2.0,
                                       self.ssd_probe_cooldown_max_s)
            self._next_probe_at = now + self._probe_cooldown
            if self._obs_trace is not None:
                self._obs_trace.instant(
                    "kv", "ssd_probe_failed", now,
                    cooldown_s=self._probe_cooldown)
            return False
        self.ssd_quarantined = False
        self._ssd_consec_failures = 0
        self._next_probe_at = None
        self._probe_cooldown = self.ssd_probe_cooldown_s
        self.ssd_rejoins += 1
        if self._obs_trace is not None:
            self._obs_trace.instant("kv", "ssd_rejoin", now,
                                    probes=self.ssd_probes)
        return True

    def _ssd_write(self, blk: KVBlock, banks: dict):
        """Write a block's stored form to flash with bounded
        retry-with-backoff. Returns ``(ok, modeled_seconds)``; a
        permanent failure leaves the caller to keep the victim in DRAM
        (a failed write never loses data)."""
        dt = 0.0
        backoff = self.ssd_retry_backoff_s
        for attempt in range(1 + self.ssd_retry_limit):
            if attempt:
                self.ssd_write_retries += 1
                self.retry_backoff_s += backoff
                dt += backoff
                backoff *= 2.0
            if self.faults is not None and self.faults.fire(
                    "ssd.write", detail={"bid": blk.bid}) is not None:
                self._note_ssd_failure()
                continue
            self.ssd.write_layer(blk.bid, banks, flush_meta=False)
            self._note_ssd_success()
            return True, dt
        self.ssd_write_aborts += 1
        return False, dt

    def _ssd_read(self, blk: KVBlock, *, attempts: Optional[int] = None):
        """Read a block back from flash with bounded retry-with-backoff
        and checksum verification of real payloads. Returns
        ``(banks, modeled_seconds)`` with the arrays copied out of the
        memmaps; raises :class:`KVBlockLostError` when every attempt
        fails (the caller decides whether that means loss — a demand
        promote escalates, a prefetch just skips)."""
        if attempts is None:
            attempts = 1 + self.ssd_retry_limit
        dt = 0.0
        backoff = self.ssd_retry_backoff_s
        reason = "ssd read error"
        for attempt in range(attempts):
            if attempt:
                self.ssd_read_retries += 1
                self.retry_backoff_s += backoff
                dt += backoff
                backoff *= 2.0
            if self.faults is not None and self.faults.fire(
                    "ssd.read", detail={"bid": blk.bid}) is not None:
                self._note_ssd_failure()
                continue
            banks = {k: np.array(v)
                     for k, v in self.ssd.read_layer(blk.bid).items()}
            if self.faults is not None:
                banks = self.faults.corrupt("ssd.corrupt", banks,
                                            detail={"bid": blk.bid})
            if self.store_payloads and blk.real \
                    and blk.checksum is not None \
                    and payload_checksum(banks) != blk.checksum:
                # a flipped bit between flash and host: never decode it
                # silently — count, retry (the file may re-read clean)
                self.checksum_failures += 1
                self._note_ssd_failure()
                reason = "payload checksum mismatch (ssd)"
                continue
            self._note_ssd_success()
            return banks, dt
        raise KVBlockLostError(blk.rid, blk.bid, reason)

    # ------------------------------------------------------------------
    # real-residency plumbing (store_payloads mode)

    def register_provider(self, rid: int, provider):
        """Attach the object that can export/import ``rid``'s actual KV
        tensor bytes per block (``export(tok0, ntokens, scrub=...)`` /
        ``import_(tok0, payload)`` against the owning session's device
        pytree). Without a provider a rid pages modeled surrogates."""
        if provider is not None:
            self._providers[rid] = provider

    def unregister_provider(self, rid: int):
        self._providers.pop(rid, None)

    def set_origin(self, rid: int, tok0: int):
        """First absolute token position of ``rid``'s *own* blocks (a
        prefix-hit request owns only the suffix past the hit)."""
        self._next_tok0[rid] = int(tok0)

    def _capture(self, blk: KVBlock, *, scrub: bool) -> Optional[dict]:
        """Pull a block's real bytes host-side (device_get) if they are
        not already captured. ``scrub`` zeroes the device copy, so the
        demotion genuinely removes the bytes from HBM."""
        if not self.store_payloads or blk.data is not None:
            return blk.data
        provider = self._providers.get(blk.rid)
        if provider is None:
            return None
        if self.faults is not None and self.faults.fire(
                "provider.export", detail={"bid": blk.bid}) is not None:
            # transient device→host capture error: the device copy is
            # still intact, so one retried export (after a modeled
            # backoff, folded in at the next public charge) recovers
            self.provider_faults += 1
            self._pending_fault_s += self.ssd_retry_backoff_s
        blk.data = provider.export(blk.tok0, self.block_tokens,
                                   scrub=scrub)
        blk.real = True
        return blk.data

    def _deliver(self, blk: KVBlock, payload: Optional[dict]):
        """Hand a promoted block's bytes back: device_put into the owning
        session when a provider exists (decoding a quantized payload back
        to full width first — the device pytree is native-width), else
        keep the host master copy (prefix-node blocks, whose device
        copies live in the sessions that restored them). The host master
        stays in its *stored* form: dequantizing here only to requantize
        on the next demote would compound rounding error, so
        :meth:`block_payload` decodes on demand instead."""
        if payload is None:
            blk.data = None
            return
        provider = self._providers.get(blk.rid)
        if provider is not None:
            if self.faults is not None and self.faults.fire(
                    "provider.import", detail={"bid": blk.bid}) is not None:
                # transient host→device restore error: the verified host
                # payload is intact, so one retried import recovers
                self.provider_faults += 1
                self._pending_fault_s += self.ssd_retry_backoff_s
            provider.import_(blk.tok0, Q.kv_dequantize_payload(payload))
            blk.data = None
        else:
            blk.data = payload

    def materialize(self, rid: int, start_block: int, nblocks: int, *,
                    precision: Optional[str] = None):
        """Capture host copies of ``rid``'s blocks ``[start_block,
        start_block+nblocks)`` without scrubbing the device copy — the
        prefix cache calls this right before adopting a finished
        prefill's prompt blocks, so donated radix-node blocks carry the
        actual KV bytes a later hit will restore. ``precision`` (only
        honoured when quantized tiers are on) encodes the captured host
        master at insert time — the carbon-aware prefix policy stores
        clean-window prefixes int8 and dirty-window ones int4 even while
        the donor's device copy is still full-width in HBM."""
        if not self.store_payloads:
            return
        for bid in self.table[rid][start_block:start_block + nblocks]:
            blk = self.blocks[bid]
            self._capture(blk, scrub=False)
            if precision and self.quantized and blk.data is not None:
                blk.data = Q.kv_requantize_payload(blk.data, precision)

    def block_payload(self, bid: int, *, raw: bool = False) \
            -> Optional[dict]:
        """A block's host payload wherever it currently lives (host
        master copy, DRAM store, or flash files — flash reads are copied
        out so the caller owns the arrays). None for surrogate blocks.
        Quantized payloads are decoded back to full precision unless
        ``raw=True`` — persistence checksums the stored (packed) form,
        everything else consumes tensors."""
        blk = self.blocks[bid]
        if not (self.store_payloads and blk.real):
            return None
        payload = None
        if blk.data is not None:
            payload = blk.data
        elif blk.tier == "dram" and bid in self.dram.dynamic:
            p = self.dram.dynamic[bid]
            payload = p if "kv" not in p else None
        elif blk.tier == "ssd":
            try:
                payload, _ = self._ssd_read(blk)
            except KVBlockLostError:
                # unreadable/corrupt flash copy: returning None makes
                # every consumer fall back to recomputing the prefix —
                # a corrupt payload is never decoded silently
                return None
        if payload is None or raw:
            return payload
        return Q.kv_dequantize_payload(payload)

    def payloads_for(self, rid: int) -> List[Optional[dict]]:
        """Host payloads of ``rid``'s blocks in token order (the prefix
        restore path: the scheduler hands these to the engine, which
        device_puts them into the admitted request's fresh cache)."""
        return [self.block_payload(b) for b in self.table.get(rid, [])]

    def adopt_external(self, rid: int, payloads: List[Optional[dict]], *,
                       tok0: int = 0):
        """Create flash-resident blocks for ``rid`` from externally-held
        payloads — the persistence load path: a reloaded radix subtree
        starts SSD-resident and pays NVMe+PCIe promotion on first hit.
        ``payloads`` entries may be None (surrogate mode). Charges
        nothing — neither clock seconds nor the serving-time flash
        counters (the load happens before serving starts, so
        ``kv_ssd_write_bytes`` keeps measuring eviction/spill traffic
        only)."""
        assert rid not in self.table
        self.set_origin(rid, tok0)
        written0 = self.ssd.bytes_written
        for payload in payloads:
            bid = self._next_bid
            self._next_bid += 1
            if payload is not None:
                prec = Q.kv_payload_precision(payload)
                stored = self.block_bytes if prec == "fp16" \
                    else float(Q.kv_payload_nbytes(payload))
            elif self.quantized:
                prec = self.precision["ssd"]
                stored = self.block_bytes * PRECISION_FRACTION[prec]
            else:
                prec = "fp16"
                stored = self.block_bytes
            blk = KVBlock(bid=bid, rid=rid, nbytes=stored,
                          tier="ssd", tok0=self._next_tok0[rid],
                          real=payload is not None, precision=prec,
                          full_nbytes=self.block_bytes,
                          checksum=payload_checksum(payload)
                          if payload is not None else None)
            self._next_tok0[rid] += self.block_tokens
            self.blocks[bid] = blk
            self.table.setdefault(rid, []).append(bid)
            self.ssd.write_layer(
                bid, payload if payload is not None
                else self._payload(prec), flush_meta=False)
            self._emit("adopt", blk, chrome=False, cause="persist_load")
        self.ssd.bytes_written = written0     # startup copy, not a spill
        self.tokens[rid] = len(payloads) * self.block_tokens

    def blocks_for(self, ntokens: int) -> int:
        return max((ntokens + self.block_tokens - 1) // self.block_tokens, 1)

    def bytes_of(self, rid: int) -> float:
        return sum(self.blocks[b].nbytes for b in self.table.get(rid, []))

    # ------------------------------------------------------------------
    def _spill_dram_to_ssd(self, need_bytes: float) -> float:
        """FIFO-spill DRAM blocks to flash until ``need_bytes`` fit. Each
        victim is re-encoded for the SSD tier's precision on the way out
        (int8 → packed int4 under the mixed map), so the flash files —
        and the NVMe leg of the transfer clock — carry the packed form."""
        dt = 0.0
        while self.dram.used_bytes + need_bytes > self.dram.capacity \
                and self.dram.dynamic and self._ssd_usable():
            bid = next(iter(self.dram.dynamic))
            blk = self.blocks[bid]
            payload = self.dram.dynamic[bid]
            if blk.real:
                payload, prec, stored = self._quantize_for(blk, payload,
                                                           "ssd")
            else:
                _, prec, stored = self._quantize_for(blk, None, "ssd")
                if stored != blk.nbytes:
                    payload = self._payload(prec)
            ok, wdt = self._ssd_write(blk, payload)
            dt += wdt
            if not ok:
                # write retries exhausted: the victim stays in DRAM
                # (over-commit) rather than risking a torn flash copy —
                # a failed demote-direction write never loses data
                break
            self.dram.drop(bid)
            blk.tier = "ssd"
            blk.data = None                    # canonical copy now on flash
            blk.precision = prec
            blk.nbytes = stored
            if blk.real:
                blk.checksum = payload_checksum(payload)
            self.ssd_write_full_bytes += blk.full_nbytes
            self.quant_saved_bytes += blk.full_nbytes - stored
            self.swap_out_bytes += stored
            dt += stored / self.hw.ssd_bw
            self._emit("spill", blk, prev_tier="dram",
                       cause="dram_pressure")
        return dt

    def _demote(self, bid: int, *, op: str = "evict",
                cause: str = "hbm_pressure") -> float:
        """HBM → DRAM (spilling DRAM → SSD if the dynamic area is full).
        In real-residency mode the block's actual tensor bytes are pulled
        host-side (device_get) and the device copy scrubbed; otherwise a
        surrogate payload stands in. With quantized tiers the captured
        payload is encoded for the DRAM tier first, so the PCIe leg and
        the DRAM capacity check both price the packed bytes. Returns raw
        seconds; callers charge at the public API boundary."""
        blk = self.blocks[bid]
        assert blk.tier == "hbm"
        if self.prefetch is not None:
            # an unconsumed in-flight prefetch dies with the eviction
            self.prefetch.cancel(("kv", bid))
        self._hbm_lru.pop(bid, None)
        self.hbm_used -= blk.nbytes
        payload = self._capture(blk, scrub=True)
        payload, prec, stored = self._quantize_for(blk, payload, "dram")
        if payload is not None:
            blk.data = payload        # quantized dict is the host master
            if blk.real:
                # the bytes cross a storage boundary here: checksum the
                # stored form so promote can verify it came back intact
                blk.checksum = payload_checksum(payload)
        dt = self._spill_dram_to_ssd(stored)
        banks = payload if payload is not None else self._payload(prec)
        nb = self.dram._nbytes(banks)
        if self.dram.used_bytes + nb > self.dram.capacity:
            # degraded mode (SSD quarantined or spill aborted): insert
            # over capacity instead of letting the FIFO insert silently
            # drop victims whose only copy now lives in DRAM
            self.dram.dynamic[bid] = banks
            self.dram.used_bytes += nb
            self.dram_overcommit_max = max(
                self.dram_overcommit_max,
                self.dram.used_bytes - self.dram.capacity)
        else:
            self.dram.insert(bid, banks)
        blk.tier = "dram"
        blk.precision = prec
        blk.nbytes = stored
        self.quant_saved_bytes += blk.full_nbytes - stored
        self.swap_out_bytes += stored
        self._emit(op, blk, prev_tier="hbm", cause=cause)
        return dt + stored / self.hw.pcie_bw

    def _evict_for(self, need_bytes: float, protect: Iterable[int]) -> float:
        """LRU-evict non-protected HBM blocks until ``need_bytes`` fit.
        May leave the cache over budget if everything is protected — the
        scheduler resolves that by preempting a running request."""
        protect = set(protect) | self.pinned
        dt = 0.0
        while self.hbm_used + need_bytes > self.hbm_capacity:
            victim = next((b for b in self._hbm_lru
                           if self.blocks[b].rid not in protect), None)
            if victim is None:
                break
            dt += self._demote(victim)
        return dt

    def _promote(self, bid: int, protect: Iterable[int]) -> float:
        """DRAM/SSD → HBM. In real-residency mode the block's actual
        bytes come back with it: a DRAM block's host arrays (or an SSD
        block's file contents, copied out before the flash copy is
        deleted) are device_put into the owning session — bit-for-bit
        with fp16 tiers, dequantized from the stored precision under a
        mixed map. The transfer legs price the *stored* (packed) bytes;
        the promoted block then occupies its full fp16 footprint in HBM,
        so eviction makes room for ``full_nbytes`` up front."""
        blk = self.blocks[bid]
        dt = 0.0
        payload = None
        prev = blk.tier
        stored = blk.nbytes              # packed bytes actually moved
        stored_prec = blk.precision
        if blk.tier == "dram":
            if blk.real:
                payload = blk.data if blk.data is not None \
                    else self.dram.dynamic.get(bid)
                if payload is not None and self.faults is not None:
                    corrupted = self.faults.corrupt(
                        "dram.corrupt", payload, detail={"bid": bid})
                    if corrupted is not payload:
                        # a bit flipped in the DRAM master itself — the
                        # canonical copy is what got hit, so there is
                        # nothing clean left to retry against
                        payload = blk.data = corrupted
                        self.dram.dynamic[bid] = corrupted
                if payload is not None and blk.checksum is not None \
                        and payload_checksum(payload) != blk.checksum:
                    self.checksum_failures += 1
                    self._lost(blk, "payload checksum mismatch (dram)")
            dt += self._evict_for(blk.full_nbytes, protect)
            self.dram.drop(bid)
            dt += stored / self.hw.pcie_bw
        elif blk.tier == "ssd":
            try:
                banks, rdt = self._ssd_read(blk)   # real flash read,
            except KVBlockLostError as e:          # retried + verified
                self._lost(blk, e.reason)
            if blk.real:
                payload = banks
            dt += rdt + self._evict_for(blk.full_nbytes, protect)
            self.ssd.delete_layer(bid, flush_meta=False)
            dt += stored / self.hw.ssd_bw \
                + stored / self.hw.pcie_bw
        else:
            dt += self._evict_for(blk.full_nbytes, protect)
        blk.tier = "hbm"
        blk.nbytes = blk.full_nbytes
        blk.precision = self.precision["hbm"]
        self._hbm_lru[bid] = None
        self.hbm_used += blk.nbytes
        self.swap_in_bytes += stored
        self.quant_saved_bytes += blk.full_nbytes - stored
        if blk.real:
            self._deliver(blk, payload)
        self._emit("promote", blk, prev_tier=prev, cause="demand",
                   precision=stored_prec)
        return dt

    def _promote_async(self, bid: int, now: float) -> float:
        """Opportunistic DRAM/SSD → HBM promotion on the modeled DMA
        channels: the block becomes HBM-resident immediately, its arrival
        time tracked under key ``("kv", bid)`` for
        :meth:`ensure_resident` to wait on. Prefetch never evicts — it
        only fills free HBM up to the headroom watermark, so it cannot
        displace running requests' KV, trigger preemptions, or starve
        their token appends; returns the stored bytes issued on the
        channels (0.0 when the block does not fit right now)."""
        blk = self.blocks[bid]
        if self.hbm_used + blk.full_nbytes > \
                self.hbm_capacity * (1.0 - self.prefetch_headroom_frac):
            return 0.0
        not_before = 0.0
        payload = None
        prev = blk.tier
        stored = blk.nbytes              # packed bytes actually moved
        stored_prec = blk.precision
        if blk.tier == "dram":
            if blk.real:
                payload = blk.data if blk.data is not None \
                    else self.dram.dynamic.get(bid)
                if payload is not None and blk.checksum is not None \
                        and payload_checksum(payload) != blk.checksum:
                    # corrupt DRAM master noticed opportunistically:
                    # leave it for the demand promote to escalate
                    self.checksum_failures += 1
                    self.prefetch_skips += 1
                    return 0.0
            self.dram.drop(bid)
        elif blk.tier == "ssd":
            try:                                   # single attempt: the
                banks, _ = self._ssd_read(blk, attempts=1)
            except KVBlockLostError:               # opportunistic path
                # skips on any fault — the flash copy stays intact and
                # the demand promote retries with backoff
                self.prefetch_skips += 1
                return 0.0
            if blk.real:
                payload = banks
            self.ssd.delete_layer(bid, flush_meta=False)
            key = ("kv_ssd", bid)
            not_before = self.prefetch.issue(SSD_CHANNEL, key, stored,
                                             now)
            self.prefetch.cancel(key)              # waiters watch the PCIe leg
        self.prefetch.issue(PCIE_CHANNEL, ("kv", bid), stored, now,
                            not_before=not_before)
        blk.tier = "hbm"
        blk.nbytes = blk.full_nbytes
        blk.precision = self.precision["hbm"]
        self._hbm_lru[bid] = None
        self.hbm_used += blk.nbytes
        self.swap_in_bytes += stored
        self.quant_saved_bytes += blk.full_nbytes - stored
        if blk.real:
            # the host→device copy lands now; only its *arrival time* is
            # modeled asynchronously (ensure_resident charges the
            # residual stall of the in-flight transfer)
            self._deliver(blk, payload)
        self._emit("promote", blk, prev_tier=prev, cause="prefetch",
                   precision=stored_prec)
        return stored

    def _new_block(self, rid: int, protect: Iterable[int]) -> float:
        dt = self._evict_for(self.block_bytes, protect)
        bid = self._next_bid
        self._next_bid += 1
        tok0 = self._next_tok0.setdefault(rid, 0)
        self._next_tok0[rid] = tok0 + self.block_tokens
        self.blocks[bid] = KVBlock(bid=bid, rid=rid,
                                   nbytes=self.block_bytes, tier="hbm",
                                   tok0=tok0)
        self.table.setdefault(rid, []).append(bid)
        self._hbm_lru[bid] = None
        self.hbm_used += self.block_bytes
        self._emit("alloc", self.blocks[bid], chrome=False)
        return dt

    # ------------------------------------------------------------------
    # scheduler-facing API (all return modeled seconds to charge)

    def alloc(self, rid: int, ntokens: int,
              protect: Iterable[int] = ()) -> float:
        """Allocate a fresh request's KV (prompt tokens) in HBM."""
        assert rid not in self.table
        self.tokens[rid] = ntokens
        dt = 0.0
        for _ in range(self.blocks_for(ntokens)):
            dt += self._new_block(rid, protect)
        return self._charge(dt)

    def extend(self, rid: int, ntokens: int,
               protect: Iterable[int] = ()) -> float:
        """Grow (or create) a request's KV by ``ntokens`` prompt tokens —
        the chunked-prefill allocation path. Returns modeled seconds."""
        if rid not in self.table:
            return self.alloc(rid, ntokens, protect)
        self.tokens[rid] += ntokens
        dt = 0.0
        while self.blocks_for(self.tokens[rid]) > len(self.table[rid]):
            dt += self._new_block(rid, protect)
        return self._charge(dt)

    def append_token(self, rid: int, protect: Iterable[int] = ()) -> float:
        """Grow a running request by one decoded token."""
        self.tokens[rid] += 1
        if self.blocks_for(self.tokens[rid]) > len(self.table[rid]):
            return self._charge(self._new_block(rid, protect))
        return 0.0

    def touch(self, rid: int):
        """Mark a request's blocks most-recently-used (decode reads them)."""
        for bid in self.table.get(rid, []):
            if bid in self._hbm_lru:
                self._hbm_lru.move_to_end(bid)
                if self._obs_blocks is not None:
                    # read accesses feed the replay stream only (a
                    # replacement-policy simulator needs them; the Chrome
                    # trace would drown in them)
                    self._emit("touch", self.blocks[bid], chrome=False)

    def prefetch_resident(self, rid: int, *, now: float) -> float:
        """Predictively promote a request's blocks toward HBM in the
        background, starting at modeled time ``now`` (the scheduler calls
        this for requests it expects in the *next* decode batch, so the
        transfers overlap the current step's compute). Admissions stop at
        the HBM headroom watermark — prefetch never evicts. Returns the
        real (stored) bytes issued; nothing is charged to the clock
        here."""
        if self.prefetch is None:
            return 0.0
        issued = 0.0
        for bid in self.table.get(rid, []):
            if self.blocks[bid].tier == "hbm":
                continue
            issued += self._promote_async(bid, now)
        self.prefetch_issued_bytes += issued
        return issued

    def ensure_resident(self, rid: int, protect: Iterable[int] = (), *,
                        now: Optional[float] = None) -> float:
        """Swap a (possibly preempted) request's blocks back into HBM.

        Blocks promoted ahead of time by :meth:`prefetch_resident` charge
        only the residual stall of their in-flight transfer at modeled
        time ``now`` (zero once it landed); the rest pay the serial
        promotion path as before."""
        dt = 0.0
        try:
            for bid in self.table.get(rid, []):
                blk = self.blocks[bid]
                if blk.tier != "hbm":
                    sync = self._promote(bid, protect)
                    self.resume_sync_s += sync
                    dt += sync
                elif self.prefetch is not None and now is not None \
                        and self.prefetch.in_flight(("kv", bid)):
                    stall = self.prefetch.wait(("kv", bid), now + dt)
                    if stall > 0.0:
                        self.prefetch_stall_s += stall
                    else:
                        self.prefetch_overlap_bytes += blk.nbytes
                    dt += stall
        except KVBlockLostError:
            # a block is unrecoverably gone: charge what was already
            # promoted, then let the scheduler run request-level
            # recovery (re-enqueue + deterministic re-prefill)
            self._charge(dt)
            raise
        self.touch(rid)
        return self._charge(dt)

    def swap_out(self, rid: int) -> float:
        """Preemption: demote all of a request's HBM blocks."""
        dt = 0.0
        for bid in self.table.get(rid, []):
            if self.blocks[bid].tier == "hbm":
                dt += self._demote(bid, op="demote", cause="preempt")
        self.preempt_swaps += 1
        return self._charge(dt)

    # ------------------------------------------------------------------
    # prefix-cache support: pinning + block-ownership transfer

    def pin(self, rid: int):
        """Exempt a rid's blocks from HBM eviction (refcounted prefix
        blocks that running requests read every step). Pinning never
        *promotes* — callers pair it with :meth:`ensure_resident`."""
        self.pinned.add(rid)
        for bid in self.table.get(rid, []):
            self._emit("pin", self.blocks[bid], chrome=False)

    def unpin(self, rid: int):
        self.pinned.discard(rid)
        for bid in self.table.get(rid, []):
            self._emit("unpin", self.blocks[bid], chrome=False)

    def adopt_blocks(self, src_rid: int, dst_rid: int, nblocks: int, *,
                     start_block: int = 0):
        """Transfer ``nblocks`` whole blocks of ``src_rid``'s table
        (starting at ``start_block``) to ``dst_rid``. Pure ownership
        metadata — no bytes move between tiers, so nothing is charged.
        The prefix cache uses this to (a) donate a finished prefill's
        full prompt blocks to a radix node and (b) partition a node's
        blocks when a copy-on-write split forks the edge."""
        blocks = self.table[src_rid]
        assert 0 <= start_block and start_block + nblocks <= len(blocks)
        moved = blocks[start_block:start_block + nblocks]
        del blocks[start_block:start_block + nblocks]
        for bid in moved:
            if self.prefetch is not None:
                # ownership changes mid-flight: a DMA issued against the
                # old owner must not land (and charge its stall) under
                # the new rid — without this a completed transfer could
                # promote into a rid whose session no longer exists
                self.prefetch.cancel(("kv", bid))
            self.blocks[bid].rid = dst_rid
            self._emit("adopt", self.blocks[bid], chrome=False,
                       cause=f"from:{src_rid}")
        self.table.setdefault(dst_rid, []).extend(moved)
        moved_tokens = nblocks * self.block_tokens
        self.tokens[src_rid] = max(self.tokens[src_rid] - moved_tokens, 0)
        self.tokens[dst_rid] = self.tokens.get(dst_rid, 0) + moved_tokens

    def free(self, rid: int):
        """Release a finished request's blocks from every tier."""
        self.pinned.discard(rid)
        self._providers.pop(rid, None)
        self._next_tok0.pop(rid, None)
        for bid in self.table.pop(rid, []):
            blk = self.blocks.pop(bid)
            self._emit("free", blk, chrome=False)
            if self.prefetch is not None:
                self.prefetch.cancel(("kv", bid))
            if blk.tier == "hbm":
                self._hbm_lru.pop(bid, None)
                self.hbm_used -= blk.nbytes
            elif blk.tier == "dram":
                self.dram.drop(bid)
            elif blk.tier == "ssd":
                self.ssd.delete_layer(bid, flush_meta=False)
        self.tokens.pop(rid, None)

    # ------------------------------------------------------------------
    def over_budget(self) -> bool:
        return self.hbm_used > self.hbm_capacity

    def can_admit(self, ntokens: int, protect: Iterable[int] = ()) -> bool:
        """Room for a request's blocks given protected (running) blocks?
        Pinned (refcounted prefix) blocks count as protected too."""
        protect = set(protect) | self.pinned
        protected = sum(self.blocks[b].nbytes for b in self._hbm_lru
                        if self.blocks[b].rid in protect)
        need = self.blocks_for(ntokens) * self.block_bytes
        return protected + need <= self.hbm_capacity

    def stats(self) -> Dict[str, float]:
        return {
            "kv_hbm_used_bytes": self.hbm_used,
            "kv_dram_used_bytes": float(self.dram.used_bytes),
            "kv_ssd_blocks": sum(1 for b in self.blocks.values()
                                 if b.tier == "ssd"),
            "kv_blocks": len(self.blocks),
            "kv_real_payload_blocks": sum(
                1 for b in self.blocks.values() if b.real),
            "kv_swap_out_bytes": self.swap_out_bytes,
            "kv_swap_in_bytes": self.swap_in_bytes,
            "kv_ssd_write_bytes": self.ssd.bytes_written * self.byte_scale,
            "kv_ssd_read_bytes": self.ssd.bytes_read * self.byte_scale,
            "kv_swap_s": self.swap_s,
            "kv_preempt_swaps": self.preempt_swaps,
            "kv_pinned_bytes": sum(
                self.blocks[b].nbytes for r in self.pinned
                for b in self.table.get(r, [])),
            "kv_prefetch_issued_bytes": self.prefetch_issued_bytes,
            "kv_prefetch_overlap_bytes": self.prefetch_overlap_bytes,
            "kv_prefetch_stall_s": self.prefetch_stall_s,
            "kv_resume_sync_s": self.resume_sync_s,
            # clock seconds paid waiting on KV residency, prefetched or not
            "kv_stall_s": self.resume_sync_s + self.prefetch_stall_s,
            # mixed-precision tiers: transfer bytes avoided vs full-width
            # paging, the fp16-equivalent bytes behind SSD spill writes
            # (capacity-stretch numerator vs kv_ssd_write_bytes), and the
            # live stored-vs-full footprint of the flash tier
            "kv_quant_enabled": 1.0 if self.quantized else 0.0,
            "kv_transfer_saved_bytes": self.quant_saved_bytes,
            "kv_ssd_write_full_bytes": self.ssd_write_full_bytes,
            "kv_ssd_stored_bytes": sum(
                b.nbytes for b in self.blocks.values()
                if b.tier == "ssd"),
            "kv_ssd_full_bytes": sum(
                b.full_nbytes for b in self.blocks.values()
                if b.tier == "ssd"),
            "kv_blocks_int8": sum(1 for b in self.blocks.values()
                                  if b.precision == "int8"),
            "kv_blocks_int4": sum(1 for b in self.blocks.values()
                                  if b.precision == "int4"),
            # fault injection + graceful degradation (docs/RELIABILITY.md)
            "kv_ssd_quarantined": 1.0 if self.ssd_quarantined else 0.0,
            "kv_ssd_read_retries": self.ssd_read_retries,
            "kv_ssd_write_retries": self.ssd_write_retries,
            "kv_ssd_write_aborts": self.ssd_write_aborts,
            "kv_retry_backoff_s": self.retry_backoff_s,
            "kv_checksum_failures": self.checksum_failures,
            "kv_blocks_lost": self.blocks_lost,
            "kv_provider_faults": self.provider_faults,
            "kv_prefetch_skips": self.prefetch_skips,
            "kv_dram_overcommit_bytes": self.dram_overcommit_max,
            "kv_ssd_probes": self.ssd_probes,
            "kv_ssd_probe_failures": self.ssd_probe_failures,
            "kv_ssd_rejoins": self.ssd_rejoins,
        }
