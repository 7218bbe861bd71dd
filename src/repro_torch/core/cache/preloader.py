"""Async prefetch engine + pattern-aware SSD→DRAM weight preloader.

Two layers:

* :class:`PrefetchEngine` — a generic modeled-clock DMA model shared by
  *weights* and *KV* prefetch. Each named channel (``"ssd"`` for
  flash→DRAM, ``"pcie"`` for DRAM→HBM) is a serial transfer queue with
  its own bandwidth: a transfer issued at modeled time *t* starts at
  ``max(t, channel_free)`` and finishes after ``nbytes / bw``. Consumers
  issue transfers ahead of need and later ``wait()`` on them; the wait
  returns only the *residual* stall — zero when the transfer fully
  overlapped with compute. Weight preloads and KV block promotions share
  the same channels, so flash-bus contention between the two is modeled
  (one NVMe serves both).
* :class:`Preloader` — the paper's §5.4 layer-wise SSD→DRAM weight
  preloader, now sitting on a :class:`PrefetchEngine` channel. The paper
  measures one-layer SSD→DRAM load ≈ 2× one-layer compute, so the
  preloader keeps ``lookahead`` layers of headroom ahead of the compute
  front (≥2). Loads are *layer-wise* (neuron-level preloading needs
  multi-layer activation prediction whose accuracy decays — §5.4), but
  only the neurons *missing* from DRAM are fetched when a layer is
  partially resident.

The clock charges a stall only when the compute front catches up with an
unfinished transfer; bytes that arrived in time are counted as
*overlapped* — the quantity benchmarks and carbon accounting report.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class PrefetchStats:
    """Aggregate transfer accounting for one engine (or one channel)."""
    issued: int = 0               # transfers enqueued
    issued_bytes: float = 0.0     # real bytes enqueued
    overlapped_bytes: float = 0.0  # bytes that arrived before they were needed
    stalled_bytes: float = 0.0    # bytes the compute front had to wait on
    stall_s: float = 0.0          # total residual wait (modeled s)
    waits: int = 0                # wait() calls that found a transfer
    hits: int = 0                 # waits that found it already complete
    dma_stalls: int = 0           # injected channel stalls (faults)
    dma_failures: int = 0         # injected transfer failures (faults)
    retransfer_s: float = 0.0     # synchronous redo time after in-flight
    #                               failures (subset of stall_s — lets the
    #                               ledger carve DMA retransfer out of the
    #                               stall category it is billed inside)


class PrefetchEngine:
    """Modeled async DMA: named serial channels + keyed in-flight transfers.

    All times are modeled-clock seconds. A transfer is identified by an
    arbitrary hashable ``key`` (weights use ``("w", layer)``, KV uses
    ``("kv", block_id)``); re-issuing a key replaces the old record.
    ``wait`` pops the record, so each transfer's bytes are classified
    exactly once as overlapped or stalled.
    """

    def __init__(self):
        self._bw: Dict[str, float] = {}
        self._free_at: Dict[str, float] = {}
        self._inflight: Dict[object, Tuple[float, float]] = {}  # key -> (ready, bytes)
        self._inflight_ch: Dict[object, str] = {}               # key -> channel
        self.stats = PrefetchStats()
        # optional obs hook: one "dma:<channel>" span per transfer (its
        # modeled bus occupancy) + a stall instant when the compute front
        # catches an unfinished transfer
        self._recorder = None
        # optional fault injector (repro.serving.faults.FaultInjector):
        # "dma.stall" delays a transfer's finish time, "dma.fail" kills
        # the transfer so the waiter must redo it synchronously — a time
        # cost only, never data loss (payloads move host-side)
        self._faults = None
        self._failed: set = set()

    def attach_trace(self, recorder):
        """Record every transfer as a span on track ``dma:<channel>`` in
        ``recorder`` (a :class:`repro.obs.TraceRecorder`)."""
        self._recorder = recorder

    def attach_faults(self, injector):
        """Consult ``injector`` at issue time for DMA stalls/failures."""
        self._faults = injector

    def add_channel(self, name: str, bw: float):
        """Register (or re-register) a channel; idempotent per name."""
        if name not in self._bw:
            self._bw[name] = float(bw)
            self._free_at[name] = 0.0

    def has_channel(self, name: str) -> bool:
        return name in self._bw

    def channel_free_at(self, name: str) -> float:
        return self._free_at[name]

    def issue(self, channel: str, key, nbytes: float, now: float, *,
              not_before: float = 0.0) -> float:
        """Enqueue ``nbytes`` on ``channel`` at modeled time ``now``;
        returns the finish time. ``not_before`` chains transfers (e.g.
        SSD→DRAM must land before DRAM→HBM starts)."""
        start = max(now, self._free_at[channel], not_before)
        finish = start + nbytes / self._bw[channel]
        if self._faults is not None:
            rule = self._faults.fire("dma.stall",
                                     detail={"channel": channel,
                                             "key": str(key)})
            if rule is not None:
                # the channel hiccups: this transfer (and everything
                # queued behind it) lands rule.stall_s late
                finish += max(rule.stall_s, 0.0)
                self.stats.dma_stalls += 1
            if self._faults.fire("dma.fail",
                                 detail={"channel": channel,
                                         "key": str(key)}) is not None:
                # the transfer dies in flight; wait() redoes it
                # synchronously and charges the full retransfer
                self._failed.add(key)
                self.stats.dma_failures += 1
        self._free_at[channel] = finish
        self._inflight[key] = (finish, float(nbytes))
        self._inflight_ch[key] = channel
        self.stats.issued += 1
        self.stats.issued_bytes += nbytes
        if self._recorder is not None:
            self._recorder.span(f"dma:{channel}", "xfer", start, finish,
                                key=str(key), nbytes=float(nbytes),
                                issued_at=now)
        return finish

    def in_flight(self, key) -> bool:
        return key in self._inflight

    def ready_at(self, key) -> Optional[float]:
        rec = self._inflight.get(key)
        return rec[0] if rec is not None else None

    def transfer_bytes(self, key) -> float:
        """Bytes of an in-flight transfer (0 when unknown)."""
        rec = self._inflight.get(key)
        return rec[1] if rec is not None else 0.0

    def wait(self, key, now: float) -> float:
        """Compute front needs ``key`` at ``now``: pop the record and
        return the residual stall (0 when fully overlapped). Unknown keys
        stall nothing — the caller pays its synchronous path instead."""
        rec = self._inflight.pop(key, None)
        if rec is None:
            return 0.0
        channel = self._inflight_ch.pop(key, "?")
        ready, nbytes = rec
        self.stats.waits += 1
        if key in self._failed:
            # injected in-flight failure: the bytes never arrived, so
            # the waiter redoes the transfer synchronously from `now`
            self._failed.discard(key)
            stall = nbytes / self._bw.get(channel, float("inf"))
            self.stats.stall_s += stall
            self.stats.retransfer_s += stall
            self.stats.stalled_bytes += nbytes
            if self._recorder is not None:
                self._recorder.span(f"dma:{channel}", "retransfer", now,
                                    now + stall, key=str(key),
                                    nbytes=float(nbytes))
            return stall
        stall = max(ready - now, 0.0)
        if stall > 0.0:
            self.stats.stall_s += stall
            self.stats.stalled_bytes += nbytes
            if self._recorder is not None:
                self._recorder.span(f"dma:{channel}", "stall", now, ready,
                                    key=str(key), nbytes=float(nbytes))
        else:
            self.stats.hits += 1
            self.stats.overlapped_bytes += nbytes
        return stall

    def cancel(self, key):
        """Drop an in-flight record (e.g. the block was evicted before
        use, or its ownership moved to another rid). Issued bytes stay
        counted — the bus time was spent."""
        self._inflight.pop(key, None)
        self._inflight_ch.pop(key, None)
        self._failed.discard(key)

    def snapshot(self) -> PrefetchStats:
        return dataclasses.replace(self.stats)


#: channel names shared by weight preloading and KV paging
SSD_CHANNEL = "ssd"
PCIE_CHANNEL = "pcie"


@dataclasses.dataclass
class PreloadStats:
    layers_loaded: int = 0
    bytes_loaded: int = 0
    stall_s: float = 0.0
    overlapped_bytes: float = 0.0


class Preloader:
    """Layer-wise SSD→DRAM weight preloader on a PrefetchEngine channel."""

    def __init__(self, ssd, dram, *, num_layers: int,
                 ssd_bw: float, lookahead: int = 2,
                 byte_scale: float = 1.0, miss_frac: float = 1.0,
                 prefetch: Optional[PrefetchEngine] = None):
        self.ssd = ssd
        self.dram = dram
        self.num_layers = num_layers
        self.ssd_bw = ssd_bw
        self.byte_scale = byte_scale
        # paper §5.4: re-loads of a previously-resident layer fetch only the
        # neurons *missing* from DRAM (≈ the active set at its mixed-
        # precision bytes), not the whole bank file. First-touch loads are
        # full.
        self.miss_frac = miss_frac
        self._seen = set()
        self.lookahead = max(lookahead, 1)
        self.stats = PreloadStats()
        self.engine = prefetch if prefetch is not None else PrefetchEngine()
        self.engine.add_channel(SSD_CHANNEL, ssd_bw)

    def _key(self, layer: int):
        return ("w", layer)

    def _load(self, layer: int, now: float) -> float:
        """Queue one layer's SSD→DRAM load; returns its finish time."""
        banks = self.ssd.read_layer(layer)
        frac = self.miss_frac if layer in self._seen else 1.0
        self._seen.add(layer)
        nbytes = sum(a.nbytes for a in banks.values()) * self.byte_scale \
            * frac
        finish = self.engine.issue(SSD_CHANNEL, self._key(layer), nbytes,
                                   now)
        self.dram.insert(layer, banks)
        self.stats.layers_loaded += 1
        self.stats.bytes_loaded += nbytes
        return finish

    def warmup(self, now: float = 0.0) -> float:
        """Before the first token: fill the fixed area + lookahead window.
        Returns the modeled time when layer 0 is ready."""
        ready = now
        first = min(self.dram.n_fixed + self.lookahead, self.num_layers)
        for l in range(first):
            if l not in self.dram:
                f = self._load(l, now)
                if l == 0:
                    ready = f
        return ready

    def step(self, current_layer: int, now: float) -> float:
        """Called as compute enters ``current_layer``; kicks off the
        lookahead load and returns the stall (s) if the *current* layer's
        data has not finished arriving."""
        key = self._key(current_layer)
        # ensure current layer resident (miss -> synchronous fetch = stall);
        # .get() also feeds the DRAM hit/miss statistics
        if self.dram.get(current_layer) is None:
            self._load(current_layer, now)
        # in DRAM, but the async transfer may still be in flight
        nbytes = self.engine.transfer_bytes(key)
        stall = self.engine.wait(key, now)
        if nbytes and stall == 0.0:
            self.stats.overlapped_bytes += nbytes
        # fire lookahead for layer+k (wraps to next token's early layers)
        tgt = current_layer + self.lookahead
        tgt_wrapped = tgt % self.num_layers
        if tgt_wrapped not in self.dram:
            self._load(tgt_wrapped, now)
        self.stats.stall_s += stall
        return stall
