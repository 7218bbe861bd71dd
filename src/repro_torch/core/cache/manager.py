"""Multi-level cache manager: HBM(ATU) / DRAM(two-level) / SSD + transfer
clock (paper §5 Fig. 2).

The manager advances a modeled clock per layer per token:

  t_layer = max(t_compute, t_hbm_load) + t_ssd_stall

i.e. DRAM→HBM neuron loads overlap compute (the paper's asynchronous
loading via dedicated CUDA streams → here async DMA), and SSD→DRAM preloads
overlap everything except when the compute front catches an unfinished load.

Real byte movement happens through the SSDTier (memmap I/O) and numpy
copies; the *clock* prices them with the paper's testbed bandwidths
(core/hw.py), so modeled token rates are comparable with the paper's Fig. 9
even though this container has no GPU.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, deque
from typing import Dict, Optional, Sequence


from repro_torch.core.cache.dram_cache import DRAMCache
from repro_torch.core.cache.hbm_cache import HBMCache
from repro_torch.core.cache.preloader import Preloader, PrefetchEngine
from repro_torch.core.cache.ssd_tier import SSDTier
from repro_torch.core.hw import HOST, HostHW
from repro_torch.core.quantize import bytes_per_neuron


@dataclasses.dataclass
class TokenReport:
    modeled_s: float
    compute_s: float
    hbm_load_s: float
    ssd_stall_s: float
    bytes_hbm: float
    bytes_ssd: int
    hbm_hit_ratio: float
    # cost-term decomposition for the span profiler (defaulted so older
    # call sites constructing TokenReport directly stay valid)
    hbm_read_s: float = 0.0       # HBM weight-read stream time
    kernel_launch_s: float = 0.0  # per-layer dispatch launch overhead


class MultiLevelCacheManager:
    """Drives the tiered caches for one model during decoding."""

    def __init__(self, *, num_layers: int, d_model: int, d_ff: int,
                 active_per_layer: int, ssd: SSDTier,
                 dram_capacity_bytes: int, n_fixed: int = 2,
                 hbm_policy: str = "atu", use_ssd: bool = True,
                 lookahead: int = 2, hw: HostHW = HOST,
                 layer_flops: float = 0.0, byte_scale: float = 1.0,
                 ssd_miss_frac: float = 1.0,
                 prefetch: Optional[PrefetchEngine] = None):
        self.num_layers = num_layers
        self.d_model = d_model
        self.hw = hw
        self.use_ssd = use_ssd
        self.ssd = ssd
        self.dram = DRAMCache(dram_capacity_bytes, n_fixed=n_fixed,
                              byte_scale=byte_scale)
        self.hbm = HBMCache(num_layers, active_per_layer, d_model,
                            policy=hbm_policy)
        self.preloader = Preloader(ssd, self.dram, num_layers=num_layers,
                                   ssd_bw=hw.ssd_bw, lookahead=lookahead,
                                   byte_scale=byte_scale,
                                   miss_frac=ssd_miss_frac,
                                   prefetch=prefetch)
        self.layer_flops = layer_flops
        # per-process_token dispatch cost records for the span profiler /
        # time ledger (bounded; the serving scheduler drains it per step)
        self.dispatch_log: deque = deque(maxlen=4096)
        self.clock = 0.0
        if not use_ssd:
            # whole model pinned in DRAM (paper ablation "+LRU Cache" stage)
            for l in range(num_layers):
                self.dram.insert(l, ssd.read_layer(l))
                self.dram.n_fixed = num_layers   # pin everything
        else:
            self.clock = self.preloader.warmup(0.0)

    # ------------------------------------------------------------------
    def compute_time(self, active: int, tiers: Dict[int, str]) -> float:
        """Modeled GPU time for one layer's sparse FFN."""
        flops = self.layer_flops if self.layer_flops else \
            6.0 * active * self.d_model   # 3 matvecs, 2 flops/MAC
        return flops / (self.hw.flops * self.hw.flop_util)

    def process_token(self, active_sets: Sequence[Sequence[int]],
                      tier_maps: Sequence[Dict[int, str]],
                      batch_size: int = 1) -> TokenReport:
        """One decode step: per layer, update caches and advance the clock.

        active_sets[l] — the predictor's active neuron ids for layer l
        (rank-sorted); tier_maps[l] — neuron id -> precision tier. With
        ``batch_size`` > 1 the step serves one token for each of B batched
        sequences: compute scales with B while weight traffic (HBM loads,
        SSD preloads) is paid once — the continuous-batching amortisation.
        """
        t_compute = t_hbm = t_stall = 0.0
        t_read = t_launch = 0.0
        bytes_hbm = 0.0
        ssd_before = self.ssd.bytes_read
        clock_before = self.clock
        for l in range(self.num_layers):
            now = self.clock
            stall = self.preloader.step(l, now) if self.use_ssd else 0.0
            s = self.hbm.update_layer(l, active_sets[l], tier_maps[l])
            # paper Fig. 5: neuron-granular HBM copies run below peak PCIe
            load_s = s.bytes_loaded \
                / (self.hw.pcie_bw * self.hw.pcie_scatter_eff) \
                + s.copies * 5e-6            # per-copy launch latency
            comp_s = self.compute_time(len(active_sets[l]), tier_maps[l]) \
                * batch_size
            # decode is bandwidth-bound: the layer's kernels stream the
            # active set's mixed-precision bytes from HBM once per
            # dispatch — the term continuous batching amortises across
            # the batch (a per-session dispatch re-reads it per session)
            tier_counts = Counter(tier_maps[l].values())
            read_s = sum(c * bytes_per_neuron(self.d_model, t)
                         for t, c in tier_counts.items()) \
                / (self.hw.hbm_bw * self.hw.mem_util)
            layer_s = max(comp_s, load_s, read_s) + stall \
                + self.hw.kernel_launch_s
            self.clock += layer_s
            t_compute += comp_s
            t_hbm += load_s
            t_stall += stall
            t_read += read_s
            t_launch += self.hw.kernel_launch_s
            bytes_hbm += s.bytes_loaded
        total = self.hbm.total
        denom = total.loaded + total.hit
        self.dispatch_log.append({
            "t0": clock_before, "t1": self.clock, "batch": batch_size,
            "compute_s": t_compute, "hbm_load_s": t_hbm,
            "hbm_read_s": t_read, "kernel_launch_s": t_launch,
            "stall_s": t_stall})
        return TokenReport(
            modeled_s=self.clock - clock_before,
            compute_s=t_compute, hbm_load_s=t_hbm, ssd_stall_s=t_stall,
            bytes_hbm=bytes_hbm,
            bytes_ssd=int((self.ssd.bytes_read - ssd_before)
                          * self.preloader.byte_scale),
            hbm_hit_ratio=(total.hit / denom if denom else 0.0),
            hbm_read_s=t_read, kernel_launch_s=t_launch)

    def drain_dispatch_log(self) -> list:
        """Pop and return the accumulated dispatch cost records."""
        out = list(self.dispatch_log)
        self.dispatch_log.clear()
        return out


def zero_infinity_token_time(*, num_layers: int, layer_bytes_fp16: float,
                             layer_flops: float, hw: HostHW = HOST,
                             batch_size: int = 1) -> float:
    """Modeled per-step latency of the ZeRO-Inference baseline: every layer's
    full FP16 weights stream HBM←DRAM/SSD each step (no sparsity, no reuse —
    bandwidth-overwhelming by construction). ``batch_size`` scales compute
    only; the weight stream is paid once per step."""
    per_layer_io = layer_bytes_fp16 / hw.pcie_bw
    per_layer_compute = batch_size * layer_flops / (hw.flops * hw.flop_util)
    return num_layers * max(per_layer_io, per_layer_compute)
