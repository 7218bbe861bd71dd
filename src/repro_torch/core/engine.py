"""M2Cache serving engine (paper Fig. 2) + ZeRO-Inference baseline — the
closed-loop ``generate`` path of ``repro/core/engine.py``.

Two execution modes:

* **real** — a materialised model decodes with the M2Cache forward on the
  engine's device; the *actual* predictor active sets drive the multi-level
  cache manager, whose transfer clock prices every byte with the paper's
  testbed bandwidths (``core/hw.py``). Numerics and cache behaviour are
  real; only the clock is modeled.
* **analytic** — paper-scale models (LLaMA-7B/13B/70B, Falcon-40B) whose
  active sets are sampled from the adjacent-token overlap process (paper
  Fig. 6, ~80 %); the same manager produces modeled token rates / carbon.

Baseline: ``mode="zero_infinity"`` streams every layer's full FP16 weights
per token. The step-level scheduler API of the reference (``begin_prefill``
… ``decode_step``) comes with the server's path.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
import types
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import carbon as carbon_mod
from repro_torch.core.cache.manager import (MultiLevelCacheManager,
                                            zero_infinity_token_time)
from repro_torch.core.cache.preloader import (PCIE_CHANNEL, SSD_CHANNEL,
                                              PrefetchEngine)
from repro_torch.core.cache.ssd_tier import SSDTier
from repro_torch.core.hw import HOST, HostHW
from repro_torch.core.mp_ffn import tier_sizes


@dataclasses.dataclass
class PaperModel:
    """Geometry of the paper's evaluation models (analytic mode)."""
    name: str
    num_layers: int
    d_model: int
    d_ff: int


PAPER_MODELS = {
    "llama-7b": PaperModel("llama-7b", 32, 4096, 11008),
    "llama-13b": PaperModel("llama-13b", 40, 5120, 13824),
    "llama-70b": PaperModel("llama-70b", 80, 8192, 28672),
    "falcon-40b": PaperModel("falcon-40b", 60, 8192, 32768),
}


@dataclasses.dataclass
class GenerationResult:
    tokens: Optional[np.ndarray]
    modeled_s: float
    wall_s: float
    tokens_generated: int
    token_reports: list
    cache_stats: Dict[str, float]
    carbon: Dict[str, float]

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.modeled_s if self.modeled_s else 0.0


def _tier_map(idx: Sequence[int], sizes: Dict[str, int]) -> Dict[int, str]:
    out = {}
    for rank, nid in enumerate(idx):
        if rank < sizes["fp16"]:
            out[int(nid)] = "fp16"
        elif rank < sizes["fp16"] + sizes["int8"]:
            out[int(nid)] = "int8"
        else:
            out[int(nid)] = "int4"
    return out


class OverlapProcess:
    """Adjacent-token active-set process with controllable overlap
    (analytic mode; calibrated to paper Fig. 6's ~80 %)."""

    def __init__(self, f: int, k: int, overlap: float, seed: int = 0):
        self.f, self.k, self.overlap = f, k, overlap
        self.rng = np.random.default_rng(seed)
        self.current = self.rng.choice(f, size=k, replace=False)

    def step(self) -> np.ndarray:
        keep = max(int(self.k * self.overlap), 0)
        kept = self.rng.choice(self.current, size=keep, replace=False)
        pool = np.setdiff1d(np.arange(self.f), kept, assume_unique=False)
        fresh = self.rng.choice(pool, size=self.k - keep, replace=False)
        self.current = np.concatenate([kept, fresh])
        self.rng.shuffle(self.current)
        return self.current


class M2CacheEngine:
    def __init__(self, cfg=None, params=None, *, paper_model: str = None,
                 mode: str = "m2cache", hbm_policy: str = "atu",
                 use_ssd: bool = True, ssd_dir: Optional[str] = None,
                 dram_capacity_gb: float = 56.0, hw: HostHW = HOST,
                 overlap: float = 0.8, device_name: str = "rtx3090",
                 seed: int = 0, device=None):
        """``device`` is where a real model computes (``cuda`` unless
        ``cpu`` is asked for); ``params`` must already live there.
        ``device_name`` names the modeled accelerator of the carbon model."""
        assert mode in ("m2cache", "zero_infinity")
        assert (cfg is not None) != (paper_model is not None)
        self.cfg = cfg
        self.paper = PAPER_MODELS[paper_model] if paper_model else None
        self.params = params
        self.device = resolve_device(device) if params is not None else None
        self.mode = mode
        self.hbm_policy = hbm_policy
        self.use_ssd = use_ssd
        self.hw = hw
        self.overlap = overlap
        self.device_name = device_name
        self.seed = seed
        from repro_torch.core.kv_payload import supports_payloads
        self.supports_kv_payloads = (params is not None
                                     and mode == "m2cache"
                                     and supports_payloads(cfg))
        self._ssd_dir = ssd_dir or tempfile.mkdtemp(prefix="m2cache_ssd_")
        # one modeled async-DMA engine shared by weight preloads and KV
        # prefetch — both ride the same flash bus and PCIe link
        self.prefetch = PrefetchEngine()
        self.prefetch.add_channel(SSD_CHANNEL, hw.ssd_bw)
        self.prefetch.add_channel(PCIE_CHANNEL, hw.pcie_bw)
        self.runner = None               # real mode: runner of the last generate()

        if cfg is not None:
            self.num_layers = cfg.num_layers
            self.d_model, self.d_ff = cfg.d_model, cfg.d_ff
        else:
            self.num_layers = self.paper.num_layers
            self.d_model, self.d_ff = self.paper.d_model, self.paper.d_ff

        ratio_holder = cfg if cfg is not None else types.SimpleNamespace(
            m2_active_ratio=0.30, m2_ratio_fp16=0.25, m2_ratio_int8=0.25,
            m2_ratio_int4=0.50)
        self.sizes = tier_sizes(max(self.d_ff, 8), ratio_holder)

        self.ssd = SSDTier(self._ssd_dir)
        self._file_byte_scale = 1.0
        self._populate_ssd()
        self.manager = None
        if mode == "m2cache":
            self.manager = MultiLevelCacheManager(
                num_layers=self.num_layers, d_model=self.d_model,
                d_ff=self.d_ff, active_per_layer=self.sizes["k"],
                ssd=self.ssd,
                dram_capacity_bytes=int(dram_capacity_gb * 2**30),
                hbm_policy=hbm_policy, use_ssd=use_ssd, hw=hw,
                layer_flops=self._layer_flops_sparse(),
                byte_scale=self._file_byte_scale,
                ssd_miss_frac=self._ssd_miss_frac(),
                prefetch=self.prefetch)

    # ------------------------------------------------------------------
    def _ssd_miss_frac(self) -> float:
        """Steady-state SSD fetch fraction when a layer is re-loaded:
        only the active set's mixed-precision bytes are missing (paper
        §5.4), relative to the full 3-bank file (3.5 B/param)."""
        k = self.sizes
        if k["k"] == 0 or self.d_ff == 0:
            return 1.0
        active_bytes = (k["fp16"] * 2.0 + k["int8"] * 1.0 + k["int4"] * 0.5)
        return min(1.0, active_bytes / (self.d_ff * 3.5))

    def _layer_bytes_fp16(self) -> float:
        """Full FP16 weight bytes per layer (FFN + attn-ish share)."""
        ffn = 3 * self.d_model * self.d_ff * 2
        attn = 4 * self.d_model * self.d_model * 2 * 0.35   # GQA-ish share
        return ffn + attn

    def _layer_flops_dense(self) -> float:
        return 2 * (3 * self.d_model * self.d_ff
                    + 4 * self.d_model * self.d_model * 0.35)

    def _layer_flops_sparse(self) -> float:
        k = self.sizes["k"]
        return 2 * (3 * self.d_model * k
                    + 4 * self.d_model * self.d_model * 0.35)

    def _populate_ssd(self):
        """Write per-layer neuron banks to flash. Real mode persists the
        actual quantized banks (the fp bank's bytes in whatever dtype it
        has); analytic mode writes right-sized surrogates (same byte
        layout) so file I/O costs are real either way."""
        if self.ssd.tensors_of(0):
            return                                    # already populated
        if self.params is not None and self.cfg.m2_enabled:
            from repro_torch.core.engine_model import extract_layer_banks
            for l, banks in enumerate(extract_layer_banks(self.cfg,
                                                          self.params)):
                self.ssd.write_layer(l, banks)
            return
        d, f = self.d_model, self.d_ff
        if f == 0:                                     # attn-free (mamba2)
            d_in = self.d_model * 4
            for l in range(self.num_layers):
                self.ssd.write_layer(l, {
                    "w": np.zeros((d, d_in), np.float16)})
            return
        scale = 1.0 if self.paper is None else \
            min(1.0, 2**21 / (d * f))              # cap analytic file size
        fd = max(int(f * scale), 64)
        dd = max(int(d * scale), 64)
        # remember the byte-downscale so DRAM stats report real sizes
        self._file_byte_scale = (d * f) / (dd * fd)
        for l in range(self.num_layers):
            self.ssd.write_layer(l, {
                "wg_fp": np.zeros((dd, fd), np.float16),
                "wu_fp": np.zeros((dd, fd), np.float16),
                "wd_fp": np.zeros((fd, dd), np.float16),
                "wg_i8": np.zeros((dd, fd), np.int8),
                "wu_i8": np.zeros((dd, fd), np.int8),
                "wd_i8": np.zeros((fd, dd), np.int8),
                "wg_i4": np.zeros((dd // 2, fd), np.int8),
                "wu_i4": np.zeros((dd // 2, fd), np.int8),
                "wd_i4": np.zeros((fd, dd // 2), np.int8),
            })

    @property
    def clock(self) -> float:
        """Modeled serving clock (s)."""
        return self.manager.clock if self.manager is not None else 0.0

    def _union_active(self, rows_per_layer) -> tuple:
        """Batch union per layer of (G, k) rank-sorted active ids: a
        neuron's tier comes from its rank at its first occurrence in
        row-major order (``repro/core/engine.py``'s rule)."""
        names = ("fp16", "int8", "int4")
        sets, tiers = [], []
        for rows in rows_per_layer:
            rows = np.asarray(rows)
            if rows.size == 0:
                sets.append([])
                tiers.append({})
                continue
            G, k = rows.shape
            ranks = np.arange(k)
            codes = np.where(ranks < self.sizes["fp16"], 0,
                             np.where(ranks < self.sizes["fp16"]
                                      + self.sizes["int8"], 1, 2))
            uniq, first = np.unique(rows.reshape(-1).astype(np.int64),
                                    return_index=True)
            tcode = np.tile(codes, G)[first]
            sets.append(uniq)
            tiers.append({int(n): names[c]
                          for n, c in zip(uniq, tcode)})
        return sets, tiers

    def _analytic_step(self, procs):
        """One modeled decode step of one analytic session (the analytic
        branch of the reference's ``decode_step``)."""
        rows = [[pr.step() for pr in procs]] if procs else []
        if rows:
            per_layer = [np.stack([r[l] for r in rows])
                         for l in range(self.num_layers)]
        else:
            per_layer = [np.zeros((0, 0), np.int64)] * self.num_layers
        sets, tiers = self._union_active(per_layer)
        return self.manager.process_token(sets, tiers, batch_size=1)

    # ------------------------------------------------------------------
    def generate(self, prompts=None, gen_len: int = 32,
                 prompt_len: int = 64) -> GenerationResult:
        t0 = time.time()
        if self.mode == "zero_infinity":
            return self._generate_zero_infinity(gen_len, t0)
        if self.params is not None:
            return self._generate_real(prompts, gen_len, t0)
        return self._generate_analytic(gen_len, t0)

    def _finish(self, tokens, modeled_s, reports, t0, gen_len,
                compute_frac) -> GenerationResult:
        # dram.used_bytes is already real-scaled via byte_scale
        dram_gb = (self.manager.dram.used_bytes / 2**30
                   if self.manager else
                   self.num_layers * self._layer_bytes_fp16() / 2**30)
        carbon = carbon_mod.total_carbon(
            modeled_s, device_name=self.device_name,
            accelerator_util=compute_frac, dram_gb=dram_gb,
            ssd_active=self.use_ssd)
        stats = {}
        if self.manager:
            stats = {
                "hbm_hit_ratio": self.manager.hbm.hit_ratio,
                "dram_hit_ratio": self.manager.dram.hit_ratio,
                "ssd_bytes_read": int(self.ssd.bytes_read
                                      * self._file_byte_scale),
                "hbm_bytes_loaded": self.manager.hbm.total.bytes_loaded,
                "dram_used_gb": dram_gb,
            }
        return GenerationResult(
            tokens=tokens, modeled_s=modeled_s, wall_s=time.time() - t0,
            tokens_generated=gen_len, token_reports=reports,
            cache_stats=stats, carbon=carbon)

    def _generate_zero_infinity(self, gen_len, t0) -> GenerationResult:
        per_tok = zero_infinity_token_time(
            num_layers=self.num_layers,
            layer_bytes_fp16=self._layer_bytes_fp16(),
            layer_flops=self._layer_flops_dense(), hw=self.hw)
        modeled = per_tok * gen_len
        comp = self._layer_flops_dense() * self.num_layers \
            / (self.hw.flops * self.hw.flop_util)
        return self._finish(None, modeled, [], t0, gen_len,
                            compute_frac=min(comp / per_tok, 1.0))

    def _generate_analytic(self, gen_len, t0,
                           prime_tokens: int = 2) -> GenerationResult:
        """Steady-state rate: ``prime_tokens`` warm the caches and are
        excluded from the measured window."""
        procs = [OverlapProcess(self.d_ff, self.sizes["k"], self.overlap,
                                seed=self.seed + l)
                 for l in range(self.num_layers)]
        reports = [self._analytic_step(procs)
                   for _ in range(gen_len + prime_tokens)]
        reports = reports[prime_tokens:]
        modeled = sum(r.modeled_s for r in reports)
        comp = sum(r.compute_s for r in reports)
        return self._finish(None, modeled, reports, t0, gen_len,
                            compute_frac=min(comp / max(modeled, 1e-12), 1.0))

    def _generate_real(self, prompts, gen_len, t0) -> GenerationResult:
        from repro_torch.core.engine_model import RealModelRunner
        runner = RealModelRunner(self.cfg, self.params,
                                 max_seq=prompts.shape[-1] + gen_len + 1,
                                 device=self.device)
        self.runner = runner
        tokens, idx_per_step = runner.generate(prompts, gen_len)
        reports = []
        for step_idx in idx_per_step:                  # list over tokens
            sets = [np.asarray(i) for i in step_idx]
            tiers = [_tier_map(s, self.sizes) for s in sets]
            reports.append(self.manager.process_token(sets, tiers))
        modeled = sum(r.modeled_s for r in reports)
        comp = sum(r.compute_s for r in reports)
        return self._finish(tokens, modeled, reports, t0, gen_len,
                            compute_frac=min(comp / max(modeled, 1e-12), 1.0))
