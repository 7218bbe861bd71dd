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
per token. The step-level API (``begin_prefill`` … ``decode_step``) is what
the server's continuous-batching scheduler drives.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
import types
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

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


@dataclasses.dataclass
class DecodeSession:
    """Per-request decode state, driven step-by-step by a scheduler.

    Analytic mode carries the request's per-layer overlap processes; real
    mode carries the runner, its KV cache and last-position logits.
    Chunked prefill (``begin_prefill`` + ``prefill_chunk``) tracks its
    progress in ``prompt_done``; ``prefill_report`` accumulates the charged
    modeled/compute seconds across chunks.
    """
    rid: int
    procs: Optional[list] = None        # analytic: per-layer OverlapProcess
    runner: object = None               # real: RealModelRunner
    cache: object = None                # real: KV cache dict
    last: object = None                 # real: last-position logits
    tokens: list = dataclasses.field(default_factory=list)
    prefill_report: object = None       # cumulative StepReport over chunks
    prompt: object = None               # real: stashed (padded) prompt
    prompt_len: int = 0                 # true prompt tokens to charge
    prompt_done: int = 0                # prefill tokens already charged
    prefix_hit: int = 0                 # prompt tokens served by the
                                        # prefix cache (no compute charged)
    max_new_tokens: int = 0
    exec_done: int = 0                  # real chunked: prompt tokens whose
                                        # prefill actually ran (block-
                                        # aligned; starts at the restored
                                        # prefix on a hit)
    prefix_kv: Optional[list] = None    # real chunked: per-block host KV
                                        # payloads to restore before the
                                        # first suffix chunk
    _pos_sets: Optional[list] = None    # real: per-layer (P, k) active idx
    _chunk_sets: dict = dataclasses.field(default_factory=dict)
                                        # real chunked: block idx -> per-
                                        # layer active sets of that chunk
    _batch: object = None               # real: DecodeBatch currently joined
    _row: int = -1                      # real: row inside that batch

    @property
    def prefill_complete(self) -> bool:
        return self.prompt_done >= self.prompt_len


@dataclasses.dataclass
class StepReport:
    """One engine step (prefill or batched decode) on the modeled clock."""
    modeled_s: float
    compute_s: float
    batch_size: int
    report: object = None               # TokenReport when the manager ran
    jit_dispatches: int = 0             # real model forwards launched
    stall_s: float = 0.0                # transfer stalls inside the step
    overlapped_bytes: float = 0.0       # prefetched bytes that hid in time


class _SessionKVProvider:
    """Exports/imports one session's *actual* KV tensor bytes per block
    for the tiered cache's real-residency mode: ``export`` copies a token
    slice out of the session's cache to the host (optionally scrubbing the
    device copy — demotion really removes the bytes), ``import_`` writes it
    back. Sessions whose live state sits in a stacked
    DecodeBatch row are handled in place via the row index."""

    def __init__(self, sess: DecodeSession):
        self.sess = sess

    def _state(self):
        s = self.sess
        if s._batch is not None:
            return s._batch, s._batch.stack, s._row
        assert s.cache is not None, \
            f"rid {s.rid}: no executed KV state to export/import"
        return None, s.cache, None

    def export(self, tok0: int, ntokens: int, *, scrub: bool = False):
        from repro_torch.core import kv_payload as KP
        batch, cache, row = self._state()
        payload = KP.extract(cache, tok0, tok0 + ntokens, row=row)
        if scrub:
            cache = KP.scrub(cache, tok0, tok0 + ntokens, row=row)
            if batch is not None:
                batch.stack = cache
            else:
                self.sess.cache = cache
        return payload

    def import_(self, tok0: int, payload: dict):
        from repro_torch.core import kv_payload as KP
        batch, cache, row = self._state()
        cache = KP.inject(cache, payload, tok0, row=row)
        if batch is not None:
            batch.stack = cache
        else:
            self.sess.cache = cache


class M2CacheEngine:
    def __init__(self, cfg=None, params=None, *, paper_model: str = None,
                 mode: str = "m2cache", hbm_policy: str = "atu",
                 use_ssd: bool = True, ssd_dir: Optional[str] = None,
                 dram_capacity_gb: float = 56.0, hw: HostHW = HOST,
                 overlap: float = 0.8, device_name: str = "rtx3090",
                 seed: int = 0, batched_decode: bool = True,
                 prefill_bucket: int = 8, kv_block_tokens: int = 16,
                 device=None):
        """``device`` is where a real model computes (``cuda`` unless
        ``cpu`` is asked for); ``params`` must already live there.
        ``device_name`` names the modeled accelerator of the carbon model.

        ``batched_decode`` packs same-bucket sessions into one stacked
        forward per step (False: one forward per session, priced
        serially). ``prefill_bucket`` > 1 stacks up to that many prompts
        entering prefill together and prices each iteration's concurrent
        chunks as one dispatch group. Real prefill runs in chunks of
        ``kv_block_tokens`` tokens, the serving KV cache's block size, so a
        block's KV is a pure function of the tokens at and before it."""
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
        self.batched_decode = batched_decode
        self.prefill_bucket = max(int(prefill_bucket), 1)
        self.kv_block_tokens = max(int(kv_block_tokens), 1)
        from repro_torch.core.kv_payload import supports_payloads
        self.supports_kv_payloads = (params is not None
                                     and mode == "m2cache"
                                     and supports_payloads(cfg))
        # block-chunked real prefill rides the same gate
        self._chunked_real = self.supports_kv_payloads
        self.prefix_restored_tokens = 0  # prompt tokens whose KV came
                                         # from restored radix blocks
        self._ssd_dir = ssd_dir or tempfile.mkdtemp(prefix="m2cache_ssd_")
        # one modeled async-DMA engine shared by weight preloads and KV
        # prefetch — both ride the same flash bus and PCIe link
        self.prefetch = PrefetchEngine()
        self.prefetch.add_channel(SSD_CHANNEL, hw.ssd_bw)
        self.prefetch.add_channel(PCIE_CHANNEL, hw.pcie_bw)
        self.runner = None               # real mode: runner of the last generate()
        self.decode_dispatches = 0       # decode forwards launched
        self.prefill_dispatches = 0      # prefill forwards launched
        self._batches: Dict[int, object] = {}   # bucket max_seq -> DecodeBatch

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
        self._zi_clock = 0.0             # modeled clock when no manager runs
        self._runners: Dict[int, object] = {}   # real mode, keyed by max_seq
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

    # ------------------------------------------------------------------
    # Step-level serving API: a scheduler drives the engine token-by-token
    # (continuous batching) instead of the closed-loop generate() below.
    #
    # Units and clock semantics: there is ONE modeled clock per engine
    # (`clock`, seconds), owned by the cache manager (or `_zi_clock` for
    # the zero_infinity baseline). `prefill_chunk` and `decode_step`
    # advance it internally via `manager.process_token`; externally
    # modeled costs (KV swaps, idle gaps) are charged by the scheduler
    # through `advance_clock`. Every StepReport carries `modeled_s` (the
    # clock delta of that step, s) and `compute_s` (the accelerator-busy
    # share of it, s) — compute_s/modeled_s is the utilisation the carbon
    # model prices (gCO2 via core/carbon.py). Byte quantities inside
    # reports are real bytes; on-disk surrogate files are smaller by
    # `_file_byte_scale`.

    @property
    def clock(self) -> float:
        """Modeled serving clock (s). All prefill/decode/KV-swap costs
        accumulate here; request latencies are differences of this clock."""
        return self.manager.clock if self.manager is not None \
            else self._zi_clock

    def advance_clock(self, dt: float):
        """Charge ``dt`` seconds of externally-modeled work (e.g. KV
        swaps, idle-until-arrival gaps) to the clock."""
        assert dt >= 0.0
        if self.manager is not None:
            self.manager.clock += dt
        else:
            self._zi_clock += dt

    def kv_bytes_per_token(self, precision: str = "fp16") -> float:
        """KV bytes one token pins across all layers. With real KV
        residency (tiny model, payload-capable arch) this is the *actual*
        byte count of the cache leaves a token occupies — the transfer
        clock then prices the bytes that really move between tiers;
        analytic/paper-scale engines use the modeled FP16 K+V figure.
        ``precision`` gives the modeled estimate at a quantized tier
        width (int8 halves it, packed int4 quarters it) — capacity
        planning only; stored blocks measure their real packed sizes."""
        if self.supports_kv_payloads:
            from repro_torch.core.kv_payload import token_nbytes
            from repro_torch.models import transformer as T
            specs = T.cache_specs(self.cfg, 1, max_seq=32)
            full = token_nbytes(specs)
        else:
            full = 2.0 * self.num_layers * self.d_model * 2.0
        from repro_torch.serving.kv_cache import PRECISION_FRACTION
        return full * PRECISION_FRACTION[precision]

    def kv_provider(self, sess: DecodeSession):
        """Block-payload provider for the tiered KV cache's real-residency
        mode, or None when this engine/session pages modeled surrogates
        (analytic mode, promptless sessions, payload-incapable archs)."""
        if not self.supports_kv_payloads or sess.prompt is None:
            return None
        return _SessionKVProvider(sess)

    def _runner_for(self, max_seq: int):
        # bucket to the next power of two (>= 32) so requests with nearby
        # lengths share one cache width (and one decode batch)
        max_seq = max(1 << (max_seq - 1).bit_length(), 32)
        if max_seq not in self._runners:
            from repro_torch.core.engine_model import RealModelRunner
            self._runners[max_seq] = RealModelRunner(self.cfg, self.params,
                                                     max_seq=max_seq,
                                                     device=self.device)
        return self._runners[max_seq]

    def _zero_infinity_step(self, batch_size: int) -> StepReport:
        step = zero_infinity_token_time(
            num_layers=self.num_layers,
            layer_bytes_fp16=self._layer_bytes_fp16(),
            layer_flops=self._layer_flops_dense(), hw=self.hw,
            batch_size=batch_size)
        comp = batch_size * self._layer_flops_dense() * self.num_layers \
            / (self.hw.flops * self.hw.flop_util)
        self._zi_clock += step
        return StepReport(modeled_s=step, compute_s=comp,
                          batch_size=batch_size)

    def _analytic_procs(self, rid: int) -> list:
        return [OverlapProcess(self.d_ff, self.sizes["k"], self.overlap,
                               seed=self.seed + 1009 * (rid + 1) + l)
                for l in range(self.num_layers)]

    def begin_prefill(self, prompt=None, *, rid: int = 0,
                      prompt_len: Optional[int] = None,
                      max_new_tokens: int = 32,
                      prefix_hit: int = 0,
                      prefix_kv: Optional[list] = None) -> DecodeSession:
        """Open a decode session without charging any clock.

        The prompt is processed by subsequent :meth:`prefill_chunk` calls
        (the scheduler interleaves them with decode steps of other
        requests). ``prompt_len`` may be shorter than a left-padded
        ``prompt``'s width; only the true length is charged.

        ``prefix_hit`` marks the leading prompt tokens whose KV the
        prefix cache serves from the tiered hierarchy: no prefill
        compute is charged for them (``prompt_done`` starts there), the
        scheduler charges their residency transfers instead.

        ``prefix_kv`` makes the hit *semantically* real: a list of
        per-block host payloads (one per ``kv_block_tokens`` tokens of
        the hit, from :meth:`TieredKVCache.payloads_for`) that the first
        execution device_puts into the fresh cache — prefill then runs
        only the suffix chunks. Block-chunked prefill guarantees the
        suffix chunks are bitwise identical to a full recompute. Without
        ``prefix_kv`` (analytic engines, payload-incapable archs, or a
        caller that kept modeled-only hits) the real path recomputes the
        whole prompt and only the modeled clock skips the hit prefix.
        """
        if prompt is not None:
            prompt = np.asarray(prompt)
            if prompt.ndim == 1:
                prompt = prompt[None, :]
            plen = int(prompt_len or prompt.shape[-1])
        else:
            plen = int(prompt_len or 1)
        hit = min(max(int(prefix_hit), 0), plen - 1)
        sess = DecodeSession(rid=rid, prompt=prompt, prompt_len=plen,
                             max_new_tokens=max_new_tokens,
                             prompt_done=hit, prefix_hit=hit)
        if self.mode == "zero_infinity":
            return sess
        real = self.params is not None and prompt is not None
        if real and prefix_kv is not None and self._chunked_real \
                and hit > 0 and len(prefix_kv) * self.kv_block_tokens \
                == hit and all(p is not None for p in prefix_kv):
            # restorable hit: suffix-only prefill starts past the hit
            # (chunked execution always runs the *unpadded* prompt, so
            # cached block positions line up across requests regardless
            # of trace-level left padding)
            sess.prefix_kv = list(prefix_kv)
            sess.exec_done = hit
        if not real:
            sess.procs = self._analytic_procs(rid) if self.d_ff else None
        return sess

    def prefill_chunk(self, sess: DecodeSession,
                      max_tokens: Optional[int] = None) -> StepReport:
        """Charge the next ``max_tokens`` prompt tokens of one session.

        Each chunk is one pass over all layers with compute scaled by the
        chunk length while weights stream once, so concurrent decode
        batches contend with prefill on the same modeled transfer clock
        (the chunked-prefill pricing). Real-tiny mode runs the actual
        jit'd prefill once, at the first chunk, then charges each chunk
        with the active sets of *its own* prompt positions; analytic mode
        samples the request's overlap process per chunk. Returns the
        chunk's :class:`StepReport`; ``sess.prefill_report`` accumulates
        modeled/compute seconds across chunks.
        """
        remaining = sess.prompt_len - sess.prompt_done
        assert remaining > 0, "prefill already complete"
        n = remaining if max_tokens is None else min(max_tokens, remaining)
        assert n >= 1
        dispatches = 0
        if self.mode == "zero_infinity":
            rep = self._zero_infinity_step(n)
        else:
            if self.params is not None and sess.prompt is not None:
                if self._chunked_real:
                    dispatches = self._advance_exec(
                        [sess], {id(sess): sess.prompt_done + n}, bucket=1)
                    sets = self._chunk_sets_for(sess, sess.prompt_done + n)
                else:
                    if sess.runner is None:
                        dispatches = 1   # first chunk runs the jit prefill
                    sets = self._real_chunk_sets(sess, n)
            else:
                sets = [pr.step() for pr in sess.procs] if sess.procs else \
                    [np.zeros(0, np.int64)] * self.num_layers
            tiers = [_tier_map(s, self.sizes) for s in sets]
            overlapped0 = self.prefetch.stats.overlapped_bytes
            tok = self.manager.process_token(sets, tiers, batch_size=n)
            rep = StepReport(modeled_s=tok.modeled_s,
                             compute_s=tok.compute_s, batch_size=n,
                             report=tok, stall_s=tok.ssd_stall_s,
                             jit_dispatches=dispatches,
                             overlapped_bytes=self.prefetch.stats
                             .overlapped_bytes - overlapped0)
        self.prefill_dispatches += dispatches
        sess.prompt_done += n
        prev = sess.prefill_report
        sess.prefill_report = StepReport(
            modeled_s=rep.modeled_s + (prev.modeled_s if prev else 0.0),
            compute_s=rep.compute_s + (prev.compute_s if prev else 0.0),
            batch_size=sess.prompt_done,
            report=getattr(rep, "report", None))
        return rep

    def _real_chunk_sets(self, sess: DecodeSession, n: int) -> list:
        """Active sets for the chunk covering true prompt positions
        ``[prompt_done, prompt_done + n)``: the prefill runs once at
        the first chunk (numerics are position-independent of chunking);
        each chunk is charged with its last position's predictor output."""
        if sess.runner is None:
            from repro_torch.core.engine_model import flatten_active_idx
            sess.runner = self._runner_for(int(sess.prompt.shape[-1])
                                           + sess.max_new_tokens + 1)
            sess.last, sess.cache, aux = sess.runner._prefill(
                self.params, sess.prompt)
            sess._pos_sets = [np.asarray(a)
                              for a in flatten_active_idx(self.cfg, aux)]
        pad = sess.prompt.shape[-1] - sess.prompt_len   # left padding
        idx = pad + sess.prompt_done + n - 1            # chunk's last pos
        out = []
        for arr in sess._pos_sets:
            if arr.ndim > 1:
                flat = arr.reshape(-1, arr.shape[-1])
                out.append(flat[min(idx, flat.shape[0] - 1)])
            else:
                out.append(arr)
        return out

    # ------------------------------------------------------------------
    # block-chunked real prefill: execution in fixed KV-block chunks

    def _true_prompt_row(self, sess: DecodeSession) -> np.ndarray:
        """Unpadded prompt token ids (1D int32) — chunked execution runs
        true positions, so cached block positions line up across
        requests regardless of trace-level left padding."""
        return np.asarray(sess.prompt[0, -sess.prompt_len:], np.int32)

    def _init_exec(self, sess: DecodeSession):
        """Create a session's runner + fresh cache; on a restorable
        prefix hit, write the cached blocks into it and start the
        executed frontier past the hit (suffix-only prefill)."""
        from repro_torch.core import kv_payload as KP
        from repro_torch.models import transformer as T
        sess.runner = self._runner_for(sess.prompt_len
                                       + sess.max_new_tokens + 1)
        cache = T.init_cache(self.cfg, 1, max_seq=sess.runner.max_seq,
                             dtype=sess.runner.dtype, device=self.device)
        if sess.prefix_kv:
            bt = self.kv_block_tokens
            for i, payload in enumerate(sess.prefix_kv):
                cache = KP.inject(cache, payload, i * bt)
            cache["pos"] = int(sess.exec_done)
            self.prefix_restored_tokens += sess.exec_done
            sess.prefix_kv = None
        else:
            sess.exec_done = 0
        sess.cache = cache

    def _advance_exec(self, sessions: Sequence[DecodeSession],
                      targets: Dict[int, int], *, bucket: int) -> int:
        """Run prefill chunks of exactly ``kv_block_tokens`` tokens
        (the last chunk right-padded) until every session's executed
        frontier covers its target (``targets[id(sess)]``, true prompt
        tokens). Fixed-width chunks mean a block's KV depends only on
        the tokens at and before it — prerequisite for prefix reuse.
        Same-runner sessions advance together in stacked dispatches of
        <= ``bucket`` rows (rows may sit at *different* positions — pos is
        per-row cache state). Returns model forwards launched."""
        from repro_torch.core.engine_model import (_gather_row, _stack_rows,
                                                   flatten_active_idx,
                                                   flatten_active_idx_batched)
        bt = self.kv_block_tokens
        bucket = max(bucket, 1)
        for s in sessions:
            if s.runner is None:
                self._init_exec(s)
        dispatches = 0
        while True:
            pending = [s for s in sessions
                       if s.exec_done < min(targets[id(s)], s.prompt_len)]
            if not pending:
                return dispatches
            groups: Dict[int, list] = {}
            for s in pending:
                end = min((s.exec_done // bt + 1) * bt, s.prompt_len)
                groups.setdefault(id(s.runner), []).append((s, end))
            for members in groups.values():
                runner = members[0][0].runner
                for i in range(0, len(members), bucket):
                    grp = members[i:i + bucket]
                    dispatches += 1
                    toks = np.zeros((len(grp), bt), np.int32)
                    nv = np.zeros((len(grp),), np.int32)
                    for j, (s, end) in enumerate(grp):
                        chunk = self._true_prompt_row(s)[s.exec_done:end]
                        toks[j, :chunk.size] = chunk
                        nv[j] = end - s.exec_done
                    if len(grp) == 1:
                        s, end = grp[0]
                        s.last, s.cache, aux = runner._prefill_block(
                            self.params, s.cache, toks[0], int(nv[0]))
                        s.last = s.last[None]
                        s._chunk_sets[s.exec_done // bt] = [
                            np.asarray(a) for a in
                            flatten_active_idx(self.cfg, aux)]
                        s.exec_done = end
                        continue
                    # the reference pads the group to a power of two rows
                    # (one trace per size); nothing is traced here, so
                    # only the group's own rows run
                    last, stack, aux = runner._prefill_block_rows(
                        self.params, _stack_rows([s.cache for s, _ in grp]),
                        toks, nv)
                    per_layer = flatten_active_idx_batched(self.cfg, aux)
                    for j, (s, end) in enumerate(grp):
                        s.cache = _gather_row(stack, j)
                        s.last = last[j][None]
                        s._chunk_sets[s.exec_done // bt] = [
                            np.asarray(a[j]) for a in per_layer]
                        s.exec_done = end

    def _chunk_sets_for(self, sess: DecodeSession, upto: int) -> list:
        """Active sets charged for the modeled chunk ending at true
        position ``upto`` — the executed block covering its last token
        (the chunked analogue of 'the chunk's last position's predictor
        output')."""
        return sess._chunk_sets[(upto - 1) // self.kv_block_tokens]

    def prefill(self, prompt=None, *, rid: int = 0,
                prompt_len: Optional[int] = None,
                max_new_tokens: int = 32) -> DecodeSession:
        """Monolithic prefill: :meth:`begin_prefill` + one full-length
        :meth:`prefill_chunk` (the pre-chunking behaviour — one pass over
        all layers, compute scaled by the whole prompt length)."""
        sess = self.begin_prefill(prompt, rid=rid, prompt_len=prompt_len,
                                  max_new_tokens=max_new_tokens)
        self.prefill_chunk(sess)
        return sess

    def _stacked_real_prefill(self, news: list) -> int:
        """Run the first-chunk prefill for real sessions that have no
        runner yet, stacking same-bucket / same-width prompts into
        dispatches of up to ``prefill_bucket`` rows. Returns the number of
        prefill forwards launched."""
        if not news:
            return 0
        from repro_torch.core.engine_model import (_gather_row,
                                                   flatten_active_idx,
                                                   flatten_active_idx_batched)
        groups: Dict[tuple, list] = {}
        for s in news:
            s.runner = self._runner_for(int(s.prompt.shape[-1])
                                        + s.max_new_tokens + 1)
            groups.setdefault((id(s.runner), s.prompt.shape[-1]),
                              []).append(s)
        bucket = self.prefill_bucket
        dispatches = 0
        for members in groups.values():
            runner = members[0].runner
            for i in range(0, len(members), bucket):
                grp = members[i:i + bucket]
                dispatches += 1
                if len(grp) == 1:
                    s = grp[0]
                    s.last, s.cache, aux = runner._prefill(
                        self.params, s.prompt)
                    s._pos_sets = [np.asarray(a) for a in
                                   flatten_active_idx(self.cfg, aux)]
                    continue
                rows = np.stack([np.asarray(s.prompt[0]) for s in grp])
                last, cache, aux = runner._prefill_rows(self.params, rows)
                per_layer = flatten_active_idx_batched(self.cfg, aux)
                for j, s in enumerate(grp):
                    s.last = last[j][None]
                    s.cache = _gather_row(cache, j)
                    s._pos_sets = [np.asarray(arr[j])
                                   for arr in per_layer]
        return dispatches

    def prefill_step(self, sessions: Sequence[DecodeSession],
                     max_tokens: Optional[int] = None
                     ) -> Optional[StepReport]:
        """One batched prefill step: every session advances one chunk.

        The prefill analogue of :meth:`decode_step`: with
        ``prefill_bucket`` > 1, sessions whose first chunk lands this
        iteration run their jit prefill as stacked vmapped dispatches
        (one graph per bucket group instead of one per session), and the
        iteration's concurrent chunks are *priced* as one dispatch group
        — weight traffic charged once for the union of the chunks'
        active sets while compute scales with the summed chunk tokens,
        exactly the dispatch-group rule batched decode uses. With
        ``prefill_bucket=1`` each session pays the legacy per-session
        :meth:`prefill_chunk` path. Tokens are unaffected either way
        (vmap preserves per-row numerics bitwise).

        Returns the aggregate :class:`StepReport` (``jit_dispatches`` =
        prefill graphs launched this step), or None with no work."""
        sessions = [s for s in sessions
                    if s.prompt_done < s.prompt_len]
        if not sessions:
            return None
        if self.prefill_bucket <= 1 or self.mode == "zero_infinity" \
                or len(sessions) == 1:
            # per-session fallback: serial charging, one graph per first
            # chunk — the pre-batching baseline
            clock0 = self.clock
            comp = stall = over = 0.0
            disp = total = 0
            for s in sessions:
                rep = self.prefill_chunk(s, max_tokens)
                comp += rep.compute_s
                stall += rep.stall_s
                over += rep.overlapped_bytes
                disp += rep.jit_dispatches
                total += rep.batch_size
            return StepReport(modeled_s=self.clock - clock0,
                              compute_s=comp, batch_size=total,
                              jit_dispatches=disp, stall_s=stall,
                              overlapped_bytes=over)
        clock0 = self.clock
        overlapped0 = self.prefetch.stats.overlapped_bytes
        ns = {}
        for s in sessions:
            remaining = s.prompt_len - s.prompt_done
            ns[id(s)] = remaining if max_tokens is None \
                else min(max_tokens, remaining)
        real = [s for s in sessions if self.params is not None
                and s.prompt is not None]
        real_ids = {id(s) for s in real}
        other = [s for s in sessions if id(s) not in real_ids]
        if self._chunked_real:
            dispatches = self._advance_exec(
                real, {id(s): s.prompt_done + ns[id(s)] for s in real},
                bucket=self.prefill_bucket)
        else:
            dispatches = self._stacked_real_prefill(
                [s for s in real if s.runner is None])
        # dispatch groups for pricing: real sessions per runner bucket,
        # analytic sessions together
        groups: List[list] = []
        buckets: Dict[int, list] = {}
        for s in real:
            buckets.setdefault(id(s.runner), []).append(s)
        groups.extend(buckets.values())
        if other:
            groups.append(other)
        t_compute = stall = 0.0
        for members in groups:
            gtokens = sum(ns[id(s)] for s in members)
            per_sess_sets = []
            for s in members:
                if id(s) in real_ids:
                    per_sess_sets.append(
                        self._chunk_sets_for(s, s.prompt_done + ns[id(s)])
                        if self._chunked_real
                        else self._real_chunk_sets(s, ns[id(s)]))
                elif s.procs:
                    per_sess_sets.append([pr.step() for pr in s.procs])
                else:
                    per_sess_sets.append(
                        [np.zeros(0, np.int64)] * self.num_layers)
            rows_per_layer = [
                np.stack([sets[l] for sets in per_sess_sets])
                for l in range(self.num_layers)]
            sets, tiers = self._union_active(rows_per_layer)
            tok = self.manager.process_token(sets, tiers,
                                             batch_size=gtokens)
            t_compute += tok.compute_s
            stall += tok.ssd_stall_s
            # bill each member its token-weighted share for reporting
            for s in members:
                share = ns[id(s)] / max(gtokens, 1)
                prev = s.prefill_report
                s.prefill_report = StepReport(
                    modeled_s=tok.modeled_s * share
                    + (prev.modeled_s if prev else 0.0),
                    compute_s=tok.compute_s * share
                    + (prev.compute_s if prev else 0.0),
                    batch_size=s.prompt_done + ns[id(s)], report=tok)
                s.prompt_done += ns[id(s)]
        self.prefill_dispatches += dispatches
        return StepReport(
            modeled_s=self.clock - clock0, compute_s=t_compute,
            batch_size=sum(ns.values()), jit_dispatches=dispatches,
            stall_s=stall,
            overlapped_bytes=self.prefetch.stats.overlapped_bytes
            - overlapped0)

    def _batch_for(self, runner):
        """Persistent DecodeBatch for one seq-length bucket."""
        from repro_torch.core.engine_model import DecodeBatch
        b = self._batches.get(runner.max_seq)
        if b is None or b.runner is not runner:
            b = DecodeBatch(runner)
            self._batches[runner.max_seq] = b
        return b

    def _union_active(self, rows_per_layer) -> tuple:
        """Vectorized batch union: per layer, ``rows`` is a (G, k) array of
        rank-sorted active ids, one row per batch member. Returns
        (sets, tier_maps) where a neuron's precision tier comes from its
        rank at its *first* occurrence in row-major order — the same
        first-seen-wins rule the old per-neuron dict loop applied, now one
        ``np.unique`` per layer instead of a Python loop over B×L×k ids."""
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

    def decode_step(self, sessions: Sequence[DecodeSession]) -> StepReport:
        """One decode step: every session advances one token.

        Execution and pricing follow the *dispatch groups*: with
        ``batched_decode`` (default), real-tiny sessions sharing a
        seq-length bucket are packed into one stacked KV cache and advance
        under a single vmapped jit dispatch — weight traffic is charged
        once for the group's active-set union while compute scales with
        the group size. With ``batched_decode=False`` each real session
        runs (and is priced) as its own single-sequence step — the serial
        pre-refactor behaviour, where per-session weight traffic thrashes
        the ATU cache. Analytic sessions always form one modeled batch.

        Returns a :class:`StepReport`: ``modeled_s`` is the step's clock
        delta, ``compute_s`` the accelerator-busy share,
        ``jit_dispatches`` the number of decode graphs launched. KV
        growth is *not* included — the scheduler charges it separately
        via the tiered KV cache."""
        B = len(sessions)
        assert B >= 1
        if self.mode == "zero_infinity":
            for sess in sessions:
                sess.tokens.append(None)
            return self._zero_infinity_step(B)
        clock0 = self.clock
        overlapped0 = self.prefetch.stats.overlapped_bytes
        # mode is per session: a real engine can still serve analytic
        # (prompt-less) requests, whose sessions carry procs, not a runner
        real = [s for s in sessions if s.runner is not None]
        analytic = [s for s in sessions if s.runner is None]
        dispatches = 0
        groups: List[tuple] = []        # (rows_per_layer, group size)

        if real and self.batched_decode:
            from repro_torch.core.engine_model import flatten_active_idx_batched
            buckets: Dict[int, list] = {}
            for s in real:
                buckets.setdefault(id(s.runner), []).append(s)
            for members in buckets.values():
                batch = self._batch_for(members[0].runner)
                batch.sync(members)
                nxt, aux = batch.step(self.params)
                dispatches += 1
                for s in members:
                    s.tokens.append(int(nxt[s._row]))
                rows_idx = [s._row for s in members]
                per_layer = flatten_active_idx_batched(self.cfg, aux)
                groups.append(([arr[rows_idx] for arr in per_layer],
                               len(members)))
        elif real:
            from repro_torch.core.engine_model import flatten_active_idx
            for sess in real:
                nxt = torch.argmax(sess.last, dim=-1)
                sess.tokens.append(int(nxt[0]))
                sess.last, sess.cache, aux = sess.runner._decode(
                    self.params, sess.cache, nxt[:, None])
                dispatches += 1
                groups.append(([np.asarray(a)[None] for a in
                                flatten_active_idx(self.cfg, aux)], 1))
        if analytic:
            for sess in analytic:
                sess.tokens.append(None)
            rows = [[pr.step() for pr in s.procs]
                    for s in analytic if s.procs]
            if rows:
                per_layer = [np.stack([r[l] for r in rows])
                             for l in range(self.num_layers)]
            else:
                per_layer = [np.zeros((0, 0), np.int64)] * self.num_layers
            groups.append((per_layer, len(analytic)))

        t_compute = stall = 0.0
        last_report = None
        for rows_per_layer, gsize in groups:
            sets, tiers = self._union_active(rows_per_layer)
            rep = self.manager.process_token(sets, tiers, batch_size=gsize)
            t_compute += rep.compute_s
            stall += rep.ssd_stall_s
            last_report = rep
        self.decode_dispatches += dispatches
        return StepReport(
            modeled_s=self.clock - clock0, compute_s=t_compute,
            batch_size=B, report=last_report, jit_dispatches=dispatches,
            stall_s=stall,
            overlapped_bytes=self.prefetch.stats.overlapped_bytes
            - overlapped0)

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
        sess = DecodeSession(rid=-1, procs=procs)
        reports = [self.decode_step([sess]).report
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
