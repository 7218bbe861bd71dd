#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py            # all phases, one card
  python3 chip_smoke.py --only offline_tiny,ratio_search_full,train_full
                                   # the device phase and the named ones
  python3 chip_smoke.py --only mesh_full
  python3 chip_smoke.py --only mesh_bf16_full

Phases, each printing one JSON line:
  1. device   — the card's name and power limit, torch/CUDA versions, and
                the wall seconds of building every CUDA kernel from
                ``src/repro_torch/csrc``;
  2. kernels  — each kernel at the shapes the full-width main path gives
                it, held against its plain PyTorch version on the card
                (max|d| <= 1e-5 * max(1, max|plain|): fp32 sums in another
                order), and timed (CUDA events, warm, median) beside the
                plain version, a yardstick library call and the least time
                the card could take;
  3. tiny     — qwen2.5-14b tiny served through ``repro_torch.launch.serve``
                on ``cuda`` (kernels) and on ``cpu`` (plain versions) from
                the same weights: tokens equal, last logits within 1e-4
                (abs and rel), every kernel launched;
  4. full     — qwen2.5-14b at full width, depth cut to 4 layers, served
                with batch 4, prompt 128, 16 new tokens; its launch counts
                are those of the ``launch/serve`` path;
  5. server_tiny — qwen2.5-14b tiny through ``repro_torch.launch.server``
                (continuous batching, block-chunked prefill, radix prefix
                cache) on ``cuda`` against ``cpu`` from the same weights:
                tokens per request and the modeled-clock summary equal;
                batched decode on equals off;
  6. server_full — the server at full width (4 layers), 8 shared-prefix
                requests arriving together, cold then warm (the radix tree
                persisted by the first run), and with the prefix cache off:
                tokens equal, prefix hits, wall and device time per decode
                step and per prefill chunk, the device-busy share; its launch
                counts are those of the server path;
  7. server_obs_full — server_full's traffic (prefix cache cold) with every
                observability output on (trace, metrics with an interval,
                block trace, ledger, health), runs off/on/on/off: tokens
                equal on and off, the ledger conserves, every request has
                its queued, prefill and decode spans, the block trace reads
                back, the ledger rebuilt from the trace equals it; the
                median decode-step wall on and off;
  8. cluster_full — the same traffic on two replicas behind the prefix
                router (modeled devices rtx3090 and m40, one params tree on
                the card): a valid cluster summary, each replica's tokens
                equal to a standalone run of its sub-trace, both replicas
                served;
  9. divergence — the KV-divergence probe, tiny on cuda against cpu
                (overlaps and first divergence equal, logit differences
                within 1e-4), then the reference's probe settings (seeds
                0-3, 24-token prompts, 8 steps, top-5) at full width for
                int8 and int4, numbers of random weights with no gate;
 10. dense_archs — qwen2.5-32b, command-r-35b, mistral-large-123b and
                internvl2-1b in turn (DENSE_ARCHS: depth cut to 2, 2, 2
                and 3 layers): tiny through launch/serve and launch/server
                on cuda against cpu (as phases 3 and 5); at full width
                full's serve traffic and server_full's server traffic (prefix
                cache cold, warm, off, and batched decode off: tokens
                equal), every kernel of each path launched, wall and device
                time per decode step and prefill chunk; the card freed and
                the bank files removed between configs.
 11. moe_archs — the MoE configs (MOE_ARCHS): grok-1-314b and
                llama4-maverick-400b-a17b tiny through both entry points on
                cuda against cpu, with a drawn router, with the
                reference's zero router (ties) and with a drawn router at
                the full configs' capacity factor 1.25 (tokens dropped);
                grok-1-314b at full width (depth 64 -> 1: 19.3 GB of fp32
                experts) through serve and server as phase 10 runs a dense
                config, its attention kernels' softcap forms launched and
                no qmatmul, the tokens dropped by capacity at prefill
                printed, the card's routing of each prefill shape done
                again on the CPU (experts, positions and keep equal) with
                each row's choices per expert. llama4 at full
                width (73 GB of fp32 tables and experts) is not run.
 12. hybrid_arch — recurrentgemma-2b (RG-LRU blocks beside attention
                over a sliding window's ring cache, head dim 256): tiny
                through both entry points on cuda against cpu; at full
                width and 8 of its 26 layers (HYBRID_ARCH), every
                predictor A drawn, full's
                serve traffic, a ring run (2 prompts of 2176 = 2048 + 128
                tokens, 16 new: the prefill's window masks the last 128
                queries, decode wraps the ring) whose every decode step's
                logits are held to one whole-prompt prefill's at the same
                position (RING_TOL), and server_full's traffic (prefix
                cache cold, warm, off, batched decode off: tokens equal;
                the server prefills whole prompts, stacked in rows); the
                RG-LRU recurrence's device ms at both prefill shapes.
 13. ssm_arch — mamba2-370m (attention-free Mamba-2 blocks, the SSD
                scan, no FFN, no kernel on its paths): tiny through both
                entry points on cuda against cpu; at full width and 12 of
                its 48 layers (SSM_ARCH), every SSD layer's A and dt
                drawn, full's serve
                traffic, a long run (2 prompts of 2048 tokens: 8 SSD
                chunks; 16 new) whose decode logits at steps 1, 8 and 16
                are held to a whole-prompt prefill's (RING_TOL), the SSD's
                device ms at both prefill shapes and its share of the
                prefill, server_full's traffic (cold, warm, off, batched
                decode off: tokens equal).
 14. audio_arch — musicgen-large (K = 4 codebooks, 64 conditioning
                frames, LayerNorm, GELU, G = 1) through forward, as the
                reference's tests drive it (neither package serves it):
                tiny on cuda against cpu; at full width and 12 of its 48
                layers (AUDIO_ARCH; every predictor A drawn) a prefill of
                4 x 128 codebook steps after the frames and 16 greedy
                decode steps, each
                call's kernels held to its form of the path (the prefill
                flash_attention and qmatmul B, a decode step flash_decode
                and qmatmul A), twice; device time and busy share of the
                prefill and a decode step; decode logits at steps 1 and 16
                held to a whole-prompt prefill's (RING_TOL).
 15. offline_tiny — M2Cache's offline half and the trainer, qwen2.5-14b
                tiny, the same weights on cuda and cpu (predictor A drawn):
                Algorithm 1's search (ratio_search.search, budget 0.25, 6
                steps: feasibility and best ratio equal, uq within UQ_TOL,
                each candidate's launches by its non-empty tiers),
                train_predictor on one layer (A, B, loss within
                PREDICTOR_TOL), the trainer for 20 steps (the loss at each
                step within TRAIN_LOSS_TOL, falling), the same three runs
                with TF32 products as a control that must exceed each
                tolerance, launch/train's CLI on the card with a
                checkpoint, and the Tab. 14 proxy (train 60
                steps; perplexity dense, M2Cache mixed, uniform int4;
                printed, not gated);
 16. ratio_search_full — on phases 4 and 6-9's full-width weights, after
                them: every layer's predictor fitted (rank 64, 1024 random
                probes), loss and recall before and after; then the search
                (2 prompts of 64 tokens, 12 steps, budget 0.25): each
                candidate's uq, wall seconds and launches ((1, 0, 0) over
                the budget), every kernel call held against its plain
                version on the same inputs (every split at M = 2 and 128);
                its launches and errors join the kernel table's d = 5120
                rows;
 17. train_full — qwen2.5-14b at full width, depth 48 -> 4, the dense FFN
                (10.6 GB of fp32 params): remat on against off for one
                step's gradients, then 8 AdamW steps with remat (batch 2 x
                256 tokens of the synthetic corpus): loss and grad_norm a
                step, a step's wall and device ms, peak memory; the loss
                finite and falling; no kernel (train mode has none);
 18. softcap_library — the softcap rows' library call, compiled
                flex_attention with the row's cap and mask, held against
                the plain version within 1e-3 x max(1, max|plain|) and
                timed, in a process of its own after the rest: compiling
                it cost later profiler sessions kernel events;
 19. steps_tiny — qwen2.5-14b tiny through launch/steps.build_case's
                serve step (STEPS_TINY: long_500k with the int8 K/V off
                and on, once from position 524272, and decode_32k's 128
                rows of 32768 slots with it on) on cuda against cpu: a
                64-token prefill, 4 steps; tokens equal, int8 bytes apart
                by at most 1 (counted), logits within 1e-4 where no byte
                differs;
 20. long_context_full — long_500k at full width on phase 4's weights
                (after phase 16): one row, a ring of 8192 slots, a prompt
                of 8704 tokens, 16 decode steps, the int8 K/V off and on,
                every kernel call held against its plain version (the
                whole prompt on its first and last 512 queries against
                float64); decode against whole-prompt prefills with the
                int8 K/V off; the int8 ring after the prefill equal to the
                CPU quantizer over the fp32 ring; wall, device time and
                busy share of the prefill and a decode step.
 21. mesh_full — the mesh tooling (after train_full, the card emptied):
                launch/dryrun.run_one for qwen2.5-14b's full config at
                every input shape on the host (1 x 1) and 16 x 16 meshes,
                dense, and decode_32k m2 on 16 x 16 (fake DTensors traced
                on the host's CPU), each record's memory, roofline terms
                and trace seconds printed, status ok required; beside
                them, in a process each, the dry-run CLI for seven more
                16 x 16 combinations (MESH_SUBPROCESS: the five torch
                2.11 could not trace before, mistral-large-123b's
                prompt, llama4's long_500k), status ok required; every
                16 x 16 record's FLOPs a device within 1 % of the
                reference's own count (MESH_REFERENCE_FLOPS); then one
                real build_case step (long_500k, dense, make_host_mesh())
                at all 48 layers and full width (59.1 GB of fp32 weights,
                the 8192-slot ring from position 524272), 16 serve steps:
                48 flash_decode launches a step, the first step's calls
                held against the plain version, the record's arguments
                equal to the real bytes, and a step's median device time
                at least MESH_BOUND_SHARE of the record's roofline bound.
 22. mesh_bf16_full — the same long_500k serve step at bf16, the
                reference's default precision (the card emptied again):
                build_case(variant="m2", dtype=bf16) at all 48 layers and
                full width (about 45 GB: the bf16 fp tier, int8 and int4
                banks), then the dense bf16 step (about 30 GB), each 16
                steps over the seeded ring: the bf16 launches a step
                (m2: the fused GLU 48 and qmatmul's down products 144;
                flash_decode 48, its device ms a launch), the first step's
                kernel calls held against their plain versions and its
                logits against the same step through the plain versions
                on the card (MESH_BF16_TOL), the bf16 dry-run record's
                arguments equal to the real bytes, a step's median device
                time at least MESH_BOUND_SHARE of its roofline bound;
 23. bf16_tiny — the families of BF16_FAMILIES tiny at bf16 through
                forward on cuda against cpu (same weights): every kernel
                call held against its plain version, logits within the
                family's BF16_TINY_TOL of the CPU's scale, greedy tokens
                equal where the margin allows, only bf16 launches, each
                kernel of the family launched;
 24. moe_bf16_full — llama4-maverick at full width, depth 48 -> 1 (about
                36.6 GB of bf16), through forward with full's traffic:
                device ms a step and its bf16 attention launches.
Phases 4, 6-9, 16 and 20 share one set of full-width weights; each prints
its seconds, and a ``timing`` line gives every phase's.
The kernel phase (2) also holds the server path's kernels at its shapes
(per-row qmatmul, chunked-prefill attention), the two kernels no path
runs yet (atu_update from an fp32 bank, and from an int8 one into an int8
and an fp32 unit; mp_glu_ffn), and (``kernels_dense``) the shapes
only phase 10 gives: flash_decode at G = 12 (two head groups), 7 (D =
64) and 8, both attention forms at G = 12 and at G = 7, D = 64, and one
layer's FFN at d = 12288; and (``kernels_moe``) the three attention
kernels' logit-softcap forms at grok-1-314b's shapes (G = 6, cap 30), at
scores of about +-60 where the cap saturates, beside the uncapped form
(their library call compiled flex_attention with the same cap and mask;
SDPA, which has no cap, only as a yardstick); and (``kernels_hybrid``)
recurrentgemma-2b's head dim 256 at G = 10: flash_decode at the serve step
and over the window's wrapped 2048-slot ring, the whole prompt at the
serve prefill and at 2176 tokens within the 2048 window (library: SDPA
with the window as a boolean mask), and one layer's GELU FFN at d = 2560,
f = 7680 through kernels A and B; and (``kernels_audio``)
musicgen-large's G = 1 (32 KV heads of 64): flash_decode at its decode
step, the whole prompt of 64 frames and 128 codebook steps, and one
layer's GELU FFN at d = 2048, f = 8192 through kernels A and B; and
(``kernels_long``) long_context_full's shapes: the whole prompt of 8704
tokens within the 8192 window (against the plain chunked_attention, and
float64 on its first and last 512 queries), flash_decode over the
wrapped 8192-slot ring, one layer's FFN at M = 1 and 8704, and a decode
step's attention over int8 K/V at 8 x 32768 slots against the bound of
the int8 bytes (dequantize and flash_decode timed apart); and
(``kernels_bf16``) each kernel's bf16 form at the bf16 paths' shapes: one
layer's FFN at d = 5120 through kernel A (M = 1, and 4 rows of M = 1: the
fused GLU, the down products and their one sum) and kernel B (M = 512, and
4 rows of a 16-token chunk), every call held; the fused GLU's launch alone
(row ``qmm_glu_bf16``), and its h bit-equal to the
PyTorch composition over its own products for silu, gelu and relu at d =
5120 and 2560 (``glu_bits``); flash_decode over long_500k's wrapped
8192-slot ring and at the serve step, each also within 1e-5 of the fp32
form on the widened inputs;
the whole prompt and the chunk form; beside each, its plain version, one
library call at bf16 (torch.matmul on the gathered weights, SDPA) and the
fp32 form of the same kernel, and its bound at bf16 bytes; the kernels on
the bf16 tensor cores (kernel B, both attention forms) also beside the
bound of the operations their MMAs issue; and two measurement rows, kernel
B at x (8704, 5120) and the whole prompt at 2048 tokens. qmatmul
has two kernels (A for small
M, B on the tensor cores): every qmatmul row is held and profiled through
each kernel that takes its M, beside a second bound at the TF32 peak, and
one layer's FFN at M = 1, 4, 8, 16 through both gives the crossover; the
full-width paths must launch both. Both forms of prefill attention run on
the tensor cores too (second bound: 3 TF32 products per fp32 product) and
are also held at G = 5 and ragged shapes, at scores of about +-60 (against
the plain version and against the function in float64), a row alone
against the same row in a group of four, each key split of the chunk form
and paired and unpaired query tiles of the whole prompt (profiled too),
and timed at a 2048-token prompt beside SDPA (rows ``*_long``).
flash_decode, one kernel a call, is held at the serve decode step's
shapes (with a ring buffer, a row without a valid slot, NaN and Inf in
masked slots, a row alone against the same row in its group), over a
server decode batch, and at 4 K and 32 K slots beside SDPA, each with a
sweep of its range size (and ring depth at 4 K and 32 K); ``full`` and
``server_full`` print one decode forward's kernels and host ms
(``decode_forward``). Then the card's name and power limit
(nvidia-smi), one JSON line with the kernel table, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line. Imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FULL_LAYERS = 4
#: server_full's traffic: 8 chat requests over 4 shared 64-token system
#: prompts (reuse 0.75), 16 new tokens each, all arriving at once
SERVER_FULL = ["--arch", "qwen2.5-14b", "--workload", "shared-prefix",
               "--requests", "8", "--shared-prefix-len", "64",
               "--prefix-reuse", "0.75", "--gen-len", "16", "16",
               "--rate", "1e9", "--max-batch", "4", "--prefill-bucket", "4",
               "--dram-gb", "6"]
#: a decode batch of server_full: 4 rows at their own positions in the
#: engine's power-of-two bucket buffer (prompts of 73 to 87 tokens, up to 16
#: new tokens each)
SERVER_BUCKET = 128
SERVER_DECODE_LENGTHS = [88, 80, 93, 82]
#: flash_decode's rows: (slots, the rows' lengths); the serve row is the
#: full phase's decode cache (prompt 128 + 16 new + 1) with 4 empty slots
#: in row 1, the long ones are measurement only
DECODE_ROWS = {"flash_decode": (145, [128, 133, 138, 143]),
               "flash_decode_rows": (SERVER_BUCKET, SERVER_DECODE_LENGTHS),
               "flash_decode_long": (4096, [3968, 4000, 4064, 4095]),
               "flash_decode_32k": (32768, [32767])}


_T0 = time.perf_counter()


def log(obj):
    """One JSON line; a phase's line also says when it was printed (t_s:
    seconds since the script started)."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _T0)
    print(json.dumps(obj, default=float), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str):
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings around one call, warm. Where the
    host's launch work outlasts the kernel, this is the host's time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


#: spin kernels a profiler session launches before what it measures, and
#: leaves out of its counts: in some states of a process (always after
#: Inductor had run in it, sometimes before) the profiler loses the first
#: kernel event of every session, and behind these loses none of what it
#: measures (scripts/profiler_event_probe.py counts both on the card)
SENTINEL_KERNELS = 2
SENTINEL_NAME = "spin_kernel"


def open_session():
    """Launches the SENTINEL_KERNELS spin kernels (about a microsecond each)
    that start a profiler session."""
    import torch
    for _ in range(SENTINEL_KERNELS):
        torch.cuda._sleep(1000)


def device_profile(fn, reps: int = 5, sum_of: tuple = ()) -> dict:
    """Device time per call from torch.profiler (CUDA kernel events only,
    the session's sentinels left out), the share of the wall the device was
    busy, and the kernels that took the most; with ``sum_of``, the device
    time per call of the kernels whose names hold each of those strings.
    Where the profiler sees no device time, says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per = {}
    # more sessions where the first saw no CUDA kernel (it happened to the
    # index_select + index_copy_ yardstick, and to two sessions in a row of
    # flash_decode at 32 K slots)
    for attempt in range(4):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_session()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or SENTINEL_NAME in ev.key:
                continue
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            if t > 0:
                per[ev.key] = per.get(ev.key, 0.0) + t / 1e3 / reps
        if per:
            break
    if not per:
        return {"device_ms": "not measured", "why": "no CUDA kernel events "
                "in four profiler sessions"}
    dev_ms = sum(per.values())
    top = {n[:80]: t for n, t in sorted(per.items(), key=lambda kv: -kv[1])[:8]}
    sums = {part: sum(t for n, t in per.items() if part in n)
            for part in sum_of}
    return {"device_ms": dev_ms, **({"sum_ms": sums} if sum_of else {}),
            "profiled_wall_ms": wall_ms,
            "busy_share": dev_ms / wall_ms, "top_kernels_ms": top,
            "kernels_per_call": sum(
                1 for e in prof.events() if e.device_type == DeviceType.CUDA
                and SENTINEL_NAME not in e.name) / reps,
            "profiler_sessions": attempt + 1}


def bound(nbytes: float, flops: float, peak: float = None) -> tuple:
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over ``peak`` (fp32 outside the tensor cores unless
    told otherwise), at the card's data-sheet rates (``core.hw.H100_SXM``)."""
    from repro_torch.core.hw import H100_SXM
    t_bytes = nbytes / H100_SXM.hbm_bw * 1e3
    t_ops = flops / (peak or H100_SXM.flops_fp32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32_products(k16: int, k8: int, k4: int) -> int:
    """TF32 MMAs kernel B issues per fp32 product it replaces, summed over
    one layer's neurons: 3 for the fp tier (3xTF32), 2 for the int tiers
    (only the activation is split)."""
    return 3 * k16 + 2 * (k8 + k4)


def tf32_bound(nbytes: float, M: int, d: int, k16: int, k8: int,
               k4: int) -> dict:
    """The FFN's bound on the tensor cores: gate, up and down at M rows,
    each multiply-add issued as many times as the split needs, at 495
    TFLOP/s dense TF32."""
    from repro_torch.core.hw import H100_SXM
    ms, by = bound(nbytes, 2 * M * d * 3 * tf32_products(k16, k8, k4),
                   H100_SXM.flops_tf32)
    return {"bound_tf32_ms": ms, "bound_tf32_by": by,
            "bound_tf32_note": "TF32 dense peak x the split's products "
                               "(fp tier 3, int tiers 2)"}


def kernel_row(run, plain, lib, nbytes: float, flops: float, *,
               peak: float = None, tf32_products: int = 3, fp32_form=None,
               plain_reps: int = 20, issued_bf16: float = None) -> dict:
    """Times of one kernel call beside its plain version and the library
    call (and the fp32 form of the same kernel on the same values, where
    ``fp32_form`` is given), device profiles of the kernel and the library,
    and two bounds: the operations at ``peak`` (fp32 outside the tensor
    cores unless given; work on bf16 operands at the bf16 tensor peak), and
    the ``tf32_products`` TF32 products the kernel issues per product at
    the TF32 peak (3 where both operands are split, 1 where both are bf16
    or integers, exact in TF32; None for a kernel on the CUDA cores), or
    for a kernel on the bf16 tensor cores the ``issued_bf16`` operations
    its MMAs issue (whole tiles, split terms each a product) at the bf16
    peak."""
    b_ms, b_by = bound(nbytes, flops, peak)
    row = {"ms": time_ms(run), "plain_ms": time_ms(plain, reps=plain_reps),
           "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    if issued_bf16:
        from repro_torch.core.hw import H100_SXM
        i_ms, i_by = bound(nbytes, issued_bf16, H100_SXM.flops_bf16)
        row.update(bound_issued_ms=i_ms, bound_issued_by=i_by,
                   bound_issued_note="bf16 dense peak x the operations the "
                                     "kernel's MMAs issue")
    elif tf32_products:
        from repro_torch.core.hw import H100_SXM
        t_ms, t_by = bound(nbytes, tf32_products * flops,
                           H100_SXM.flops_tf32)
        row.update(bound_tf32_ms=t_ms, bound_tf32_by=t_by,
                   bound_tf32_note=f"TF32 dense peak x {tf32_products} "
                                   f"TF32 products per product")
    if fp32_form is not None:
        row["fp32_form_ms"] = time_ms(fp32_form)
    return {**row, "profile": device_profile(run),
            "library_profile": device_profile(lib)}


@contextlib.contextmanager
def pairing(pair: bool):
    """Route every flash_attention call through a plan that pairs query
    tiles (or not), whatever the row's shape says."""
    from repro_torch.kernels import flash_attention
    saved = flash_attention._plan
    flash_attention._plan = lambda *a: saved(*a)._replace(pair=pair)
    try:
        yield
    finally:
        flash_attention._plan = saved


def by_pair(run, want) -> dict:
    """Device ms of ``run`` with query tiles paired and not; both held
    against ``want`` to the bit-for-bit result of the plan's own choice."""
    import torch
    out = {}
    for pair in (True, False):
        with pairing(pair):
            got = run()
            require(torch.equal(got, want),
                    f"flash_attention: pair={pair} changed the result")
            out[str(pair)] = device_profile(run).get("device_ms")
    return out


@contextlib.contextmanager
def split_slots(slots: int):
    """Route every chunk_attention call through a key split of ``slots``
    slots per range (0: the whole key axis in one block)."""
    from repro_torch.kernels import chunk_attention
    saved = chunk_attention.SPLIT_SLOTS
    chunk_attention.SPLIT_SLOTS = slots
    try:
        yield
    finally:
        chunk_attention.SPLIT_SLOTS = saved


def attention_f64(q, k, v, pos0=None, softcap: float = 0.0,
                  window: int = 0):
    """Causal attention of queries at ``pos0[b] + i`` (0 when None) over
    slots at positions 0..Skv-1, all in float64 (``softcap`` > 0: scores
    capped before the mask; ``window`` > 0: a key takes part when it lies
    fewer than ``window`` positions before the query): the yardstick of the
    large-score checks, where the plain versions' own fp32 rounding of the
    scores is of the order of the tolerance, and of the query slices of a
    long prompt."""
    import torch
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    p0 = (torch.zeros(B, dtype=torch.long, device=q.device) if pos0 is None
          else pos0.long())
    qg = q.double().reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / D ** 0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = p0[:, None] + torch.arange(S, device=q.device)[None]
    kv_pos = torch.arange(Skv, device=q.device)[None, None]
    mask = kv_pos <= q_pos[:, :, None]
    if window:
        mask &= kv_pos > q_pos[:, :, None] - window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v.double())
    return o.reshape(B, S, Hq, D)


#: the mask of each kind of softcap row, as flex_attention's mask_mod over
#: the row's mask tensor: decode (the valid slots, (B, S) bool), the whole
#: prompt (causal) and the chunk (a key up to the row's front, pos0 (B,))
MASK_MODS = {
    "decode": lambda m: lambda b, h, q_idx, kv_idx: m[b, kv_idx],
    "causal": lambda m: lambda b, h, q_idx, kv_idx: kv_idx <= q_idx,
    "chunk": lambda m: lambda b, h, q_idx, kv_idx: kv_idx <= m[b] + q_idx,
}


def flex_softcap(q, k, v, softcap: float, mask_mod):
    """A call with no arguments of compiled flex_attention on (B, H, L, D)
    tensors, GQA on, with ``tanh(s / softcap) * softcap`` on the scaled
    score and ``mask_mod`` as the mask: one PyTorch call that computes a
    softcap row's function."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    flex = torch.compile(flex_attention, dynamic=False)
    block = create_block_mask(mask_mod, q.shape[0], None, q.shape[2],
                              k.shape[2], device=q.device)

    def score_mod(s, b, h, q_idx, kv_idx):
        return torch.tanh(s / softcap) * softcap
    return lambda: flex(q, k, v, score_mod=score_mod, block_mask=block,
                        enable_gqa=True)


#: how far the library call of a softcap row may stray from the plain
#: version, relative to max(1, max|plain|): flex_attention's own fp32
#: rounding is far inside it, a wrong mask or cap far outside
LIBRARY_TOL = 1e-3

#: softcap rows whose library call runs in a process of its own at the
#: end of the script: label -> (row, its inputs). Compiling it (Inductor)
#: cost a later profiler session kernel events (a one-kernel flash_decode
#: call counted 0.8), and a session after the whole run saw none of its
#: kernels, while a fresh process sees them all
SOFTCAP_LIBRARY = {}


def softcap_row(label: str, row: dict, q, k, v, mask_kind: str, mask,
                want) -> dict:
    """A softcap row: SDPA, which has no cap, moves to its own label as a
    yardstick; the library call, compiled flex_attention on q, k, v
    ((B, H, L, D)) with the row's cap and ``MASK_MODS[mask_kind](mask)``,
    is queued for :func:`phase_softcap_library` with the plain version
    ``want`` in its layout."""
    row["sdpa_uncapped_ms"] = row.pop("library_ms")
    row["sdpa_uncapped_profile"] = row.pop("library_profile")
    row["sdpa_uncapped_note"] = "SDPA without the cap, a yardstick only"
    row["library_ms"] = None
    SOFTCAP_LIBRARY[label] = (row, {
        "q": q.cpu(), "k": k.cpu(), "v": v.cpu(), "mask_kind": mask_kind,
        "mask": None if mask is None else mask.cpu(), "want": want.cpu(),
        "softcap": row["softcap"]})
    return row


def softcap_library(path: str) -> dict:
    """The library calls of the rows saved at ``path``, in this process:
    each first call (which compiles it) held against the plain version
    within LIBRARY_TOL x max(1, max|plain|), then timed and profiled.
    Returns label -> its numbers."""
    import torch
    out = {}
    for label, r in torch.load(path).items():
        dev = torch.device("cuda")
        q, k, v, want = (r[n].to(dev) for n in ("q", "k", "v", "want"))
        mask = None if r["mask"] is None else r["mask"].to(dev)
        lib = flex_softcap(q, k, v, r["softcap"],
                           MASK_MODS[r["mask_kind"]](mask))
        t = time.perf_counter()
        got = lib()
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t
        err = max_err(got, want)
        scale = max(1.0, float(want.abs().max()))
        require(err <= LIBRARY_TOL * scale,
                f"{label}: flex_attention with the softcap differs from the "
                f"plain version by {err:.3g}")
        c = r["softcap"]
        prof = device_profile(lib)
        kernels = prof.get("top_kernels_ms", {})
        require(len(kernels) <= 1, f"{label}: the library call ran "
                f"{sorted(kernels)}, not one kernel")
        out[label] = {
            "library": f"torch.compile(flex_attention), score_mod "
                       f"tanh(s / {c:g}) * {c:g}, the row's mask as a block "
                       "mask, enable_gqa",
            "library_max_abs_err": err, "library_compile_s": compile_s,
            "library_ms": time_ms(lib), "library_profile": prof,
            # the kernel's mean over the events the profiler kept
            "library_device_ms": (prof["device_ms"] / prof["kernels_per_call"]
                                  if kernels else "not measured"),
            "library_graph_ms": graph_ms(lib)}
    return out


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one call of ``fn`` captured in a CUDA graph: the median
    of CUDA-event timings around a replay, which leaves the host's work
    per call out (a second measure of a call whose kernel events the
    profiler loses some of)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps=reps)


def phase_softcap_library() -> dict:
    """The queued softcap rows' library calls, run by this script in a
    process of its own (``--softcap-library``) from their inputs saved
    under build/; each row takes its numbers. Returns label -> them."""
    import torch
    path = ROOT / "build" / "softcap_library.pt"
    path.parent.mkdir(exist_ok=True)
    torch.save({k: r for k, (_, r) in SOFTCAP_LIBRARY.items()}, path)
    try:
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--softcap-library",
             str(path)], capture_output=True, text=True, timeout=600)
    finally:
        path.unlink(missing_ok=True)
    lines = done.stdout.strip().splitlines()
    require(done.returncode == 0 and lines,
            f"softcap_library: exit {done.returncode}: "
            f"{done.stderr[-2000:]}")
    out = json.loads(lines[-1])
    for label, (row, _) in SOFTCAP_LIBRARY.items():
        row.update(out[label])
        out[label].update(ms=row["ms"], device_ms=row["profile"].get(
            "device_ms"), sdpa_uncapped_ms=row["sdpa_uncapped_ms"])
    SOFTCAP_LIBRARY.clear()
    log({"phase": "softcap_library", "rows": out})
    return out


def max_score(q, k) -> float:
    """max |q . k| / sqrt(D) of query head 0 against KV head 0."""
    import torch
    s = torch.einsum("bqd,bkd->bqk", q[:, :, 0], k[:, :, 0])
    return float(s.abs().max()) / q.shape[-1] ** 0.5


#: the largest score the large-score checks reach (the 3.5 x scale they had
#: reached 56-58 at G = 5 and D = 128; other shapes' extremes fall lower)
LARGE_SCORE = 57.0


def large_scores(q, k):
    """q and k scaled by one factor so that max|q . k| / sqrt(D) of query
    head 0 against KV head 0 is LARGE_SCORE."""
    f = (LARGE_SCORE / max_score(q, k)) ** 0.5
    return q * f, k * f


@contextlib.contextmanager
def kernel_choice(kernel):
    """Route every qmatmul call to kernel A ("gemv", M <= 16) or kernel B
    ("mma") by moving the crossover; None keeps the crossover."""
    from repro_torch.kernels import qmatmul
    saved = qmatmul.GEMV_MAX_M
    qmatmul.GEMV_MAX_M = {"gemv": 16, "mma": 0, None: saved}[kernel]
    try:
        yield
    finally:
        qmatmul.GEMV_MAX_M = saved


def per_kernel(check, label, M, fn, want) -> dict:
    """Each kernel that takes M (A up to 16, B always) held against the
    plain result and profiled on the device."""
    out = {}
    for kern in (("gemv", "mma") if M <= 16 else ("mma",)):
        with kernel_choice(kern):
            check(f"{label} [{kern}]", fn(), want, 1e-5)
            out[kern] = device_profile(fn)
    return {f"{k}_device_ms": v.get("device_ms") for k, v in out.items()} | {
        "per_kernel_profile": out}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def checker(checks: list):
    """check(name, got, want, tol_rel): fail unless ``got`` is finite and
    within tol_rel * max(1, max|want|) of ``want``; records the check in
    ``checks`` and returns max|got - want|."""
    import torch

    def check(name, got, want, tol_rel):
        err = max_err(got, want)
        tol = tol_rel * max(1.0, float(want.abs().max()))
        checks.append({"check": name, "max_abs_err": err, "tol": tol})
        require(bool(torch.isfinite(got).all()) and err <= tol,
                f"{name}: max|d|={err:.3g} > tol {tol:.3g}")
        return err
    return check


@contextlib.contextmanager
def decode_plan(range_slots: int = 0, stages: int = 0, heads: int = 0):
    """Route every flash_decode call through ranges of ``range_slots``
    slots, a ring of ``stages`` tiles and blocks of ``heads`` query heads
    (0 keeps the plan's own)."""
    from repro_torch.kernels import flash_decode as fd
    saved = fd.RANGE_SLOTS, fd.STAGES, fd.HEADS_PER_BLOCK
    fd.RANGE_SLOTS = range_slots or saved[0]
    fd.STAGES = stages or saved[1]
    fd.HEADS_PER_BLOCK = heads or saved[2]
    try:
        yield
    finally:
        fd.RANGE_SLOTS, fd.STAGES, fd.HEADS_PER_BLOCK = saved


def decode_inputs(randn, dev, S, hkv, G, D, lengths, holes=False,
                  ring=False):
    """q, k, v of a decode step over S slots for rows at ``lengths``, and
    the slot positions the decode step's mask gives them (slot i at
    position i up to the row's length, -1 above; with ``ring`` a sliding
    window's ring, slot i at length - ((length - i) mod S); with ``holes``
    also four empty slots in row 1)."""
    import torch
    B = len(lengths)
    q = randn(B, hkv, G, D)
    kc, vc = randn(B, S, hkv, D), randn(B, S, hkv, D)
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].repeat(B, 1)
    ln = torch.tensor(lengths, device=dev, dtype=torch.int32)
    if ring:
        slots = (ln[:, None] - torch.remainder(ln[:, None] - slots, S)).to(
            torch.int32)
    if holes:
        slots[1, 5:9] = -1
    return q, kc, vc, torch.where(slots <= ln[:, None], slots, -1), ln


def decode_row(check, randn, dev, label, S, hkv, G, D, lengths, *,
               holes=False, full_checks=False, sweep=(), stages=(), heads=(),
               plain_reps=20, softcap: float = 0.0, ring=False) -> dict:
    """flash_decode over B = len(lengths) rows of S slots (slot i at
    position i, as the decode step's mask gives them, or a wrapped ring's
    positions with ``ring``; with ``holes`` four empty slots in row 1)
    against its plain version; with ``full_checks``
    also a row with no valid slot, NaN and Inf in every masked slot (bit
    for bit), and a row alone against the same row in the group. Each range
    size of ``sweep``, ring depth of ``stages`` and number of query heads a
    block of ``heads`` is held and profiled. Timed beside the plain version and SDPA, with the bound counted over
    the valid slots only. ``softcap`` > 0: the capped form, every call
    and the plain version with the cap, q and k scaled so that the scores
    reach about +-60 (the cap saturates), the uncapped form's device time
    beside it, the library call compiled flex_attention with the cap, and
    SDPA (uncapped) as a yardstick only."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_decode import _plan
    from repro_torch.kernels.flash_decode import flash_decode as _fd
    B = len(lengths)
    hq = hkv * G
    q, kc, vc, slots, ln = decode_inputs(randn, dev, S, hkv, G, D, lengths,
                                         holes, ring)
    if softcap:
        f = (LARGE_SCORE / max_score(q.reshape(B, 1, hq, D), kc)) ** 0.5
        q, kc = q * f, kc * f
    flash_decode = lambda *a: _fd(*a, softcap=softcap)
    run = lambda: flash_decode(q, kc, vc, slots, ln)
    got = run()
    want = ref.flash_decode_ref(q, kc, vc, slots, ln, softcap=softcap)
    errs = [check(f"{label} B={B} S={S}", got, want, 1e-5)]
    require(torch.equal(run(), got), f"{label}: two calls differ")
    # one kernel a call: the wrapper's counter must grow by one every call
    # of every session; a session whose profiler saw fewer kernels than
    # calls (while the counter saw them all) lost events and is taken again,
    # up to three sessions; more than one kernel a call fails at once
    from repro_torch.kernels import flash_decode as fd_mod
    for sessions in range(1, 4):
        calls, n0 = [0], fd_mod.launches

        def counted():
            calls[0] += 1
            return run()
        prof = device_profile(counted)
        require(fd_mod.launches - n0 == calls[0],
                f"{label}: {calls[0]} calls launched "
                f"{fd_mod.launches - n0} kernels")
        if prof.get("kernels_per_call", 0) >= 1:
            break
    prof["decode_row_sessions"] = sessions
    require(prof.get("kernels_per_call") == 1,
            f"{label}: a call ran {prof.get('kernels_per_call')} kernels")
    valid = (slots >= 0) & (slots <= ln[:, None])
    if full_checks:
        none = slots.clone()
        none[0] = -1
        errs.append(check(f"{label} row 0 without a valid slot",
                          flash_decode(q, kc, vc, none, ln),
                          ref.flash_decode_ref(q, kc, vc, none, ln,
                                               softcap=softcap), 1e-5))
        kn, vn = kc.clone(), vc.clone()
        kn[~valid], vn[~valid] = float("nan"), float("inf")
        require(torch.equal(flash_decode(q, kn, vn, slots, ln), got),
                f"{label}: NaN/Inf in masked slots changed the result")
        del kn, vn
        b = B - 1
        alone = flash_decode(q[b:b + 1].contiguous(), kc[b:b + 1].contiguous(),
                             vc[b:b + 1].contiguous(),
                             slots[b:b + 1].contiguous(), ln[b:b + 1])
        require(torch.equal(alone[0], got[b]),
                f"{label}: a row alone differs from the same row in a group")
    sms = build.sm_count(dev)
    by_range, by_stages, by_heads = {}, {}, {}
    for key, table, kw in ([(r, by_range, {"range_slots": r}) for r in sweep]
                           + [(n, by_stages, {"stages": n}) for n in stages]
                           + [(n, by_heads, {"heads": n}) for n in heads]):
        with decode_plan(**kw):
            plan = _plan(S, hkv, G, D, sms)
            errs.append(check(f"{label} {kw}", run(), want, 1e-5))
            table[plan.range_slots if "range_slots" in kw else key] = \
                device_profile(run).get("device_ms")
    n_valid = int(valid.sum())
    qt = q.reshape(B, hq, 1, D)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
    nbytes = (q.numel() * 2 + slots.numel() + B) * 4 + 2 * n_valid * hkv * D * 4
    b_ms, b_by = bound(nbytes, 4 * n_valid * hq * D)
    row = {"max_abs_err": max(errs), "B": B, "S": S, "lengths": lengths,
           "valid_slots": n_valid, "plan": _plan(S, hkv, G, D, sms)._asdict(),
           "device_ms_by_range": by_range, "device_ms_by_stages": by_stages,
           "device_ms_by_heads_per_block": by_heads,
           "kv_mb": 2 * kc.numel() * 4 / 1e6,
           "l2_note": "inputs exceed the 50 MB L2" if kc.numel() * 8 > 50e6
           else "inputs stay in the 50 MB L2 across repetitions",
           "ms": time_ms(run), "plain_ms": time_ms(
               lambda: ref.flash_decode_ref(q, kc, vc, slots, ln,
                                            softcap=softcap),
               reps=plain_reps),
           "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
           "profile": prof, "library_profile": device_profile(lib)}
    if softcap:
        row["softcap"] = softcap
        row["max_score_checked"] = max_score(q.reshape(B, 1, hq, D), kc)
        row["uncapped_device_ms"] = device_profile(
            lambda: _fd(q, kc, vc, slots, ln)).get("device_ms")
        softcap_row(label, row, qt, kt, vt, "decode", valid,
                    want.reshape(B, hq, 1, D))
    del q, kc, vc, kt, vt
    return row


# ---------------------------------------------------------------------------
# Phase 2: kernels at the main path's shapes


def serve_ffn_rows(check, g, dev, cfg, B: int, P: int) -> tuple:
    """qmatmul at a config's serve shapes, banks drawn from ``g``: each
    tier's col and row forms, the identity gather and an odd int4 width
    piece by piece, then one layer's FFN at decode (M = B) and prefill
    (M = B * P), each through every kernel that takes its M, beside the
    plain version, the library call and both bounds. Returns ({"qmatmul_gemv":
    decode row, "qmatmul_mma": prefill row}, banks, idx, sizes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import (build_neuron_banks, to_neuron_major,
                                           unpack_int4)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.qmatmul import qmatmul_gathered
    from repro_torch.models.common import activation
    d, f = cfg.d_model, cfg.d_ff
    act = activation(cfg.ffn_act)
    sizes = tier_sizes(f, cfg)
    k, k16, k8, k4 = sizes["k"], sizes["fp16"], sizes["int8"], sizes["int4"]
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    dense = build_neuron_banks(randn(d, f, scale=d ** -0.5),
                               randn(d, f, scale=d ** -0.5),
                               randn(f, d, scale=f ** -0.5))
    banks = to_neuron_major(dense)          # the port's layout
    # scattered active set, as a trained (non-zero) predictor gives
    idx = torch.randperm(f, generator=g, device=dev)[:k]
    out = {}

    # --- gathered qmatmul, piece by piece (col, row, identity, odd int4)
    x4 = randn(B, d)
    errs = []
    for prec, sfx, lo, n in (("fp", "_fp", 0, k16), ("int8", "_i8", k16, k8),
                             ("int4", "_i4", k16 + k8, k4)):
        t_idx = idx[lo:lo + n].to(torch.int32).contiguous()
        sc = None if prec == "fp" else banks[f"wg{sfx}_s"]
        errs.append(check(f"qmm col {prec} k={n}",
                          qmatmul_gathered(x4, banks[f"wg{sfx}"], sc, t_idx,
                                           precision=prec, layout="col"),
                          ref.qmm_gathered_ref(x4, banks[f"wg{sfx}"], sc, t_idx,
                                               precision=prec, layout="col"),
                          1e-5))
        h = randn(B, n)
        sd = None if prec == "fp" else banks[f"wd{sfx}_s"]
        y0 = randn(B, d)
        errs.append(check(f"qmm row {prec} k={n}",
                          qmatmul_gathered(h, banks[f"wd{sfx}"], sd, t_idx,
                                           precision=prec, layout="row",
                                           out=y0.clone()),
                          ref.qmm_gathered_ref(h, banks[f"wd{sfx}"], sd, t_idx,
                                               precision=prec, layout="row",
                                               out=y0.clone()),
                          1e-5))
        errs.append(check(f"qmm identity {prec} vs qmatmul_ref",
                          qmatmul_gathered(x4, banks[f"wu{sfx}"],
                                           None if prec == "fp" else
                                           banks[f"wu{sfx}_s"],
                                           precision=prec, layout="col"),
                          ref.qmatmul_ref(x4, dense[f"wu{sfx}"],
                                          None if prec == "fp" else
                                          banks[f"wu{sfx}_s"], precision=prec),
                          1e-5))
    del dense
    odd = idx[:37].to(torch.int32).contiguous()
    for layout, w, s in (("col", "wg_i4", "wg_i4_s"), ("row", "wd_i4", "wd_i4_s")):
        xin = randn(3, d if layout == "col" else 37)
        errs.append(check(f"qmm {layout} int4 odd k=37",
                          qmatmul_gathered(xin, banks[w], banks[s], odd,
                                           precision="int4", layout=layout),
                          ref.qmm_gathered_ref(xin, banks[w], banks[s], odd,
                                               precision="int4", layout=layout),
                          1e-5))

    # --- the FFN of one layer at decode (M = B) and prefill (M = B*P) shapes
    # yardstick: torch.matmul over weights already gathered and dequantized
    lib_w = {}
    i16, i8, i4 = idx[:k16], idx[k16:k16 + k8], idx[k16 + k8:]
    for w in ("wg", "wu"):
        lib_w[w] = torch.cat([
            banks[f"{w}_fp"][i16],
            banks[f"{w}_i8"][i8].float() * banks[f"{w}_i8_s"][i8][:, None],
            unpack_int4(banks[f"{w}_i4"][i4], 1).float()
            * banks[f"{w}_i4_s"][i4][:, None]], dim=0).t().contiguous()
    lib_w["wd"] = torch.cat([
        banks["wd_fp"][i16],
        banks["wd_i8"][i8].float() * banks["wd_i8_s"][i8][:, None],
        unpack_int4(banks["wd_i4"][i4], 1).float() * banks["wd_i4_s"][i4][:, None]],
        dim=0).contiguous()
    ffn = {}
    for label, S in (("decode", 1), ("prefill", P)):
        x = randn(B, S, d)
        got = ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)
        want = ref.mp_ffn_gathered_ref(x, banks, idx, sizes, cfg.ffn_act)
        errs.append(check(f"mp_ffn {label} M={B * S}", got, want, 1e-5))
        x2 = x.reshape(B * S, d)

        def lib():
            h = act(x2 @ lib_w["wg"]) * (x2 @ lib_w["wu"])
            return h @ lib_w["wd"]
        M = B * S
        nbytes = (3 * d * (k16 * 4 + k8 + k4 / 2)       # the active weights
                  + 3 * 4 * (k8 + k4) + 4 * k           # scales and ids
                  + 2 * M * d * 4)                      # x in, y out
        b_ms, b_by = bound(nbytes, 2 * M * d * k * 3)
        ffn[label] = {
            "M": M, **tf32_bound(nbytes, M, d, k16, k8, k4),
            **per_kernel(check, f"mp_ffn {label} M={M}", M,
                         lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act),
                         want),
            "ms": time_ms(lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)),
            "plain_ms": time_ms(lambda: ref.mp_ffn_gathered_ref(
                x, banks, idx, sizes, cfg.ffn_act)),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "weight_bytes": 3 * d * (k16 * 4 + k8 + k4 / 2),
            "profile": device_profile(
                lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)),
            "library_profile": device_profile(lib)}
    out["qmatmul_gemv"] = dict(ffn["decode"], max_abs_err=max(errs))
    out["qmatmul_mma"] = dict(ffn["prefill"], max_abs_err=max(errs))
    del lib_w
    return out, banks, idx, sizes


def phase_kernels(cfg, dev, B: int, P: int, gen_len: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import _plan as whole_plan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode

    g = torch.Generator(device=dev).manual_seed(1234)
    hq, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = hq // hkv
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    out, checks = {}, []
    check = checker(checks)
    rows, banks, idx, sizes = serve_ffn_rows(check, g, dev, cfg, B, P)
    out.update(rows)

    # --- the crossover: one layer's FFN (shared set) at M = 1, 4, 8, 16
    # through kernel A and through kernel B
    cross = {}
    for M in (1, 4, 8, 16):
        x = randn(1, M, cfg.d_model)
        want = ref.mp_ffn_gathered_ref(x, banks, idx, sizes, cfg.ffn_act)
        got = per_kernel(check, f"crossover mp_ffn M={M}", M,
                         lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act),
                         want)
        cross[M] = {k: got.pop(f"{k}_device_ms") for k in ("gemv", "mma")}
        cross[M]["top_kernels_ms"] = {
            k: p.get("top_kernels_ms") for k, p in
            got["per_kernel_profile"].items()}
    out["qmatmul_mma"]["crossover_device_ms"] = cross

    # --- flash_decode at the decode step's shapes (cache of P + gen + 1),
    # plus ragged D = 32, a ring buffer, a row with no valid slot, NaN in
    # masked slots and a row alone against the row in the group; its range
    # sizes; then 4 rows of 4 K slots and one row of 32 K (measurement)
    S, lengths = DECODE_ROWS["flash_decode"]
    require(S == P + gen_len + 1 and len(lengths) == B,
            "flash_decode: the serve row is not the full phase's cache")
    out["flash_decode"] = decode_row(check, randn, dev, "flash_decode", S,
                                     hkv, G, D, lengths, holes=True,
                                     sweep=(32, 64, 160), full_checks=True)
    qs = randn(3, 2, 4, 32)
    ks_, vs_ = randn(3, 37, 2, 32), randn(3, 37, 2, 32)
    sl = torch.arange(37, device=dev, dtype=torch.int32)[None].repeat(3, 1)
    ln = torch.tensor([0, 17, 36], device=dev, dtype=torch.int32)
    err = check("flash_decode ragged S=37 D=32",
                flash_decode(qs, ks_, vs_, sl, ln),
                ref.flash_decode_ref(qs, ks_, vs_, sl, ln), 1e-5)
    now = 300                           # a ring wrapped past 256 slots
    ring = now - torch.remainder(now - torch.arange(256, device=dev), 256)
    ring = ring.to(torch.int32)[None].repeat(2, 1).contiguous()
    qr_, kr_, vr_ = randn(2, 1, 2, 32), randn(2, 256, 1, 32), randn(2, 256, 1, 32)
    lr = torch.tensor([now, now - 60], device=dev, dtype=torch.int32)
    err = max(err, check("flash_decode ring buffer S=256",
                         flash_decode(qr_, kr_, vr_, ring, lr),
                         ref.flash_decode_ref(qr_, kr_, vr_, ring, lr), 1e-5))
    out["flash_decode"]["max_abs_err"] = max(out["flash_decode"]["max_abs_err"],
                                             err)
    for name, sweep in (("flash_decode_long", (64, 128, 256, 512, 1024)),
                        ("flash_decode_32k", (512, 1024, 2048))):
        S, lengths = DECODE_ROWS[name]
        out[name] = decode_row(check, randn, dev, name, S, hkv, G, D, lengths,
                               sweep=sweep, stages=(2, 3, 4), plain_reps=5)

    # --- flash_attention at the prefill's shapes (a row alone against the
    # same row in the group, scores of about +-60), plus ragged, windowed
    # and G = 5 at a ragged S
    out["flash_attention"] = whole_prompt_row(check, randn, dev, B, P, hq,
                                              hkv, D)
    errs = []
    qr, kr, vr = randn(2, 45, 8, 64), randn(2, 45, 2, 64), randn(2, 45, 2, 64)
    errs.append(check("flash_attention ragged S=45 D=64",
                      flash_attention(qr, kr, vr),
                      ref.flash_attention_ref(qr, kr, vr), 1e-5))
    errs.append(check("flash_attention window=20",
                      flash_attention(qr, kr, vr, window=20),
                      ref.flash_attention_ref(qr, kr, vr, window=20), 1e-5))
    q5, k5, v5 = randn(1, 77, 10, D), randn(1, 77, 2, D), randn(1, 77, 2, D)
    errs.append(check("flash_attention G=5 ragged S=77",
                      flash_attention(q5, k5, v5),
                      ref.flash_attention_ref(q5, k5, v5), 1e-5))
    out["flash_attention"]["max_abs_err"] = max(
        errs + [out["flash_attention"]["max_abs_err"]])

    # --- the same form at a 2048-token prompt (measurement only: the
    # products grow with S^2)
    SL = 2048
    q, kp, vp = randn(1, SL, hq, D), randn(1, SL, hkv, D), randn(1, SL, hkv, D)
    got = flash_attention(q, kp, vp)
    err = check(f"flash_attention S={SL}", got,
                ref.flash_attention_ref(q, kp, vp), 1e-5)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = kp.transpose(1, 2).contiguous(), vp.transpose(1, 2).contiguous()
    out["flash_attention_long"] = {
        "by_pair_device_ms": by_pair(lambda: flash_attention(q, kp, vp), got),
        "max_abs_err": err, "B": 1, "S": SL,
        "plan": whole_plan(SL, hq, hkv, D, build.sm_count(dev))._asdict(),
        **kernel_row(lambda: flash_attention(q, kp, vp),
                        lambda: ref.flash_attention_ref(q, kp, vp),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True),
                        (2 * q.numel() + 2 * kp.numel()) * 4,
                        4 * hq * D * SL * (SL + 1) / 2, plain_reps=5)}
    del q, kp, vp, qt, kt, vt, got
    log({"phase": "kernels", "checks": checks, "kernels": out})
    del banks
    torch.cuda.empty_cache()
    return out


def whole_prompt_row(check, randn, dev, B: int, P: int, hq: int, hkv: int,
                     D: int, softcap: float = 0.0) -> dict:
    """flash_attention over B prompts of P tokens against its plain version,
    a row alone against the same row in the group, scores of about +-60
    against the plain version and float64, paired and unpaired query tiles;
    timed beside the plain version, SDPA and both bounds. ``softcap`` > 0:
    the capped form everywhere, the uncapped form's device time beside it,
    the library call compiled flex_attention with the cap, and SDPA
    (uncapped) as a yardstick only."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import _plan
    from repro_torch.kernels.flash_attention import flash_attention as _fa
    flash_attention = lambda *a: _fa(*a, softcap=softcap)
    label = f"flash_attention G={hq // hkv} D={D}" + (
        f" softcap={softcap:g}" if softcap else "")
    q = randn(B, P, hq, D)
    kp, vp = randn(B, P, hkv, D), randn(B, P, hkv, D)
    got = flash_attention(q, kp, vp)
    errs = [check(label, got, ref.flash_attention_ref(q, kp, vp,
                                                      softcap=softcap), 1e-5)]
    alone = flash_attention(q[1:2].contiguous(), kp[1:2].contiguous(),
                            vp[1:2].contiguous())
    require(torch.equal(alone[0], got[1]),
            f"{label}: a row alone differs from the same row in a group")
    ql, kl = large_scores(q, kp)
    big = max_score(ql, kl)
    require(big > 50, f"{label}: large scores reach only {big:.3g}")
    got_l = flash_attention(ql, kl, vp)
    want64 = attention_f64(ql, kl, vp, softcap=softcap)
    want32 = ref.flash_attention_ref(ql, kl, vp, softcap=softcap)
    errs.append(check(f"{label} scores to {big:.0f}", got_l, want32, 1e-5))
    errs.append(check(f"{label} scores to {big:.0f} vs float64", got_l,
                      want64, 1e-5))
    plain_err64 = max_err(want32, want64)
    del ql, kl, got_l, want32, want64
    qt = q.transpose(1, 2).contiguous()
    kt, vt = kp.transpose(1, 2).contiguous(), vp.transpose(1, 2).contiguous()
    row = {
        "by_pair_device_ms": by_pair(lambda: flash_attention(q, kp, vp), got),
        "max_abs_err": max(errs), "B": B, "S": P, "Hq": hq, "Hkv": hkv,
        "D": D, "max_score_checked": big,
        "plan": _plan(P, hq, hkv, D, build.sm_count(dev))._asdict(),
        "plain_max_abs_err_vs_f64_at_large_scores": plain_err64,
        **kernel_row(lambda: flash_attention(q, kp, vp),
                        lambda: ref.flash_attention_ref(q, kp, vp,
                                                        softcap=softcap),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True),
                        (2 * q.numel() + 2 * kp.numel()) * 4,
                        4 * B * hq * D * P * (P + 1) / 2)}
    if softcap:
        row["softcap"] = softcap
        row["uncapped_device_ms"] = device_profile(
            lambda: _fa(q, kp, vp)).get("device_ms")
        softcap_row(label, row, qt, kt, vt, "causal", None,
                    ref.flash_attention_ref(q, kp, vp,
                                            softcap=softcap).transpose(1, 2))
    return row


# ---------------------------------------------------------------------------
# Phase 2, continued: the server path's kernels and the two no path runs


def chunk_rows(check, randn, dev, *, pos0, chunk, sbuf, hq, hkv, D,
               splits, softcap: float = 0.0) -> dict:
    """chunk_attention at ``pos0`` over ``sbuf`` slots against its plain
    version; with several rows also garbage above the fronts, a row alone
    against the row in the group, G = 5 at fronts inside a key tile and a
    key range, and scores of about +-60; each key split of ``splits`` held
    and profiled; then timed beside the plain version, SDPA and the bounds.
    ``softcap`` > 0: the capped form everywhere, the uncapped form's device
    time beside it, the library call compiled flex_attention with the cap,
    and SDPA (uncapped) as a yardstick only.
    """
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.chunk_attention import _plan
    from repro_torch.kernels.chunk_attention import chunk_attention as _ca
    chunk_attention = lambda *a: _ca(*a, softcap=softcap)
    plain = lambda *a: ref.chunk_attention_ref(*a, softcap=softcap)
    R = len(pos0)
    q = randn(R, chunk, hq, D)
    kb, vb = randn(R, sbuf, hkv, D), randn(R, sbuf, hkv, D)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    label = f"chunk_attention pos0={pos0} S_buf={sbuf}" + (
        f" softcap={softcap:g}" if softcap else "")
    got = chunk_attention(q, kb, vb, p0)
    want = plain(q, kb, vb, p0)
    errs = [check(label, got, want, 1e-5)]
    row = {}
    if R > 1:
        kg, vg = kb.clone(), vb.clone()
        for b, p in enumerate(pos0):         # non-finite bytes above the front
            kg[b, p + chunk:] = float("nan")
            vg[b, p + chunk:] = float("inf")
        require(torch.equal(chunk_attention(q, kg, vg, p0), got),
                "chunk_attention: bytes above the prefill front changed the "
                "result")
        del kg, vg
        b = R - 1
        alone = chunk_attention(q[b:b + 1].contiguous(), kb[b:b + 1].contiguous(),
                                vb[b:b + 1].contiguous(), p0[b:b + 1].contiguous())
        require(torch.equal(alone[0], got[b]),
                "chunk_attention: a row alone differs from the same row in a "
                "group")
        qr, kr, vr = randn(2, 16, 8, 64), randn(2, 45, 2, 64), randn(2, 45, 2, 64)
        pr = torch.tensor([3, 29], dtype=torch.int32, device=dev)
        errs.append(check("chunk_attention ragged Skv=45 D=64",
                          chunk_attention(qr, kr, vr, pr),
                          plain(qr, kr, vr, pr), 1e-5))
        q5, k5, v5 = randn(2, 16, 10, D), randn(2, 77, 2, D), randn(2, 77, 2, D)
        p5 = torch.tensor([5, 61], dtype=torch.int32, device=dev)
        errs.append(check("chunk_attention G=5 fronts 20, 76 of Skv=77",
                          chunk_attention(q5, k5, v5, p5),
                          plain(q5, k5, v5, p5), 1e-5))
        ql, kl = large_scores(q, kb)
        big = max_score(ql, kl)
        require(big > 50, f"chunk_attention: large scores reach only {big:.3g}")
        got_l = chunk_attention(ql, kl, vb, p0)
        want32 = plain(ql, kl, vb, p0)
        want64 = attention_f64(ql, kl, vb, p0, softcap=softcap)
        errs.append(check(f"chunk_attention scores to {big:.0f}", got_l,
                          want32, 1e-5))
        errs.append(check(f"chunk_attention scores to {big:.0f} vs float64",
                          got_l, want64, 1e-5))
        row["max_score_checked"] = big
        row["plain_max_abs_err_vs_f64_at_large_scores"] = max_err(want32,
                                                                  want64)
        del ql, kl, got_l, want32, want64
    by_split = {}
    for slots in splits:
        with split_slots(slots):
            plan = _plan(chunk, sbuf, hq, hkv, D, build.sm_count(dev))
            errs.append(check(f"{label} split={plan.split}",
                              chunk_attention(q, kb, vb, p0), want, 1e-5))
            prof = device_profile(lambda: chunk_attention(q, kb, vb, p0))
            by_split[plan.split] = {
                "device_ms": prof.get("device_ms"),
                "ms": time_ms(lambda: chunk_attention(q, kb, vb, p0))}
    q_pos = p0.long()[:, None] + torch.arange(chunk, device=dev)[None]
    mask = (torch.arange(sbuf, device=dev)[None, None, :]
            <= q_pos[:, :, None])[:, None]             # (R, 1, S, sbuf)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = kb.transpose(1, 2).contiguous(), vb.transpose(1, 2).contiguous()
    keys = sum(p + chunk for p in pos0)                # slots up to each front
    pairs = sum(p + i + 1 for p in pos0 for i in range(chunk))
    plan = _plan(chunk, sbuf, hq, hkv, D, build.sm_count(dev))
    row.update({
        "max_abs_err": max(errs), "R": R, "S": chunk, "S_buf": sbuf,
        "pos0": pos0, "plan": plan._asdict(),
        "by_split": by_split, "split_extra_launches": 0,
        **kernel_row(lambda: chunk_attention(q, kb, vb, p0),
                        lambda: plain(q, kb, vb, p0),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask, enable_gqa=True),
                        2 * q.numel() * 4 + 2 * keys * hkv * D * 4 + R * 4,
                        4 * pairs * hq * D)})
    if softcap:
        row["softcap"] = softcap
        row["uncapped_device_ms"] = device_profile(
            lambda: _ca(q, kb, vb, p0)).get("device_ms")
        softcap_row(label, row, qt, kt, vt, "chunk", p0,
                    want.transpose(1, 2))
    return row


def server_ffn_rows(check, g, dev, cfg, R: int, chunk: int) -> tuple:
    """Per-row gathered qmatmul at a config's server shapes, weights drawn
    from ``g``: R rows, each with its own scattered active set, at M = 1
    and M = chunk, each tier's col and row forms (a row alone against the
    same row in the group) and one layer's FFN, each through every kernel
    that takes its M, beside the plain version, the library call and both
    bounds. Returns ({"qmatmul_gemv_rows": decode row,
    "qmatmul_mma_rows": chunk row}, (wg, wu, wd), idx)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import (build_neuron_banks, to_neuron_major,
                                           unpack_int4)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.qmatmul import qmatmul_gathered
    d, f = cfg.d_model, cfg.d_ff
    sizes = tier_sizes(f, cfg)
    k, k16, k8, k4 = sizes["k"], sizes["fp16"], sizes["int8"], sizes["int4"]
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    wd = randn(f, d, scale=f ** -0.5)
    banks = to_neuron_major(build_neuron_banks(wg, wu, wd))
    out = {}

    # --- per-row qmatmul: R rows, each with its own scattered active set
    idx = torch.stack([torch.randperm(f, generator=g, device=dev)[:k]
                       for _ in range(R)])
    errs = []
    tiers = (("fp", "_fp", 0, k16, 4.0), ("int8", "_i8", k16, k8, 1.0),
             ("int4", "_i4", k16 + k8, k4, 0.5))
    for M in (1, chunk):
        x = randn(R, M, d)
        for prec, sfx, lo, n, _ in tiers:
            t_idx = idx[:, lo:lo + n].to(torch.int32).contiguous()
            sc = None if prec == "fp" else banks[f"wg{sfx}_s"]
            got = qmatmul_gathered(x, banks[f"wg{sfx}"], sc, t_idx,
                                   precision=prec, layout="col")
            errs.append(check(f"qmm rows col {prec} R={R} M={M}", got,
                              ref.qmm_gathered_ref(x, banks[f"wg{sfx}"], sc,
                                                   t_idx, precision=prec),
                              1e-5))
            alone = qmatmul_gathered(x[1:2].contiguous(), banks[f"wg{sfx}"],
                                     sc, t_idx[1:2].contiguous(),
                                     precision=prec, layout="col")
            require(torch.equal(alone[0], got[1]),
                    f"qmm rows col {prec} M={M}: a row alone differs from "
                    "the same row in a group")
            h, y0 = randn(R, M, n), randn(R, M, d)
            sd = None if prec == "fp" else banks[f"wd{sfx}_s"]
            errs.append(check(f"qmm rows row {prec} R={R} M={M}",
                              qmatmul_gathered(h, banks[f"wd{sfx}"], sd, t_idx,
                                               precision=prec, layout="row",
                                               out=y0.clone()),
                              ref.qmm_gathered_ref(h, banks[f"wd{sfx}"], sd,
                                                   t_idx, precision=prec,
                                                   layout="row",
                                                   out=y0.clone()), 1e-5))

    # yardstick: one batched product per weight over per-row weights already
    # gathered and dequantized
    def dense_rows(w, cols):
        parts = []
        for r in range(R):
            i16, i8, i4 = (idx[r, :k16], idx[r, k16:k16 + k8],
                           idx[r, k16 + k8:])
            rows = torch.cat([             # (k, width): neuron-major banks
                banks[f"{w}_fp"][i16],
                banks[f"{w}_i8"][i8].float() * banks[f"{w}_i8_s"][i8][:, None],
                unpack_int4(banks[f"{w}_i4"][i4], 1).float()
                * banks[f"{w}_i4_s"][i4][:, None]], dim=0)
            parts.append(rows.t() if cols else rows)
        return torch.stack(parts).contiguous()
    lib_w = {"wg": dense_rows("wg", True), "wu": dense_rows("wu", True),
             "wd": dense_rows("wd", False)}
    # the bytes a row set must move: each distinct (tier, neuron) once, its
    # scales and ids, x in and y out; a simple kernel re-reads what rows share
    union = sum(len(torch.unique(idx[:, lo:lo + n])) * 3 * d * bpe
                for _, _, lo, n, bpe in tiers)
    per_row = R * 3 * d * (k16 * 4 + k8 + k4 / 2)
    shapes = {}
    for label, M in (("decode", 1), ("chunk", chunk)):
        x = randn(R, M, d)
        got = ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)
        want = ref.mp_ffn_gathered_ref(x, banks, idx, sizes, cfg.ffn_act)
        errs.append(check(f"mp_ffn rows {label} R={R} M={M}", got, want,
                          1e-5))

        def lib():
            h = F.silu(torch.bmm(x, lib_w["wg"])) * torch.bmm(x, lib_w["wu"])
            return torch.bmm(h, lib_w["wd"])
        nbytes = union + R * (3 * 4 * (k8 + k4) + 4 * k) + 2 * R * M * d * 4
        b_ms, b_by = bound(nbytes, 2 * R * M * d * k * 3)
        shapes[label] = {
            "R": R, "M": M,
            **tf32_bound(nbytes, R * M, d, k16, k8, k4),
            **per_kernel(check, f"mp_ffn rows {label} R={R} M={M}", M,
                         lambda: ops.mp_ffn(x, banks, idx, sizes,
                                            cfg.ffn_act), want),
            "ms": time_ms(lambda: ops.mp_ffn(x, banks, idx, sizes,
                                             cfg.ffn_act)),
            "plain_ms": time_ms(lambda: ref.mp_ffn_gathered_ref(
                x, banks, idx, sizes, cfg.ffn_act)),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "union_weight_bytes": union, "kernel_weight_bytes": per_row,
            "profile": device_profile(lambda: ops.mp_ffn(x, banks, idx, sizes,
                                                         cfg.ffn_act)),
            "library_profile": device_profile(lib)}
    out["qmatmul_gemv_rows"] = dict(shapes["decode"], max_abs_err=max(errs))
    out["qmatmul_mma_rows"] = dict(shapes["chunk"], max_abs_err=max(errs))
    del lib_w
    del banks
    return out, (wg, wu, wd), idx


def atu_row(name: str, bank, unit, src, dst, bg: int) -> dict:
    """atu_update of ``bank`` into ``unit`` (not written) bit for bit
    against its plain version, and again with groups 0 and 1 sharing a
    destination block (the later wins); then timed beside the plain
    version, the library's ``index_select`` + ``index_copy_`` and the
    bound (each element read once and written once, and the indices)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.atu_update import atu_update
    d, m = bank.shape[0], src.numel()
    dup_dst = dst.clone()
    dup_dst[:bg] = dst[bg:2 * bg]              # groups 0 and 1 share a block
    for label, dd in (("", dst), (" with a duplicate destination (the later "
                                  "group must win)", dup_dst)):
        want = ref.atu_update_ref(bank, unit.clone(), src.cpu(), dd.cpu(),
                                  bg=bg)
        got = atu_update(bank, unit.clone(), src, dd, bg=bg)
        require(torch.equal(got, want),
                f"{name} differs from its plain version{label}")
    src_l, dst_l = src.long(), dst.long()
    scratch = unit.clone()

    def lib_copy():
        scratch.index_copy_(1, dst_l,
                            bank.index_select(1, src_l).to(unit.dtype))
    nbytes = m * d * (bank.element_size() + unit.element_size()) + 2 * m * 4
    b_ms, b_by = bound(nbytes, 0.0)
    return {
        "max_abs_err": 0.0, "d": d, "f": bank.shape[1], "k": unit.shape[1],
        "m": m, "bg": bg, "bank": str(bank.dtype), "unit": str(unit.dtype),
        "ms": time_ms(lambda: atu_update(bank, scratch, src, dst, bg=bg)),
        "plain_ms": time_ms(lambda: ref.atu_update_ref(bank, scratch, src,
                                                       dst, bg=bg), reps=5),
        "library_ms": time_ms(lib_copy), "bound_ms": b_ms, "bound_by": b_by,
        "profile": device_profile(lambda: atu_update(bank, scratch, src, dst,
                                                     bg=bg)),
        "library_profile": device_profile(lib_copy)}


def phase_kernels_server(cfg, dev, R: int = 4, chunk: int = 16,
                         sbuf: int = 256) -> dict:
    """Per-row gathered qmatmul (R rows with their own active sets, M = 1
    and M = chunk), chunked-prefill attention at pos0 0/48/96/112 over a
    ``sbuf``-slot buffer (and one chunk at the end of 2048 slots), atu_update
    and mp_glu_ffn, each against its plain version, timed beside it, a
    library call and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import unpack_int4
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(4321)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sizes = tier_sizes(f, cfg)
    k16, k8, k4 = sizes["fp16"], sizes["int8"], sizes["int4"]
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    out, checks = {}, []
    check = checker(checks)
    rows, (wg, wu, wd), idx = server_ffn_rows(check, g, dev, cfg, R, chunk)
    out.update(rows)

    # --- chunked-prefill attention at pos0 0/48/96/112 over sbuf slots
    out["chunk_attention"] = chunk_rows(check, randn, dev, pos0=[0, 48, 96,
                                                                 112][:R],
                                        chunk=chunk, sbuf=sbuf, hq=hq,
                                        hkv=hkv, D=D, splits=(0, 32, 64, 128))
    # --- one chunk at the end of a 2048-slot buffer (measurement only)
    out["chunk_attention_long"] = chunk_rows(check, randn, dev, pos0=[2032],
                                             chunk=chunk, sbuf=2048, hq=hq,
                                             hkv=hkv, D=D,
                                             splits=(0, 128, 256, 512))

    # --- flash_decode over a decode batch of server_full
    S, lengths = DECODE_ROWS["flash_decode_rows"]
    out["flash_decode_rows"] = decode_row(
        check, randn, dev, "flash_decode_rows", S, hkv, hq // hkv, D,
        lengths[:R], full_checks=True, sweep=(32, 64, 128))

    # --- atu_update: m = 832 changed columns (104 groups of 8) of a (d, f)
    # bank into a (d, k4 + k8 + k16 + ...) unit: the fp32 bank, and an int8
    # one into an int8 and an fp32 unit
    bg, m = 8, 832
    unit_k = 4152
    groups = torch.randperm(f // bg, generator=g, device=dev)[:m // bg]
    dests = torch.randperm(unit_k // bg, generator=g, device=dev)[:m // bg]
    src = (groups[:, None] * bg + torch.arange(bg, device=dev)).reshape(-1)
    dst = (dests[:, None] * bg + torch.arange(bg, device=dev)).reshape(-1)
    src, dst = src.to(torch.int32).contiguous(), dst.to(torch.int32).contiguous()
    i8 = torch.randint(-128, 128, wg.shape, generator=g, device=dev,
                       dtype=torch.int8)
    for name, bank, unit_t in (("atu_update", wg, torch.float32),
                               ("atu_update_int8", i8, torch.int8),
                               ("atu_update_int8_fp32", i8, torch.float32)):
        unit = (randn(d, unit_k) if unit_t.is_floating_point else
                torch.randint(-128, 128, (d, unit_k), generator=g, device=dev,
                              dtype=unit_t))
        out[name] = atu_row(name, bank, unit, src, dst, bg)
    del i8

    # --- mp_glu_ffn over compact banks of one active set: tiers 1037/1037/
    # 2072 (int4 packs along the contraction, so its width must be even;
    # the model's 2073 drops its last neuron here)
    csizes = dict(sizes, int4=k4 // 2 * 2)
    compact = ops.make_compact_banks(wg, wu, wd, csizes, idx[0])
    x = randn(R, d)
    want = ref.mp_glu_ffn_ref(x, compact, cfg.ffn_act)
    errs = [check("mp_glu_ffn", ops.mp_glu_ffn(x, compact, act_name=cfg.ffn_act),
                  want, 1e-5)]
    deq = {}                   # compact banks are output-major: (out, in)
    for tier, tb in compact.items():
        for w, sc in (("wg", "sg"), ("wu", "su"), ("wd", "sd")):
            v = (unpack_int4(tb[w], 1) if tier == "int4" else tb[w]).float()
            if tier != "fp":
                v = v * tb[sc][:, None]
            deq.setdefault(tier, {})[w] = v.t().contiguous()

    def lib_glu():
        y = 0.0
        for tb in deq.values():
            y = y + (F.silu(x @ tb["wg"]) * (x @ tb["wu"])) @ tb["wd"]
        return y
    wbytes = sum(t.numel() * t.element_size() for tb in compact.values()
                 for t in tb.values())
    kc = k16 + k8 + csizes["int4"]
    b_ms, b_by = bound(wbytes + 2 * x.numel() * 4, 2 * R * d * kc * 3)
    out["mp_glu_ffn"] = {
        "max_abs_err": max(errs), "B": R, "tiers": [k16, k8, csizes["int4"]],
        **per_kernel(check, "mp_glu_ffn", R,
                     lambda: ops.mp_glu_ffn(x, compact, act_name=cfg.ffn_act),
                     want),
        "ms": time_ms(lambda: ops.mp_glu_ffn(x, compact, act_name=cfg.ffn_act)),
        "plain_ms": time_ms(lambda: ref.mp_glu_ffn_ref(x, compact,
                                                       cfg.ffn_act)),
        "library_ms": time_ms(lib_glu), "bound_ms": b_ms, "bound_by": b_by,
        "profile": device_profile(lambda: ops.mp_glu_ffn(
            x, compact, act_name=cfg.ffn_act)),
        "library_profile": device_profile(lib_glu)}
    log({"phase": "kernels_server", "checks": checks, "kernels": out})
    del compact, deq, wg, wu, wd
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 2, continued: the kernels at the dense configs' new shapes


def phase_kernels_dense(dev, B: int, P: int, gen_len: int, R: int = 4,
                        chunk: int = 16, sbuf: int = 256) -> dict:
    """The kernels at the shapes dense_archs gives them that no earlier row
    has: flash_decode at G = 12 (mistral-large-123b, two head groups, at
    the serve step and over a server decode batch, with a sweep of the
    heads a block takes), G = 7 at D = 64 (internvl2-1b) and G = 8
    (command-r-35b); both prefill attention forms at G = 12 and at G = 7,
    D = 64; one layer's FFN at d = 12288 at the serve and server shapes.
    Each against its plain version, timed beside it, the library call and
    the bound."""
    import torch
    from repro_torch.configs.base import get_config
    g = torch.Generator(device=dev).manual_seed(5678)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    out, checks = {}, []
    check = checker(checks)
    S, lengths = DECODE_ROWS["flash_decode"]
    shapes = {name: get_config(arch) for name, arch in (
        ("g12", "mistral-large-123b"), ("g7", "internvl2-1b"),
        ("g8", "command-r-35b"))}
    for name, cfg in shapes.items():
        hkv, D = cfg.num_kv_heads, cfg.head_dim
        G = cfg.num_heads // hkv
        out[f"flash_decode_{name}"] = decode_row(
            check, randn, dev, f"flash_decode_{name}", S, hkv, G, D, lengths,
            holes=True, full_checks=name != "g8", sweep=(32, 64),
            heads=(6, 4, 3) if name == "g12" else ())
        out[f"flash_decode_{name}"]["config"] = cfg.name
    S, lengths = DECODE_ROWS["flash_decode_rows"]
    big = shapes["g12"]
    out["flash_decode_rows_g12"] = decode_row(
        check, randn, dev, "flash_decode_rows_g12", S, big.num_kv_heads,
        big.num_heads // big.num_kv_heads, big.head_dim, lengths[:R],
        full_checks=True, sweep=(32, 64, 128))
    for name in ("g12", "g7"):
        cfg = shapes[name]
        hq, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        out[f"flash_attention_{name}"] = whole_prompt_row(
            check, randn, dev, B, P, hq, hkv, D)
        out[f"chunk_attention_{name}"] = chunk_rows(
            check, randn, dev, pos0=[0, 48, 96, 112][:R], chunk=chunk,
            sbuf=sbuf, hq=hq, hkv=hkv, D=D, splits=(0, 32, 64))
        for k in ("flash_attention", "chunk_attention"):
            out[f"{k}_{name}"]["config"] = cfg.name
    rows = serve_ffn_rows(check, g, dev, big, B, P)[0]
    rows.update(server_ffn_rows(check, g, dev, big, R, chunk)[0])
    for name, row in rows.items():
        out[f"{name}_d{big.d_model}"] = dict(row, config=big.name,
                                             d=big.d_model, f=big.d_ff)
    del rows
    torch.cuda.empty_cache()
    log({"phase": "kernels_dense", "checks": checks, "kernels": out})
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path through repro_torch.launch.serve


#: the kernels each main path launches at full width (the rest must stay
#: at 0 there): qmatmul's kernel A at decode, kernel B at prefill; an MoE
#: config's paths launch no qmatmul (its experts are products in PyTorch,
#: as the reference's einsums), and a config with a logit softcap only the
#: attention kernels' softcap forms ("<kernel>_softcap")
PATH_KERNELS = {"serve": ("qmatmul_gemv", "qmatmul_mma", "flash_decode",
                          "flash_attention"),
                "server": ("qmatmul_gemv", "qmatmul_mma", "flash_decode",
                           "chunk_attention"),
                # the KV-divergence probe: whole-prompt prefill, then decode
                "divergence": ("qmatmul_gemv", "qmatmul_mma", "flash_decode",
                               "flash_attention"),
                "serve_moe": ("flash_decode", "flash_attention"),
                "server_moe": ("flash_decode", "chunk_attention"),
                "serve_moe_softcap": ("flash_decode_softcap",
                                      "flash_attention_softcap"),
                "server_moe_softcap": ("flash_decode_softcap",
                                       "chunk_attention_softcap"),
                # no KV payloads (a window's ring, recurrent state): the
                # server prefills whole prompts
                "server_whole": ("qmatmul_gemv", "qmatmul_mma",
                                 "flash_decode", "flash_attention"),
                # attention-free, no FFN (mamba2): the SSD is plain PyTorch,
                # as the reference's is plain jnp; no kernel may launch
                "ssm": (),
                # forward itself (the audio family; long-context serving):
                # prefill, then decode, and each call of it
                "forward": ("qmatmul_gemv", "qmatmul_mma", "flash_decode",
                            "flash_attention"),
                "forward_prefill": ("qmatmul_mma", "flash_attention"),
                "forward_decode": ("qmatmul_gemv", "flash_decode"),
                # build_case's dense serve step (the dense FFN's products
                # are PyTorch's, as the reference's dense variant is jnp)
                "dense_decode": ("flash_decode",),
                # Algorithm 1's search: whole-prompt prefill, then decode
                "ratio_search": ("qmatmul_gemv", "qmatmul_mma",
                                 "flash_decode", "flash_attention"),
                # train mode: plain attention and PyTorch products (no
                # kernel has a backward); with M2Cache banks under no_grad
                # (Tab. 14's perplexity) the FFN at M = 256 goes to kernel B
                "train": (),
                "train_m2": ("qmatmul_mma",)}
_QMM = ("qmatmul_gemv", "qmatmul_mma")
_CAPPED = ("flash_decode", "flash_attention", "chunk_attention")


def path_of(cfg, kind: str) -> str:
    """The PATH_KERNELS key of a config's "serve" or "server" path."""
    from repro_torch.core.kv_payload import supports_payloads
    if cfg.family == "ssm":
        return "ssm"
    if kind == "server" and not supports_payloads(cfg):
        return "server_whole"
    if not cfg.num_experts:
        return kind
    return f"{kind}_moe" + ("_softcap" if cfg.logit_softcap else "")


def counters():
    """name -> (module, counter attribute); "qmatmul" counts both of its
    kernels (at bf16 and small M, kernel A's down products), "qmm_glu" the
    fused bf16 GLU."""
    from repro_torch.kernels import (atu_update, chunk_attention,
                                     flash_attention, flash_decode, qmatmul)
    return {"qmatmul": (qmatmul, "launches"),
            "qmatmul_gemv": (qmatmul, "launches_gemv"),
            "qmatmul_mma": (qmatmul, "launches_mma"),
            "qmm_glu": (qmatmul, "launches_glu"),
            "flash_decode": (flash_decode, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "chunk_attention": (chunk_attention, "launches"),
            "flash_decode_softcap": (flash_decode, "launches_softcap"),
            "flash_attention_softcap": (flash_attention, "launches_softcap"),
            "chunk_attention_softcap": (chunk_attention, "launches_softcap"),
            "atu_update": (atu_update, "launches")}


def reset_counts():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def require_path_kernels(phase: str, path: str, counts: dict,
                         each_qmm_kernel: bool = True):
    """Every kernel of the path ran; no kernel off the path did. With
    ``each_qmm_kernel`` off (the tiny phases, whose prefill chunks may stay
    below the crossover) qmatmul counts as one kernel. A softcap form on the
    path counts under its kernel's total too, and every launch of that
    kernel must then be capped."""
    want = set(PATH_KERNELS[path])
    if each_qmm_kernel:
        ran = {n for n, c in counts.items() if c > 0 and n != "qmatmul"}
    else:
        if want & set(_QMM):
            want = (want - set(_QMM)) | {"qmatmul"}
        ran = {n for n, c in counts.items() if c > 0 and n not in _QMM}
    capped = {n for n in _CAPPED if f"{n}_softcap" in want}
    want |= capped
    require(ran == want,
            f"{phase}: kernels launched {sorted(ran)}, the {path} path "
            f"runs {sorted(want)}: {counts}")
    for n in capped:
        require(counts[n] == counts[f"{n}_softcap"],
                f"{phase}: {counts[n] - counts[f'{n}_softcap']} launches of "
                f"{n} without the softcap on the {path} path: {counts}")


def draw_pred_a(params, gen, device):
    """A trained predictor's A is non-zero; the reference's init zeroes it
    (so every active set would be 0..k-1). Draw it so the gathers are real.
    An MoE layer's router, zero at the reference's init too (every token
    would tie and take experts 0..k-1), is drawn the same way, so that
    routing bugs cannot hide behind the tie order. An SSD layer (no FFN)
    gets Mamba-2's own init of its decay instead of the reference's
    constants (A = -1 and dt = softplus(0.5) in every head): A uniform in
    [1, 16], dt log-uniform in [0.001, 0.1] through dt_bias =
    softplus^-1(dt), so that the heads decay at their own rates."""
    import torch
    for layer in params["layers"]:
        if "ffn" not in layer:
            nh = layer["A_log"].shape[0]
            a = 1.0 + 15.0 * torch.rand(nh, generator=gen, device=device)
            dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(
                nh, generator=gen, device=device))
            layer["A_log"] = torch.log(a)
            layer["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
            continue
        ffn = layer["ffn"]
        name, tree = ("A", ffn["pred"]) if "pred" in ffn else ("router", ffn)
        w = tree[name]
        tree[name] = torch.randn(w.shape, generator=gen,
                                 device=device) * w.shape[0] ** -0.5


def serve_args(**kw):
    from repro_torch.launch.serve import build_parser
    argv = []
    for key, val in kw.items():
        flag = "--" + key.replace("_", "-")
        argv += [flag] if val is True else [flag, str(val)]
    return build_parser().parse_args(argv)


def tiny_config(arch: str, capacity_factor: float = 0.0):
    """``arch``'s tiny config; ``capacity_factor`` > 0 replaces an MoE
    config's (the tiny configs' 4.0 drops no token)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch, tiny=True)
    if capacity_factor:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    return cfg


def phase_tiny(arch: str = "qwen2.5-14b", label: str = "tiny",
               zero_router: bool = False, capacity_factor: float = 0.0):
    """``arch``'s tiny config through launch/serve on cuda against cpu,
    from the same weights (``zero_router``: an MoE config's router left at
    the reference's zero init, every token tied; ``capacity_factor`` > 0:
    an MoE config's capacity factor in place of the tiny one's)."""
    import torch
    from repro_torch.launch.serve import run
    from repro_torch.models import transformer as T
    cfg = tiny_config(arch, capacity_factor)
    params = T.init_params(cfg, seed=0, device="cpu")
    if not zero_router:
        draw_pred_a(params, torch.Generator().manual_seed(1), "cpu")
    params_gpu = _tree_to(params, "cuda")
    kw = dict(arch=arch, tiny=True, batch=2, prompt_len=16,
              gen_len=8, dram_gb=0.5)
    runs = {}
    for device, p in (("cuda", params_gpu), ("cpu", params)):
        tmp = tempfile.mkdtemp(prefix="m2cache_ssd_")
        try:
            reset_counts()
            summary, res, eng = run(serve_args(device=device, **kw), cfg=cfg,
                                    params=p, ssd_dir=tmp)
            runs[device] = (res, eng.runner.last_logits.cpu(), read_counts(),
                            summary)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    (rg, lg, cg, sg), (rc, lc, _, sc) = runs["cuda"], runs["cpu"]
    err = float((lg - lc).abs().max())
    tol = 1e-4
    line = {"phase": label, "config": cfg.name, "tokens_equal":
            bool((rg.tokens == rc.tokens).all()), "last_logits_max_abs_err": err,
            "tol_abs_rel": tol, "launches_cuda": cg,
            "modeled_s_equal": sg["modeled_s"] == sc["modeled_s"],
            "tokens": rg.tokens.tolist()}
    log(line)
    require(line["tokens_equal"], f"{label}: cuda and cpu tokens differ")
    require(torch.allclose(lg, lc, atol=tol, rtol=tol),
            f"{label}: last logits differ by {err:.3g}")
    require_path_kernels(label, path_of(cfg, "serve"), cg,
                         each_qmm_kernel=False)
    return line


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_full(full, cfg, params, B: int, P: int, gen_len: int,
               label: str = "full", ssd_dir: str = None) -> dict:
    """``full_model``'s weights through launch/serve: B prompts of P tokens,
    gen_len new tokens, twice (the same tokens), then one prefill and one
    decode step profiled. The SSD tier's bank files go to ``ssd_dir`` (kept)
    or to a temporary directory (removed)."""
    import torch
    from repro_torch.launch.serve import run
    param_gb = sum(t.numel() * t.element_size()
                   for t in _leaves(params)) / 1e9
    kw = dict(arch=full.name, batch=B, prompt_len=P, gen_len=gen_len,
              device="cuda")
    tmp = ssd_dir or tempfile.mkdtemp(prefix="m2cache_ssd_")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        summary, res, eng = run(serve_args(**kw), cfg=cfg, params=params,
                                ssd_dir=tmp)
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ssd_gb = sum(p.stat().st_size for p in Path(tmp).glob("*.bin")) / 1e9
        last = eng.runner.last_logits
        wall = eng.runner.wall_s
        finite = bool(torch.isfinite(last).all())
        in_vocab = bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
        _, res2, _ = run(serve_args(**kw), cfg=cfg, params=params, ssd_dir=tmp)
        same = bool((res.tokens == res2.tokens).all())
        profiles = profile_steps(eng.runner, params, cfg, B, P)
        cost = decode_forward_cost(cfg, params, [P + gen_len // 2] * B,
                                   P + gen_len + 1, rows=False)
    finally:
        if not ssd_dir:
            shutil.rmtree(tmp, ignore_errors=True)
    line = {
        "phase": label, "config": cfg.name,
        "depth_cut": f"num_layers {full.num_layers} -> {cfg.num_layers}",
        "widths": {"d_model": cfg.d_model, "heads": cfg.num_heads,
                   "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab_size},
        **({"ssd_A_dt": "A_log and dt_bias drawn (Mamba-2's init: A in "
            "[1, 16], dt in [0.001, 0.1]); the reference's init sets every "
            "head to A = -1"} if cfg.family == "ssm" else
           {("router" if cfg.num_experts else "pred_A"):
            "drawn N(0, 1/d) on the device generator for this run "
            "(the reference's init zeroes it)"}),
        "batch": B, "prompt_len": P, "gen_len": gen_len,
        "param_gb": param_gb, "ssd_bank_files_gb": ssd_gb,
        "serve_wall_s": serve_s, "prefill_wall_s": wall["prefill"],
        "decode_wall_s_median": statistics.median(wall["decode"]),
        "decode_wall_s": wall["decode"], "peak_mem_gb": peak_gb,
        "launches": counts,
        "tokens_per_s_modeled": summary["tokens_per_s_modeled"],
        "carbon_g_modeled": summary["carbon_g"],
        "finite_logits": finite, "tokens_in_vocab": in_vocab,
        "second_run_tokens_equal": same, "profile": profiles,
        "decode_forward": cost,
        "tokens": res.tokens.tolist()}
    log(line)
    require(finite, f"{label}: non-finite logits")
    require(in_vocab, f"{label}: token outside the vocabulary")
    require(same, f"{label}: a second run gave other tokens")
    require_path_kernels(label, path_of(cfg, "serve"), counts)
    return counts, line


def decode_forward_cost(cfg, params, lengths, sbuf: int, rows: bool,
                        reps: int = 10) -> dict:
    """One ``forward(mode="decode")`` at the rows' ``lengths`` over an
    ``sbuf``-slot cache (``rows``: the server's per-row batch): the device
    activities it starts (CUDA kernels, and copies or fills apart) from
    torch.profiler, their device ms, and the median host ms until forward
    returns and until the device is done. Uses only what every version of
    the port has, so that ``scripts/decode_step_cost.py`` can run it on
    another tree."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    B = len(lengths)
    dev = params["embed"].device
    cache = T.init_cache(cfg, B, sbuf, device=dev)
    tok = torch.zeros((B, cfg.num_codebooks, 1) if cfg.family == "audio"
                      else (B, 1), dtype=torch.long, device=dev)

    def step():
        cache["pos"] = (torch.tensor(lengths, dtype=torch.int64) if rows
                        else lengths[0])
        T.forward(cfg, params, tok, cache=cache, mode="decode", rows=rows)
    step()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_session()
        step()
        torch.cuda.synchronize()
    names = collections.Counter()
    dev_ms = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and SENTINEL_NAME not in e.name:
            names[e.name[:60]] += 1
            dev_ms += (e.time_range.end - e.time_range.start) / 1e3
    copies = sum(n for k, n in names.items()
                 if k.startswith(("Memcpy", "Memset")))
    del cache
    return {"rows": B, "lengths": list(lengths), "sbuf": sbuf,
            "layers": cfg.num_layers,
            "cuda_kernels": sum(names.values()) - copies,
            "copies_and_fills": copies, "device_ms": dev_ms,
            "host_ms_median": statistics.median(host),
            "wall_ms_median": statistics.median(wall),
            "most_launched": dict(names.most_common(12))}


def profile_steps(runner, params, cfg, B: int, P: int) -> dict:
    """Device time, busy share and top kernels of one prefill and of one
    decode step at the full-width shapes (after the counted run)."""
    import torch
    from repro_torch.launch.serve import make_prompts
    prompts = torch.as_tensor(make_prompts(cfg, B, P, 0), device="cuda")
    state = {}

    def prefill():
        state["last"], state["cache"], _ = runner._prefill(params, prompts)

    def decode():
        if state["cache"]["pos"] >= runner.max_seq:
            prefill()
        tok = torch.argmax(state["last"], dim=-1)[:, None]
        state["last"], state["cache"], _ = runner._decode(
            params, state["cache"], tok)
    out = {"prefill": device_profile(prefill, reps=2)}
    prefill()
    out["decode_step"] = device_profile(decode, reps=5)
    return out


# ---------------------------------------------------------------------------
# Phases 5 and 6: the main path through repro_torch.launch.server


def server_args(argv, **kw):
    from repro_torch.launch.server import parse_args
    for key, val in kw.items():
        flag = "--" + key.replace("_", "-")
        argv = argv + ([flag] if val is True else [flag, str(val)])
    return parse_args(argv)


def _tokens(rep) -> dict:
    return {r.rid: r.final_tokens() for r in rep.requests}


def last_logits(sess):
    """A session's last logits, in its decode-batch row if it has one."""
    return sess._batch.last[sess._row] if sess._batch is not None \
        else sess.last[0]


def phase_server_tiny(arch: str = "qwen2.5-14b", label: str = "server_tiny",
                      zero_router: bool = False, capacity_factor: float = 0.0):
    """``arch``'s tiny server on cuda against cpu (same weights):
    shared-prefix turns with prefix reuse, and a burst that fills the
    decode batch (``zero_router`` and ``capacity_factor`` as in
    :func:`phase_tiny`)."""
    import torch
    from repro_torch.launch.server import run
    from repro_torch.models import transformer as T
    cfg = tiny_config(arch, capacity_factor)
    params = T.init_params(cfg, seed=0, device="cpu")
    if not zero_router:
        draw_pred_a(params, torch.Generator().manual_seed(1), "cpu")
    params_gpu = _tree_to(params, "cuda")
    shared = ["--arch", arch, "--tiny", "--workload", "shared-prefix",
              "--prefix-cache", "--turns", "2", "--requests", "8",
              "--prefill-chunk", "8", "--gen-len", "3", "6",
              "--shared-prefix-len", "24", "--max-batch", "4", "--rate", "50",
              "--dram-gb", "0.5"]
    burst = shared[:shared.index("--turns")] + shared[
        shared.index("--requests"):shared.index("--rate")] + [
        "--rate", "1e6", "--dram-gb", "0.5"]
    line = {"phase": label, "config": cfg.name}
    for name, argv in (("shared_prefix", shared), ("burst", burst)):
        runs = {}
        for device, p in (("cuda", params_gpu), ("cpu", params)):
            for extra in ([], ["--no-batched-decode", "--prefill-bucket", "1"]):
                if extra and device == "cpu":
                    continue
                tmp = tempfile.mkdtemp(prefix="m2cache_ssd_")
                try:
                    reset_counts()
                    out, rep, eng, _ = run(server_args(argv + extra,
                                                       device=device),
                                           cfg=cfg, params=p, ssd_dir=tmp)
                    runs[(device, bool(extra))] = (out, _tokens(rep),
                                                   read_counts())
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
        (og, tg, cg), (oc, tc, _), (_, ts, _) = (
            runs[("cuda", False)], runs[("cpu", False)], runs[("cuda", True)])
        og, oc = (json.loads(json.dumps(o, default=float)) for o in (og, oc))
        res = {"tokens_equal_cuda_cpu": tg == tc,
               "modeled_fields_equal": {k: og[k] == oc[k] for k in
                                        ("summary", "kv", "cache", "prefix",
                                         "carbon_g")},
               "tokens_equal_batched_vs_per_session": tg == ts,
               "prefix_hit_tokens": og["summary"].get("prefix_hit_tokens"),
               "decode_rows_per_step": og["summary"]["total_tokens"]
               / max(og["summary"]["decode_steps"], 1),
               "launches_cuda": cg}
        line[name] = res
        require(res["tokens_equal_cuda_cpu"],
                f"{label} {name}: cuda and cpu tokens differ")
        require(all(res["modeled_fields_equal"].values()),
                f"{label} {name}: modeled fields differ: "
                f"{res['modeled_fields_equal']}")
        require(res["tokens_equal_batched_vs_per_session"],
                f"{label} {name}: batched decode changed the tokens")
        require_path_kernels(f"{label} {name}", path_of(cfg, "server"), cg,
                             each_qmm_kernel=False)
    require(line["shared_prefix"]["prefix_hit_tokens"] > 0,
            f"{label}: no prefix hit")
    require(line["burst"]["decode_rows_per_step"] > 1.5,
            f"{label}: the burst never batched decode rows")
    log(line)
    return line


class StepClock:
    """Wall time of every engine decode_step and prefill_step (synchronised
    before and after), each inside a profiler range of its own name, and
    of the model forwards inside them (DecodeBatch.step, the runner's
    block-chunk or whole-prompt prefill), so that a step splits into the forward and the
    engine's own host work (scheduling of rows, active-set unions, the
    modeled clock)."""

    def __init__(self):
        self.decode, self.prefill = [], []      # (wall s, forwards)
        self.forward = {"decode": [], "prefill": []}    # wall s per forward

    def __enter__(self):
        import torch
        from repro_torch.core.engine import M2CacheEngine
        from repro_torch.core.engine_model import DecodeBatch, RealModelRunner
        self._orig = [(M2CacheEngine, "decode_step"),
                      (M2CacheEngine, "prefill_step"),
                      (DecodeBatch, "step"),
                      (RealModelRunner, "_prefill_block"),
                      (RealModelRunner, "_prefill_block_rows"),
                      (RealModelRunner, "_prefill"),
                      (RealModelRunner, "_prefill_rows")]
        self._orig = [(c, n, getattr(c, n)) for c, n in self._orig]

        def timed_step(name, fn, store):
            def wrapper(eng, *a, **kw):
                torch.cuda.synchronize()
                d0, p0 = eng.decode_dispatches, eng.prefill_dispatches
                t0 = time.perf_counter()
                with torch.profiler.record_function(name):
                    out = fn(eng, *a, **kw)
                    torch.cuda.synchronize()
                n = (eng.decode_dispatches - d0) + (eng.prefill_dispatches - p0)
                if n:
                    store.append((time.perf_counter() - t0, n))
                return out
            return wrapper

        def timed_forward(fn, store):
            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                store.append(time.perf_counter() - t0)
                return out
            return wrapper
        (dec, pre, step, block, rows, whole,
         whole_rows) = (f for _, _, f in self._orig)
        M2CacheEngine.decode_step = timed_step("chip_smoke::decode_step", dec,
                                               self.decode)
        M2CacheEngine.prefill_step = timed_step("chip_smoke::prefill_step",
                                                pre, self.prefill)
        DecodeBatch.step = timed_forward(step, self.forward["decode"])
        RealModelRunner._prefill_block = timed_forward(
            block, self.forward["prefill"])
        RealModelRunner._prefill_block_rows = timed_forward(
            rows, self.forward["prefill"])
        # a model without KV payloads (hybrid) prefills whole prompts
        RealModelRunner._prefill = timed_forward(whole, self.forward["prefill"])
        RealModelRunner._prefill_rows = timed_forward(
            whole_rows, self.forward["prefill"])
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._orig:
            setattr(cls, name, fn)

    def summary(self) -> dict:
        dec = [w for w, _ in self.decode]
        pre = [w / n for w, n in self.prefill]
        med = (lambda xs: statistics.median(xs) * 1e3 if xs else None)
        return {"decode_steps": len(dec),
                "decode_step_wall_ms_median": med(dec),
                "decode_forward_wall_ms_median": med(self.forward["decode"]),
                "decode_step_wall_s_total": sum(dec),
                "decode_forward_wall_s_total": sum(self.forward["decode"]),
                "prefill_forwards": sum(n for _, n in self.prefill),
                "prefill_chunk_wall_ms_median": med(pre),
                "prefill_forward_wall_ms_median": med(self.forward["prefill"]),
                "prefill_step_wall_s_total": sum(w for w, _ in self.prefill),
                "prefill_forward_wall_s_total": sum(self.forward["prefill"])}


def profiler_events(prof):
    """(start us, end us, name, on the device) of every event a profiler
    session recorded: from its raw results where the installed torch gives
    them, since parsing them into FunctionEvents (``prof.events()``) costs
    ~70 us an event and a server run records a million; else from
    ``prof.events()``."""
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None and hasattr(raw, "events"):
        for e in raw.events():
            s0 = e.start_ns() / 1e3
            yield (s0, s0 + e.duration_ns() / 1e3, e.name(),
                   e.device_type() == DeviceType.CUDA)
        return
    for e in prof.events():
        yield (e.time_range.start, e.time_range.end, e.name,
               e.device_type == DeviceType.CUDA)


def step_device_time(prof) -> dict:
    """Per kind of engine step (the ``chip_smoke::`` ranges StepClock
    opens): steps, summed wall ms, summed device ms of the CUDA kernels
    that ran inside the steps' ranges, the busy share, and the kernels that
    took the most. Says "not measured" where the profiler saw no kernel."""
    import bisect
    evs = list(profiler_events(prof))
    # a range shows twice: on the host and as an annotation on the device
    spans = [(s0, s1, name.split("::")[1]) for s0, s1, name, on_dev in evs
             if name.startswith("chip_smoke::") and not on_dev]
    kern = sorted((s0, s1, name[:60]) for s0, s1, name, on_dev in evs
                  if on_dev and not name.startswith("chip_smoke::"))
    starts = [k[0] for k in kern]
    out = {}
    for s0, s1, kind in spans:
        d = out.setdefault(kind, {"steps": 0, "wall_ms": 0.0,
                                  "device_ms": 0.0, "top_kernels_ms": {}})
        d["steps"] += 1
        d["wall_ms"] += (s1 - s0) / 1e3
        for k0, k1, name in kern[bisect.bisect_left(starts, s0):
                                 bisect.bisect_right(starts, s1)]:
            d["device_ms"] += (k1 - k0) / 1e3
            top = d["top_kernels_ms"]
            top[name] = top.get(name, 0.0) + (k1 - k0) / 1e3
    for d in out.values():
        if not d["device_ms"]:
            d.update(device_ms="not measured", top_kernels_ms={})
            continue
        d["busy_share"] = d["device_ms"] / d["wall_ms"]
        d["device_ms_per_step"] = d["device_ms"] / d["steps"]
        d["top_kernels_ms"] = dict(sorted(d["top_kernels_ms"].items(),
                                          key=lambda kv: -kv[1])[:8])
    return out


def phase_server_full(full, cfg, params, label: str = "server_full",
                      ssd_dir: str = None, per_session: bool = False) -> dict:
    """``full_model``'s weights through the server on server_full's traffic:
    cold with the prefix cache (the counted run), warm from the tree it
    persisted (profiled), and with the prefix cache off; with
    ``per_session`` also with batched decode off. The SSD tier's bank files
    go to ``ssd_dir`` (kept, shared by the runs) or to one temporary
    directory a run (removed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.server import run
    torch.cuda.synchronize()
    argv0 = ["--arch", full.name] + SERVER_FULL[2:]
    tmp = tempfile.mkdtemp(prefix="m2cache_server_")
    persist = str(Path(tmp) / "radix")
    res = {}
    try:
        def serve(name, argv):
            with StepClock() as clock:
                t0 = time.perf_counter()
                out, rep, eng, _ = run(server_args(argv, device="cuda"),
                                       cfg=cfg, params=params,
                                       ssd_dir=ssd_dir or str(Path(tmp) / name))
                wall = time.perf_counter() - t0
            res[name] = {"out": json.loads(json.dumps(out, default=float)),
                         "tokens": _tokens(rep), "wall_s": wall,
                         "steps": clock.summary(),
                         "restored": eng.prefix_restored_tokens,
                         "finite": all(bool(torch.isfinite(last_logits(
                             r.session)).all()) for r in rep.requests)}
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        serve("cold", argv0 + ["--prefix-cache", "--prefix-persist", persist])
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve("warm", argv0 + ["--prefix-cache", "--prefix-persist",
                                   persist])
        serve("off", argv0)
        if per_session:
            serve("per_session", argv0 + ["--no-batched-decode",
                                          "--prefill-bucket", "1"])
        cost = decode_forward_cost(cfg, params, SERVER_DECODE_LENGTHS,
                                   SERVER_BUCKET, rows=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    toks = {k: res[k]["tokens"] for k in res}
    line = {
        "phase": label, "config": cfg.name,
        "depth_cut": f"num_layers {full.num_layers} -> {cfg.num_layers}",
        "args": argv0, "peak_mem_gb": peak_gb, "launches": counts,
        "tokens_equal_cold_warm_off": toks["cold"] == toks["warm"]
        == toks["off"],
        "rids_differing": sorted(r for r in toks["cold"] if not (
            toks["cold"][r] == toks["warm"].get(r) == toks["off"].get(r))),
        "prefix_hit_tokens": {k: res[k]["out"]["summary"].get(
            "prefix_hit_tokens") for k in ("cold", "warm")},
        "prefix_restored_tokens": {k: res[k]["restored"]
                                   for k in ("cold", "warm")},
        "persist": res["warm"]["out"]["persist"],
        "wall_s": {k: res[k]["wall_s"] for k in res},
        "steps_cold": res["cold"]["steps"], "steps_off": res["off"]["steps"],
        "steps_warm_profiled": res["warm"]["steps"],
        "device_in_steps_warm": step_device_time(prof),
        "decode_forward": cost,
        "summary_cold": res["cold"]["out"]["summary"],
        "finite_logits": all(res[k]["finite"] for k in res),
        "tokens": res["cold"]["tokens"]}
    if per_session:
        line["tokens_equal_batched_vs_per_session"] = \
            toks["per_session"] == toks["off"]
        line["steps_per_session"] = res["per_session"]["steps"]
    log(line)
    require(line["finite_logits"], f"{label}: non-finite logits")
    require(line["tokens_equal_cold_warm_off"],
            f"{label}: tokens differ between cold, warm and prefix-off")
    require((line["prefix_hit_tokens"]["warm"] or 0) > 0,
            f"{label}: the warm run hit no prefix")
    require(line.get("tokens_equal_batched_vs_per_session", True),
            f"{label}: batched decode changed the tokens")
    require_path_kernels(label, path_of(cfg, "server"), counts)
    return counts, line



# ---------------------------------------------------------------------------
# Phases 7 to 9: the observed server, the fleet and the divergence probe


def full_model(arch: str = "qwen2.5-14b", layers: int = FULL_LAYERS,
               device: str = "cuda"):
    """``arch`` at full width, depth cut to ``layers``, random weights:
    seed 0, predictor A drawn from seed 1 on the device."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    params = T.init_params(cfg, seed=0, device=device)
    draw_pred_a(params, torch.Generator(device=device).manual_seed(1), device)
    return full, cfg, params


#: the observability outputs of server_obs_full: flag -> file name
OBS_OUTPUTS = {"--trace-out": "run.trace.json", "--metrics-out": "run.prom",
               "--block-trace-out": "run.blocks.jsonl",
               "--ledger": "run.ledger.json",
               "--health-out": "run.alerts.jsonl"}


def check_observed_run(tmp: Path, rep, sched) -> dict:
    """The requirements on one observed server run: its ledger conserves,
    every request has its queued, prefill and decode spans, the block trace
    reads back, and the ledger rebuilt from the trace alone equals the
    live one. Returns what was read."""
    from repro_torch.obs import (events_from_chrome, read_block_trace,
                                 reconstruct)
    doc = json.loads((tmp / OBS_OUTPUTS["--trace-out"]).read_text())
    events = events_from_chrome(doc)
    spans = {}
    for ev in events:
        if ev["kind"] == "span" and ev["track"].startswith("req"):
            spans.setdefault(ev["track"], set()).add(ev["name"])
    blocks = list(read_block_trace(tmp / OBS_OUTPUTS["--block-trace-out"]))
    with open(tmp / OBS_OUTPUTS["--block-trace-out"]) as f:
        header = json.loads(f.readline())
    live, back = sched.ledger.summary(), reconstruct(events).summary()
    keys = ("time_s", "gco2_g", "span_s", "horizon_s", "gco2_total_g")
    got = {"ledger_check": sched.ledger.check(),
           "requests_with_all_spans": sum(
               {"queued", "prefill", "decode"} <= spans.get(f"req:{r.rid}",
                                                            set())
               for r in rep.requests),
           "requests": len(rep.requests),
           "block_events_read": len(blocks),
           "block_events_header": header["events"],
           "ledger_from_trace_equal": all(back[k] == live[k] for k in keys),
           "trace_events": len(doc["traceEvents"]),
           "metric_snapshots": len((tmp / (OBS_OUTPUTS["--metrics-out"]
                                           + ".jsonl")).read_text()
                                   .splitlines())}
    require(not got["ledger_check"],
            f"server_obs_full: the ledger does not conserve: "
            f"{got['ledger_check']}")
    require(got["requests_with_all_spans"] == got["requests"],
            "server_obs_full: a request lacks its queued, prefill or decode "
            "span in the trace")
    require(0 < got["block_events_read"] == got["block_events_header"],
            "server_obs_full: the block trace does not read back")
    require(got["ledger_from_trace_equal"],
            "server_obs_full: the ledger rebuilt from the trace differs")
    return got


def phase_server_obs_full(cfg, params) -> dict:
    """server_full's traffic at full width (prefix cache cold) with every
    observability output on, against the same run with every output off:
    the same tokens, and the host cost of the outputs (runs off, on, on,
    off in one call)."""
    import torch
    from repro_torch.launch.server import run
    t_phase = time.perf_counter()
    argv = SERVER_FULL + ["--prefix-cache"]
    tmp = Path(tempfile.mkdtemp(prefix="m2cache_obs_"))
    res, counts = {}, None
    try:
        for i, on in enumerate((False, True, True, False)):
            label = f"{'on' if on else 'off'}{i}"
            extra = []
            if on:
                out_dir = tmp / label
                out_dir.mkdir()
                extra = ["--metrics-interval", "0.01"]
                for flag, name in OBS_OUTPUTS.items():
                    extra += [flag, str(out_dir / name)]
            first_on = on and counts is None
            if first_on:
                reset_counts()
            with StepClock() as clock:
                t0 = time.perf_counter()
                out, rep, eng, sched = run(
                    server_args(argv + extra, device="cuda"), cfg=cfg,
                    params=params, ssd_dir=str(tmp / f"ssd{i}"))
                wall = time.perf_counter() - t0
            if first_on:
                counts = read_counts()
            res[label] = {"out": json.loads(json.dumps(out, default=float)),
                          "tokens": _tokens(rep), "wall_s": wall,
                          "steps": clock.summary(),
                          "finite": all(bool(torch.isfinite(last_logits(
                              r.session)).all()) for r in rep.requests)}
            if on:
                res[label]["read"] = check_observed_run(out_dir, rep, sched)
            shutil.rmtree(tmp / f"ssd{i}", ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    toks = [r["tokens"] for r in res.values()]
    med = {k: statistics.median(
        r["steps"]["decode_step_wall_ms_median"] for l, r in res.items()
        if l.startswith(k)) for k in ("on", "off")}
    on = res["on1"]["out"]
    line = {
        "phase": "server_obs_full", "config": cfg.name,
        "args": argv + ["--metrics-interval", "0.01"] + list(OBS_OUTPUTS),
        "launches": counts, "tokens_equal_on_off": all(t == toks[0]
                                                       for t in toks),
        "obs": on["obs"], "ledger": on["ledger"], "health": on["health"],
        "read_back": res["on1"]["read"],
        "decode_step_wall_ms_median": {l: r["steps"][
            "decode_step_wall_ms_median"] for l, r in res.items()},
        "prefill_chunk_wall_ms_median": {l: r["steps"][
            "prefill_chunk_wall_ms_median"] for l, r in res.items()},
        "decode_step_wall_ms_median_on_off": med,
        "obs_decode_step_host_cost_ms": med["on"] - med["off"],
        "run_wall_s": {l: r["wall_s"] for l, r in res.items()},
        "finite_logits": all(r["finite"] for r in res.values()),
        "seconds": time.perf_counter() - t_phase}
    log(line)
    require(line["finite_logits"], "server_obs_full: non-finite logits")
    require(line["tokens_equal_on_off"],
            "server_obs_full: the outputs changed the tokens")
    require(on["ledger"]["conserved"], "server_obs_full: ledger not conserved")
    require_path_kernels("server_obs_full", "server", counts)
    return counts


def phase_cluster_full(cfg, params) -> dict:
    """Two replicas behind the prefix router at full width (one params tree
    on the card; the modeled devices an RTX 3090 and an M40) over
    server_full's traffic; each replica's tokens against a standalone run
    of its sub-trace."""
    import torch
    from repro_torch.launch.server import build_replica, run_cluster
    from repro_torch.serving import validate_cluster_summary
    t_phase = time.perf_counter()
    argv = SERVER_FULL + ["--replicas", "2", "--router", "prefix",
                          "--replica-devices", "rtx3090,m40"]
    args = server_args(argv, device="cuda")
    tmp = Path(tempfile.mkdtemp(prefix="m2cache_fleet_"))
    try:
        reset_counts()
        t0 = time.perf_counter()
        out, router = run_cluster(args, cfg=cfg, params=params,
                                  ssd_dir=str(tmp / "fleet"))
        fleet_s = time.perf_counter() - t0
        counts = read_counts()
        out = json.loads(json.dumps(out, default=float))
        shutil.rmtree(tmp / "fleet", ignore_errors=True)
        solo = {}
        for r in router.replicas:
            t0 = time.perf_counter()
            alone = build_replica(args, f"solo-{r.name}", r.device_name,
                                  r.carbon_trace, cfg=cfg, params=params,
                                  ssd_dir=str(tmp / r.name))
            alone.events = list(r.events)
            alone.run(vocab_size=cfg.vocab_size, horizon_s=args.horizon)
            solo[r.name] = {"tokens_equal": alone.tokens() == r.tokens(),
                            "summary_equal": alone.report.summary()
                            == r.report.summary(),
                            "wall_s": time.perf_counter() - t0}
            shutil.rmtree(tmp / r.name, ignore_errors=True)
        finite = all(bool(torch.isfinite(last_logits(q.session)).all())
                     for r in router.replicas for q in r.report.requests)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = {"phase": "cluster_full", "config": cfg.name, "args": argv,
            "launches": counts, "summary": out["summary"],
            "replicas": out["replicas"], "router": out["router"],
            "standalone": solo,
            "fleet_wall_s": fleet_s, "finite_logits": finite,
            "seconds": time.perf_counter() - t_phase}
    log(line)
    validate_cluster_summary(out["summary"], context="cluster_full")
    require(finite, "cluster_full: non-finite logits")
    require(all(v["tokens_equal"] for v in solo.values()),
            "cluster_full: a replica's tokens differ from a standalone run "
            f"of its sub-trace: {solo}")
    require(all(v["summary"]["requests"] > 0
                for v in out["replicas"].values()),
            "cluster_full: a replica served no request")
    require_path_kernels("cluster_full", "server", counts)
    return counts


#: the reference's probe settings (tests/test_kv_residency.py)
DIVERGENCE_SEEDS = range(4)
DIVERGENCE = dict(gen_len=8, k=5)


def _probes(cfg, params, device: str) -> dict:
    import numpy as np
    from repro_torch.eval import kv_divergence_probe
    out = {}
    for prec in ("int8", "int4"):
        for seed in DIVERGENCE_SEEDS:
            prompt = np.random.default_rng(seed).integers(
                0, cfg.vocab_size, 24).tolist()
            out[prec, seed] = kv_divergence_probe(
                cfg, params, prompt, precision=prec, device=device,
                **DIVERGENCE).to_dict()
    return out


def phase_divergence(cfg, params) -> dict:
    """The KV-divergence probe: tiny on the card against the CPU (same
    weights), then the reference's probe settings at full width. The
    full-width numbers are of random weights and carry no gate."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    tiny = get_config("qwen2.5-14b", tiny=True)
    tp = T.init_params(tiny, seed=0, device="cpu")
    draw_pred_a(tp, torch.Generator().manual_seed(1), "cpu")
    on_card, on_cpu = (_probes(tiny, p, d) for p, d in
                       ((_tree_to(tp, "cuda"), "cuda"), (tp, "cpu")))
    exact = ("topk_overlap_mean", "topk_overlap_min",
             "first_token_divergence", "token_match_rate")
    tiny_equal = all(on_card[key][f] == on_cpu[key][f]
                     for key in on_cpu for f in exact)
    tiny_err = max(abs(on_card[key][f] - on_cpu[key][f]) for key in on_cpu
                   for f in ("max_abs_diff", "mean_abs_diff"))
    reset_counts()
    t0 = time.perf_counter()
    full = _probes(cfg, params, "cuda")
    full_s = time.perf_counter() - t0
    counts = read_counts()
    per_prec = {}
    for prec in ("int8", "int4"):
        reps = [full[prec, s] for s in DIVERGENCE_SEEDS]
        per_prec[prec] = {
            "topk_overlap_mean": statistics.mean(
                r["topk_overlap_mean"] for r in reps),
            "topk_overlap_per_seed": [r["topk_overlap_mean"] for r in reps],
            "max_abs_diff_worst": max(r["max_abs_diff"] for r in reps),
            "first_token_divergence_per_seed": [
                r["first_token_divergence"] for r in reps],
            "token_match_rate_mean": statistics.mean(
                r["token_match_rate"] for r in reps)}
    line = {"phase": "divergence", "config": cfg.name,
            "probe": {"seeds": list(DIVERGENCE_SEEDS), "prompt_len": 24,
                      **DIVERGENCE},
            "tiny_cuda_equals_cpu": tiny_equal,
            "tiny_logit_diff_max_abs_err": tiny_err, "tiny_tol": 1e-4,
            "tiny": {f"{p}/{s}": on_card[p, s] for p, s in on_card},
            "full_width_random_weights": per_prec, "launches": counts,
            "full_width_s": full_s,
            "finite": all(all(math.isfinite(v) for v in r.values()
                              if isinstance(v, float)) for r in full.values()),
            "seconds": time.perf_counter() - t_phase}
    log(line)
    require(tiny_equal, "divergence: tiny probe on the card differs from "
                        "the CPU in overlaps or first divergence")
    require(tiny_err <= 1e-4,
            f"divergence: tiny logit differences differ by {tiny_err:.3g}")
    require(line["finite"], "divergence: non-finite full-width numbers")
    require_path_kernels("divergence", "divergence", counts)
    return counts


#: dense_archs: each dense-attention config the port serves besides
#: qwen2.5-14b, at full width with its depth cut to this many layers
#: (so that the script ends within its time on a slow host)
DENSE_ARCHS = {"qwen2.5-32b": 2, "command-r-35b": 2,
               "mistral-large-123b": 2, "internvl2-1b": 3}


def phase_dense_archs(B: int, P: int, gen_len: int) -> dict:
    """Each config of DENSE_ARCHS in turn: its tiny config through
    launch/serve and launch/server on cuda against cpu; then at full width
    (depth cut) full's serve traffic and server_full's server traffic (the
    prefix cache cold, warm and off, and batched decode off), every main
    path kernel launched; the card freed and the bank files removed before
    the next config. Returns each path's launch counts, keyed
    "<arch>/serve" and "<arch>/server"."""
    import gc
    import torch
    paths = {}
    for arch, layers in DENSE_ARCHS.items():
        t_arch = time.perf_counter()
        tiny = phase_tiny(arch, label=f"dense_archs {arch} tiny")
        server_tiny = phase_server_tiny(arch,
                                        label=f"dense_archs {arch} server_tiny")
        t0 = time.perf_counter()
        full, cfg, params = full_model(arch, layers)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tmp = tempfile.mkdtemp(prefix="m2cache_ssd_")
        try:
            paths[f"{arch}/serve"], serve = phase_full(
                full, cfg, params, B, P, gen_len,
                label=f"dense_archs {arch} serve", ssd_dir=tmp)
            paths[f"{arch}/server"], srv = phase_server_full(
                full, cfg, params, label=f"dense_archs {arch} server",
                ssd_dir=tmp, per_session=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        dev_srv = srv["device_in_steps_warm"]
        log({"phase": "dense_archs", "config": arch,
             "depth_cut": serve["depth_cut"],
             "widths": serve["widths"], "param_gb": serve["param_gb"],
             "init_s": init_s, "ssd_bank_files_gb": serve["ssd_bank_files_gb"],
             "tiny_tokens_equal_cuda_cpu": tiny["tokens_equal"],
             "server_tiny_tokens_equal_cuda_cpu": all(
                 server_tiny[k]["tokens_equal_cuda_cpu"]
                 for k in ("shared_prefix", "burst")),
             "serve": {
                 "prefill_wall_ms": serve["prefill_wall_s"] * 1e3,
                 "decode_step_wall_ms_median":
                     serve["decode_wall_s_median"] * 1e3,
                 "prefill_device_ms":
                     serve["profile"]["prefill"].get("device_ms"),
                 "decode_step_device_ms":
                     serve["profile"]["decode_step"].get("device_ms"),
                 "launches": paths[f"{arch}/serve"]},
             "server": {
                 "tokens_equal_cold_warm_off":
                     srv["tokens_equal_cold_warm_off"],
                 "tokens_equal_batched_vs_per_session":
                     srv["tokens_equal_batched_vs_per_session"],
                 "decode_step_wall_ms_median":
                     srv["steps_cold"]["decode_step_wall_ms_median"],
                 "prefill_chunk_wall_ms_median":
                     srv["steps_cold"]["prefill_chunk_wall_ms_median"],
                 "decode_step_device_ms": dev_srv.get("decode_step", {}).get(
                     "device_ms_per_step", "not measured"),
                 "prefill_step_device_ms": dev_srv.get("prefill_step", {}).get(
                     "device_ms_per_step", "not measured"),
                 "peak_mem_gb": srv["peak_mem_gb"],
                 "launches": paths[f"{arch}/server"]},
             "seconds": time.perf_counter() - t_arch})
    return paths


# ---------------------------------------------------------------------------
# Phase 2, continued, and phase 11: the MoE family


#: moe_archs: each MoE config the port serves, with the depth it runs at
#: full width (None: tiny only; llama4's full width needs 73 GB of fp32
#: tables and experts before any K/V, and waits for a bf16 path)
MOE_ARCHS = {"grok-1-314b": 1, "llama4-maverick-400b-a17b": None}


def phase_kernels_moe(dev, B: int, P: int, gen_len: int, R: int = 4,
                      chunk: int = 16, sbuf: int = 256) -> dict:
    """The three attention kernels' softcap forms at grok-1-314b's shapes
    (G = 6, D = 128, cap 30): flash_decode at the serve step (ring of
    holes, a row with no valid slot, NaN/Inf in masked slots, a row alone
    against the row in the group, ranges 32 and 64) and over a server
    decode batch, the whole prompt and the chunk at an offset (each key
    split), at scores of about +-60 where the cap saturates. Each against
    its plain version (capped too), timed beside it and the bound, the
    uncapped form's device time beside it; the library call is compiled
    flex_attention with the same cap and mask, SDPA (uncapped) only a
    yardstick."""
    import torch
    from repro_torch.configs.base import get_config
    g = torch.Generator(device=dev).manual_seed(9012)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    cfg = get_config("grok-1-314b")
    hq, hkv, D, cap = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.logit_softcap)
    G = hq // hkv
    out, checks = {}, []
    check = checker(checks)
    S, lengths = DECODE_ROWS["flash_decode"]
    out["flash_decode_softcap"] = decode_row(
        check, randn, dev, "flash_decode_softcap", S, hkv, G, D, lengths,
        holes=True, full_checks=True, sweep=(32, 64), softcap=cap)
    S, lengths = DECODE_ROWS["flash_decode_rows"]
    out["flash_decode_rows_softcap"] = decode_row(
        check, randn, dev, "flash_decode_rows_softcap", S, hkv, G, D,
        lengths[:R], full_checks=True, softcap=cap)
    out["flash_attention_softcap"] = whole_prompt_row(
        check, randn, dev, B, P, hq, hkv, D, softcap=cap)
    out["chunk_attention_softcap"] = chunk_rows(
        check, randn, dev, pos0=[0, 48, 96, 112][:R], chunk=chunk, sbuf=sbuf,
        hq=hq, hkv=hkv, D=D, splits=(0, 32, 64), softcap=cap)
    for row in out.values():
        row["config"] = cfg.name
    torch.cuda.empty_cache()
    log({"phase": "kernels_moe", "checks": checks, "kernels": out})
    return out


@contextlib.contextmanager
def moe_drops():
    """Record every moe_ffn call's input shape and dropped fraction, and for
    each shape of more than one token a row the first call's routing: its
    input, router and what ``moe.route`` returned (all kept on the device
    until the run ends). Yields (calls, routed)."""
    from repro_torch.models import moe
    calls, routed = [], {}
    real_ffn, real_route = moe.moe_ffn, moe.route

    def counted(x, *a, **kw):
        y, aux = real_ffn(x, *a, **kw)
        calls.append((tuple(x.shape), aux["dropped_frac"]))
        return y, aux

    def route(x, router_w, **kw):
        out = real_route(x, router_w, **kw)
        if x.shape[1] > 1 and tuple(x.shape) not in routed:
            routed[tuple(x.shape)] = (x, router_w, kw, out)
        return out
    moe.moe_ffn, moe.route = counted, route
    try:
        yield calls, routed
    finally:
        moe.moe_ffn, moe.route = real_ffn, real_route


def drop_summary(calls) -> dict:
    """Dropped fraction of the recorded moe_ffn calls, by tokens a row."""
    by = {}
    for shape, frac in calls:
        by.setdefault(shape[1], []).append(float(frac))
    return {f"S={S}": {"calls": len(v), "mean": sum(v) / len(v),
                       "max": max(v)} for S, v in sorted(by.items())}


def route_on_cpu(label: str, routed) -> dict:
    """Each recorded routing of :func:`moe_drops` done again on the CPU from
    the same input and router: experts, positions and keep must equal the
    card's (logits within 1e-5 x max(1, max|logits|)). Returns, by tokens
    a row, the capacity, each row's choices and kept choices per expert,
    the logits' difference, and the mean cosine of two tokens' inputs in
    one row and in two rows (how much a row's tokens share, and so which
    experts they favour)."""
    import torch
    from repro_torch.models import moe
    out = {}
    for shape, (x, router_w, kw, card) in sorted(routed.items()):
        cpu = moe.route(x.cpu(), router_w.cpu(), **kw)
        _, _, experts, pos, keep, C = (t.cpu() if torch.is_tensor(t) else t
                                       for t in card)
        for name, a, b in (("experts", experts, cpu[2]),
                           ("positions", pos, cpu[3]), ("keep", keep, cpu[4])):
            require(torch.equal(a, b),
                    f"{label}: {name} of the card's routing at {shape} differ "
                    f"from the CPU's")
        require(C == cpu[5], f"{label}: capacity {C} against {cpu[5]}")
        err = max_err(card[0].cpu(), cpu[0])
        require(err <= 1e-5 * max(1.0, float(cpu[0].abs().max())),
                f"{label}: router logits at {shape} differ by {err:.3g}")
        E, flat = kw["E"], experts.reshape(shape[0], -1)
        load = [torch.bincount(r, minlength=E).tolist() for r in flat]
        kept = [torch.bincount(r[k], minlength=E).tolist()
                for r, k in zip(flat, keep)]
        u = torch.nn.functional.normalize(x.cpu().double(), dim=-1)
        cos = torch.einsum("bsd,ctd->bsct", u, u)      # every pair of tokens
        same = torch.eye(shape[0], dtype=torch.bool)[:, None, :, None]
        off = ~torch.eye(shape[1], dtype=torch.bool)[None, :, None, :]
        within = cos[(same & off).expand_as(cos)]
        across = cos[(~same).expand_as(cos)]
        out[f"S={shape[1]}"] = {
            "rows": shape[0], "capacity": C, "choices_per_expert": load,
            "kept_per_expert": kept, "logits_max_abs_err": err,
            "equal_on_cpu": True,
            "input_cosine_within_row_mean": float(within.mean()),
            "input_cosine_across_rows_mean": (float(across.mean())
                                              if across.numel() else None)}
    return out


def phase_moe_archs(B: int, P: int, gen_len: int) -> dict:
    """Each config of MOE_ARCHS in turn: its tiny config through launch/serve
    and launch/server on cuda against cpu, with a drawn router and with the
    reference's zero router (ties); then, where it runs at full width (depth
    cut), full's serve traffic and server_full's server traffic (the prefix
    cache cold, warm, off, and batched decode off: tokens equal), every
    kernel of each path launched (the attention kernels' softcap forms
    where the config caps, no qmatmul), the tokens dropped at prefill, wall
    and device time per decode step and prefill chunk; the card freed and
    the bank files removed afterwards. Returns each full path's launch
    counts, keyed "<arch>/serve" and "<arch>/server"."""
    import gc
    import torch
    from repro_torch.configs.base import get_config
    paths = {}
    for arch, layers in MOE_ARCHS.items():
        t_arch = time.perf_counter()
        tiny, tiny_drops = {}, {}
        cap = get_config(arch).moe_capacity_factor
        for key, zero, factor in (("drawn_router", False, 0.0),
                                  ("zero_router", True, 0.0),
                                  (f"drawn_router_capacity_{cap:g}", False,
                                   cap)):
            with moe_drops() as (calls, _):
                tiny[key] = (
                    phase_tiny(arch, label=f"moe_archs {arch} tiny {key}",
                               zero_router=zero, capacity_factor=factor),
                    phase_server_tiny(arch, label=f"moe_archs {arch} "
                                      f"server_tiny {key}", zero_router=zero,
                                      capacity_factor=factor))
            tiny_drops[key] = drop_summary(calls)
        dropped = max(v["max"] for v in tiny_drops[key].values())
        require(dropped > 0, f"moe_archs {arch}: no token dropped at "
                f"capacity {cap:g}")
        line = {"phase": "moe_archs", "config": arch,
                "tiny_dropped_frac": tiny_drops,
                "tiny_tokens_equal_cuda_cpu": {
                    k: t["tokens_equal"] for k, (t, _) in tiny.items()},
                "server_tiny_tokens_equal_cuda_cpu": {
                    k: all(st[w]["tokens_equal_cuda_cpu"]
                           for w in ("shared_prefix", "burst"))
                    for k, (_, st) in tiny.items()}}
        if layers is None:
            line.update(full_width="not run: tiny only",
                        seconds=time.perf_counter() - t_arch)
            log(line)
            continue
        t0 = time.perf_counter()
        full, cfg, params = full_model(arch, layers)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tmp = tempfile.mkdtemp(prefix="m2cache_ssd_")
        try:
            with moe_drops() as (serve_calls, serve_routed):
                paths[f"{arch}/serve"], serve = phase_full(
                    full, cfg, params, B, P, gen_len,
                    label=f"moe_archs {arch} serve", ssd_dir=tmp)
            with moe_drops() as (server_calls, server_routed):
                paths[f"{arch}/server"], srv = phase_server_full(
                    full, cfg, params, label=f"moe_archs {arch} server",
                    ssd_dir=tmp, per_session=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        routing = {
            "serve": route_on_cpu(f"moe_archs {arch} serve", serve_routed),
            "server": route_on_cpu(f"moe_archs {arch} server", server_routed)}
        del serve_routed, server_routed
        del params
        gc.collect()
        torch.cuda.empty_cache()
        dev_srv = srv["device_in_steps_warm"]
        line.update({
            "depth_cut": serve["depth_cut"], "widths": serve["widths"],
            "experts": (full.num_experts, full.num_experts_per_tok),
            "capacity_factor": full.moe_capacity_factor,
            "logit_softcap": full.logit_softcap,
            "param_gb": serve["param_gb"], "init_s": init_s,
            "ssd_bank_files_gb": serve["ssd_bank_files_gb"],
            "dropped_frac_serve": drop_summary(serve_calls),
            "dropped_frac_server": drop_summary(server_calls),
            "routing_at_prefill": routing,
            "serve": {
                "prefill_wall_ms": serve["prefill_wall_s"] * 1e3,
                "decode_step_wall_ms_median":
                    serve["decode_wall_s_median"] * 1e3,
                "prefill_device_ms":
                    serve["profile"]["prefill"].get("device_ms"),
                "prefill_busy_share":
                    serve["profile"]["prefill"].get("busy_share"),
                "decode_step_device_ms":
                    serve["profile"]["decode_step"].get("device_ms"),
                "decode_step_busy_share":
                    serve["profile"]["decode_step"].get("busy_share"),
                "peak_mem_gb": serve["peak_mem_gb"],
                "launches": paths[f"{arch}/serve"]},
            "server": {
                "tokens_equal_cold_warm_off":
                    srv["tokens_equal_cold_warm_off"],
                "tokens_equal_batched_vs_per_session":
                    srv["tokens_equal_batched_vs_per_session"],
                "decode_step_wall_ms_median":
                    srv["steps_cold"]["decode_step_wall_ms_median"],
                "prefill_chunk_wall_ms_median":
                    srv["steps_cold"]["prefill_chunk_wall_ms_median"],
                "decode_step_device_ms": dev_srv.get("decode_step", {}).get(
                    "device_ms_per_step", "not measured"),
                "decode_step_busy_share": dev_srv.get("decode_step", {}).get(
                    "busy_share", "not measured"),
                "prefill_step_device_ms": dev_srv.get("prefill_step", {}).get(
                    "device_ms_per_step", "not measured"),
                "prefill_step_busy_share": dev_srv.get("prefill_step", {}).get(
                    "busy_share", "not measured"),
                "peak_mem_gb": srv["peak_mem_gb"],
                "launches": paths[f"{arch}/server"]},
            "seconds": time.perf_counter() - t_arch})
        log(line)
    return paths


# ---------------------------------------------------------------------------
# Phase 2, continued, and phase 12: the hybrid family (recurrentgemma-2b)


#: hybrid_arch: the hybrid config, the depth it runs at full width (8 of
#: its 26 layers: 2 repeats of (rglru, rglru, attn) and a remainder of 2,
#: so that the script ends within its time on a slow host), and the
#: ring run's traffic: 2 prompts of the window + 128 tokens, so that the
#: prefill's window masks the last 128 queries and decode wraps the ring
HYBRID_ARCH = ("recurrentgemma-2b", 8)
RING_RUN = dict(B=2, P=2048 + 128, gen_len=16)
#: decode consistency: a decode step's logits against one whole-prompt
#: prefill's at the same position, within RING_TOL x max(1, max|prefill|),
#: the tolerance cuda against cpu logits are held to: the two paths run
#: other kernels (flash_decode against flash_attention, qmatmul kernel A
#: against B, one recurrent step against the scan), each fp32 to ~1e-6,
#: through all layers. For the ring run the plain versions at d = 256 (26
#: layers) stayed at 0.013 of it, and a decode step writing the slot after
#: its own went 23x over it
RING_TOL = 1e-4


def phase_kernels_hybrid(dev, B: int, P: int, gen_len: int) -> dict:
    """The kernels at recurrentgemma-2b's shapes (head dim 256, G = 10 over
    one KV head: two head groups of 5): flash_decode at the serve step (a
    row of holes, a row with no valid slot, NaN/Inf in masked slots, a row
    alone against the row in the group, ranges 32 and 64) and over the
    window's 2048-slot ring, wrapped (lengths 2176 and 2191); the whole
    prompt at the serve prefill (scores to about +-60 against float64,
    paired and unpaired query tiles) and at 2176 tokens within the 2048
    window (a row alone against the row in the group); one layer's FFN at
    d = 2560, f = 7680 with GELU at the serve shapes through kernels A and
    B. Each against its plain version, timed beside it, the library call
    (for the window: SDPA with the window as a boolean mask) and the
    bounds."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import _plan as whole_plan
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator(device=dev).manual_seed(2560)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    cfg = get_config(HYBRID_ARCH[0])
    hq, hkv, D, W = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.window_size)
    G = hq // hkv
    out, checks = {}, []
    check = checker(checks)
    S, lengths = DECODE_ROWS["flash_decode"]
    out["flash_decode_d256"] = decode_row(
        check, randn, dev, "flash_decode_d256", S, hkv, G, D, lengths,
        holes=True, full_checks=True, sweep=(32, 64))
    rb, rp, rg = RING_RUN["B"], RING_RUN["P"], RING_RUN["gen_len"]
    out["flash_decode_ring_d256"] = decode_row(
        check, randn, dev, "flash_decode_ring_d256", W, hkv, G, D,
        [rp, rp + rg - 1][:rb], full_checks=True, sweep=(32, 64, 256),
        ring=True, plain_reps=5)
    out["flash_attention_d256"] = whole_prompt_row(check, randn, dev, B, P,
                                                   hq, hkv, D)

    # the whole prompt of the ring run, within the window
    q, kp, vp = randn(rb, rp, hq, D), randn(rb, rp, hkv, D), randn(rb, rp,
                                                                  hkv, D)
    got = flash_attention(q, kp, vp, window=W)
    err = check(f"flash_attention D={D} S={rp} window={W}", got,
                ref.flash_attention_ref(q, kp, vp, window=W), 1e-5)
    alone = flash_attention(q[1:2].contiguous(), kp[1:2].contiguous(),
                            vp[1:2].contiguous(), window=W)
    require(torch.equal(alone[0], got[1]), "flash_attention window: a row "
            "alone differs from the same row in a group")
    del alone
    qt = q.transpose(1, 2).contiguous()
    kt, vt = kp.transpose(1, 2).contiguous(), vp.transpose(1, 2).contiguous()
    i = torch.arange(rp, device=dev)
    mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - W)
    pairs = int(mask.sum())
    out["flash_attention_window_d256"] = {
        "max_abs_err": err, "B": rb, "S": rp, "Hq": hq, "Hkv": hkv, "D": D,
        "window": W, "key_query_pairs": pairs,
        "plan": whole_plan(rp, hq, hkv, D, build.sm_count(dev))._asdict(),
        "library": "SDPA, the window as a boolean mask, enable_gqa",
        **kernel_row(lambda: flash_attention(q, kp, vp, window=W),
                        lambda: ref.flash_attention_ref(q, kp, vp, window=W),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask, enable_gqa=True),
                        (2 * q.numel() + 2 * kp.numel()) * 4,
                        4 * rb * hq * D * pairs, plain_reps=5)}
    del q, kp, vp, qt, kt, vt, got, mask
    rows = serve_ffn_rows(check, g, dev, cfg, B, P)[0]
    for name, row in rows.items():
        out[f"{name}_d{cfg.d_model}"] = dict(row, d=cfg.d_model, f=cfg.d_ff,
                                             act=cfg.ffn_act)
    for row in out.values():
        row["config"] = cfg.name
    torch.cuda.empty_cache()
    log({"phase": "kernels_hybrid", "checks": checks, "kernels": out})
    return out


@contextlib.contextmanager
def predictor_zeroed(params):
    """Every layer's predictor A at the reference's init, zero: every score
    ties and every active set is 0..k-1, whatever the tokens, so that a
    decode step and a prefill run one FFN function."""
    saved = [layer["ffn"]["pred"]["A"] for layer in params["layers"]]
    for layer, a in zip(params["layers"], saved):
        layer["ffn"]["pred"]["A"] = a.new_zeros(a.shape)
    try:
        yield
    finally:
        for layer, a in zip(params["layers"], saved):
            layer["ffn"]["pred"]["A"] = a


def decode_consistency(cfg, params, tokens, gen_len: int, steps,
                       prefix=None, window: int = 0) -> dict:
    """A prefill of ``tokens`` ((B, S), or (B, K, S) codebooks, after
    ``prefix`` frames where given), then gen_len greedy decode steps through
    ``forward``; at each step of ``steps`` the step's logits against those
    of one whole-prompt prefill over the prompt and the tokens generated so
    far, at the same position, within RING_TOL x max(1, max|prefill|): the
    recurrent or cached decode against the prefill's chunked scan or whole
    prompt. A model with an M2Cache FFN runs with the predictor at the
    reference's zero init (every active set 0..k-1 in both paths).
    ``window``: the long-context override, a ring of that many slots.
    Whether each checked step's greedy token equals the prefill's is
    recorded (``argmax_equal_by_step``), not gated here."""
    import torch
    from repro_torch.models import transformer as T
    dev = params["embed"].device
    B = tokens.shape[0]
    buf = (0 if prefix is None else prefix.shape[1]) + tokens.shape[-1] \
        + gen_len + 1
    has_pred = any("ffn" in layer for layer in params["layers"])
    errs, scales = {}, {}
    with (predictor_zeroed(params) if has_pred else contextlib.nullcontext()):
        cache = T.init_cache(cfg, B, buf, window=window, device=dev)
        logits, cache, _ = T.forward(cfg, params, tokens, prefix=prefix,
                                     cache=cache, mode="prefill",
                                     window=window)
        last, seq = logits[..., -1, :], tokens
        same = {}
        for step in range(1, gen_len + 1):
            nxt = torch.argmax(last, dim=-1)[..., None]
            seq = torch.cat([seq, nxt], dim=-1)
            logits, cache, _ = T.forward(cfg, params, nxt, cache=cache,
                                         mode="decode", window=window)
            last = logits[..., 0, :]
            if step in steps:
                c = T.init_cache(cfg, B, buf, window=window, device=dev)
                whole, _, _ = T.forward(cfg, params, seq, prefix=prefix,
                                        cache=c, mode="prefill",
                                        window=window)
                want = whole[..., -1, :]
                errs[step] = max_err(last, want)
                same[step] = bool(torch.equal(torch.argmax(last, dim=-1),
                                              torch.argmax(want, dim=-1)))
                scales[step] = max(1.0, float(want.abs().max()))
                del c, whole, want
        del cache
    worst = max(errs[s] / (RING_TOL * scales[s]) for s in errs)
    line = {"B": B, "prompt_len": tokens.shape[-1],
            "prefix_len": 0 if prefix is None else prefix.shape[1],
            "gen_len": gen_len, "steps_checked": list(errs),
            "max_abs_err_by_step": errs,
            "tol_by_step": {s: RING_TOL * scales[s] for s in errs},
            "max_abs_err": max(errs.values()), "tol_rel": RING_TOL,
            "worst_err_over_tol": worst, "argmax_equal_by_step": same,
            "predictor": "A zero (the reference's init)" if has_pred
            else "none (no FFN)"}
    require(worst <= 1.0, f"decode consistency: a decode step's logits "
            f"differ from the whole prompt's: {errs}")
    return line


def scan_cost(cfg, shapes) -> dict:
    """Device ms of one RG-LRU recurrence (``models/hybrid.rg_lru``: the
    gates' exp, softplus and sqrt and the Hillis-Steele scan) at each
    (B, S) of ``shapes``, on the card, and of the model's RG-LRU layers
    together: the scan's part of a prefill."""
    import torch
    from repro_torch.models import hybrid
    g = torch.Generator(device="cuda").manual_seed(7)
    n = sum(kind == "rglru" for kind in cfg.layer_kinds)
    out = {}
    for B, S in shapes:
        x, r, i = (torch.rand(B, S, cfg.lru_width, generator=g,
                              device="cuda") for _ in range(3))
        lam = torch.full((cfg.lru_width,), 0.7, device="cuda")
        prof = device_profile(lambda: hybrid.rg_lru(x, r, i, lam))
        ms = prof.get("device_ms")
        out[f"{B}x{S}"] = {"device_ms": ms,
                           "kernels_per_call": prof.get("kernels_per_call"),
                           "rglru_layers": n,
                           "model_device_ms": ms * n if isinstance(
                               ms, float) else ms}
        del x, r, i
    return out


def phase_hybrid_arch(B: int, P: int, gen_len: int) -> dict:
    """recurrentgemma-2b (HYBRID_ARCH): tiny through launch/serve and
    launch/server on cuda against cpu, every predictor A drawn; then at full
    width and HYBRID_ARCH's depth (random weights from a seed, every A
    drawn) full's serve
    traffic, the ring run through launch/serve (RING_RUN: prompts past the
    window) with its consistency against whole prompts, and server_full's
    server traffic (prefix cache cold, warm, off, and batched decode off:
    tokens equal), every kernel of each path launched (all attention at
    head dim 256); the card freed and the bank files removed afterwards.
    Returns each full path's launch counts, keyed "<arch>/serve",
    "<arch>/ring" and "<arch>/server"."""
    import gc
    import torch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import transformer as T
    arch, layers = HYBRID_ARCH
    t_arch = time.perf_counter()
    tiny = phase_tiny(arch, label=f"hybrid_arch {arch} tiny")
    server_tiny = phase_server_tiny(arch,
                                    label=f"hybrid_arch {arch} server_tiny")
    t0 = time.perf_counter()
    full, cfg, params = full_model(arch, layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    paths = {}
    rb, rp, rg = RING_RUN["B"], RING_RUN["P"], RING_RUN["gen_len"]
    tmp = tempfile.mkdtemp(prefix="m2cache_ssd_")
    try:
        paths[f"{arch}/serve"], serve = phase_full(
            full, cfg, params, B, P, gen_len,
            label=f"hybrid_arch {arch} serve", ssd_dir=tmp)
        paths[f"{arch}/ring"], ring = phase_full(
            full, cfg, params, rb, rp, rg, label=f"hybrid_arch {arch} ring",
            ssd_dir=tmp)
        t0 = time.perf_counter()
        sbuf = T.kv_slots(T.cache_specs(cfg, rb, rp + rg + 1))
        require(sbuf == cfg.window_size < rp,
                f"ring consistency: the buffer holds {sbuf} slots, not a "
                f"ring of the window {cfg.window_size} below the prompt {rp}")
        prompts = torch.as_tensor(make_prompts(cfg, rb, rp, 0), device="cuda")
        consistency = dict(decode_consistency(cfg, params, prompts, rg,
                                              range(1, rg + 1)),
                           ring_slots=sbuf, window=cfg.window_size)
        consistency["seconds"] = time.perf_counter() - t0
        log({"phase": f"hybrid_arch {arch} ring_consistency", **consistency})
        scan = scan_cost(cfg, [(B, P), (rb, rp)])
        paths[f"{arch}/server"], srv = phase_server_full(
            full, cfg, params, label=f"hybrid_arch {arch} server",
            ssd_dir=tmp, per_session=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log({"phase": "hybrid_arch", "config": arch,
         "depth": f"num_layers {full.num_layers} -> {cfg.num_layers}",
         "pattern": list(full.block_pattern), "window": full.window_size,
         "widths": serve["widths"], "param_gb": serve["param_gb"],
         "init_s": init_s, "ssd_bank_files_gb": serve["ssd_bank_files_gb"],
         "tiny_tokens_equal_cuda_cpu": tiny["tokens_equal"],
         "server_tiny_tokens_equal_cuda_cpu": all(
             server_tiny[k]["tokens_equal_cuda_cpu"]
             for k in ("shared_prefix", "burst")),
         "serve": serve_numbers(serve, paths[f"{arch}/serve"]),
         "rg_lru_scan": scan,
         "ring": dict(serve_numbers(ring, paths[f"{arch}/ring"]),
                      batch=rb, prompt_len=rp, gen_len=rg,
                      consistency_max_abs_err=consistency["max_abs_err"],
                      consistency_worst_err_over_tol=consistency[
                          "worst_err_over_tol"]),
         "server": server_numbers(srv, paths[f"{arch}/server"]),
         "seconds": time.perf_counter() - t_arch})
    return paths


# ---------------------------------------------------------------------------
# Phase 2, continued, and phases 13 and 14: the SSM and audio families


#: ssm_arch: mamba2-370m at full width, 6 of its 48 layers (so that the
#: script ends within its time on a slow host)
SSM_ARCH = ("mamba2-370m", 6)
#: the long run: 2 prompts of 2048 tokens (8 SSD chunks of 256: the state
#: crosses 7 chunk boundaries), 16 new tokens; its decode logits at
#: SSM_CHECK_STEPS held to a whole-prompt prefill's within RING_TOL
SSM_LONG = dict(B=2, P=2048, gen_len=16)
SSM_CHECK_STEPS = (1, 8, 16)
#: audio_arch: musicgen-large at full width and 12 of its 48 layers (so
#: that the script ends within its time on a slow host), through
#: forward: B rows of P codebook steps after the config's 64 conditioning
#: frames, gen_len greedy decode steps; decode logits at AUDIO_CHECK_STEPS
#: held to a whole-prompt prefill's within RING_TOL
AUDIO_ARCH = ("musicgen-large", 12)
AUDIO_RUN = dict(B=4, P=128, gen_len=16)
AUDIO_CHECK_STEPS = (1, 16)


def phase_kernels_audio(dev) -> dict:
    """The kernels at musicgen-large's shapes, which no other path gives:
    G = 1 (32 KV heads of 64, multi-head attention) in flash_decode at the
    decode step (4 rows over the 64 + 128 + 16 + 1-slot cache: a row of
    holes, a row with no valid slot, NaN/Inf in masked slots, a row alone
    against the row in the group, ranges 32 and 64) and in the whole
    prompt (q (4, 192, 32, 64): 64 conditioning frames and 128 codebook
    steps; scores to about +-60 against float64, paired and unpaired query
    tiles); one layer's FFN at d = 2048, f = 8192 with GELU (tiers
    614/614/1230) at the decode step (M = 4) and the prefill (M = 768)
    through kernels A and B. Each against its plain version, timed beside
    it, the library call (SDPA; matmul over pre-gathered weights) and the
    bounds."""
    import torch
    from repro_torch.configs.base import get_config
    g = torch.Generator(device=dev).manual_seed(2048)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    cfg = get_config(AUDIO_ARCH[0])
    hq, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = hq // hkv
    B, P, gen = AUDIO_RUN["B"], AUDIO_RUN["P"], AUDIO_RUN["gen_len"]
    N = cfg.num_prefix_embeddings
    S = N + P + gen + 1
    out, checks = {}, []
    check = checker(checks)
    out["flash_decode_g1"] = decode_row(
        check, randn, dev, "flash_decode_g1", S, hkv, G, D,
        [N + P + i for i in (0, 5, 10, gen - 1)][:B], holes=True,
        full_checks=True, sweep=(32, 64))
    out["flash_attention_g1"] = whole_prompt_row(check, randn, dev, B, N + P,
                                                 hq, hkv, D)
    rows = serve_ffn_rows(check, g, dev, cfg, B, N + P)[0]
    for name, row in rows.items():
        out[f"{name}_d{cfg.d_model}"] = dict(row, d=cfg.d_model, f=cfg.d_ff,
                                             act=cfg.ffn_act)
    for row in out.values():
        row["config"] = cfg.name
    torch.cuda.empty_cache()
    log({"phase": "kernels_audio", "checks": checks, "kernels": out})
    return out


def ssd_cost(cfg, params, shapes, prefill_device_ms) -> dict:
    """Device ms and kernels of one layer's SSD (``models/ssm.ssd_mix``:
    the split, dt's softplus, the causal conv, SiLU, the chunked scan with
    its padding, the D skip) at each (B, S) of ``shapes``, on the card, and
    of the model's layers together: its share of the prefill whose device
    ms ``prefill_device_ms`` gives at the same shape."""
    import torch
    from repro_torch.models import ssm
    g = torch.Generator(device="cuda").manual_seed(7)
    layer = params["layers"][0]
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    out = {}
    for (B, S), pre_ms in zip(shapes, prefill_device_ms):
        zx = torch.randn(B, S, 2 * di + 2 * n + nh, generator=g,
                         device="cuda")
        prof = device_profile(lambda: ssm.ssd_mix(cfg, layer, zx, None,
                                                  mode="prefill"))
        ms = prof.get("device_ms")
        model_ms = ms * cfg.num_layers if isinstance(ms, float) else ms
        out[f"{B}x{S}"] = {
            "device_ms": ms, "kernels_per_call": prof.get("kernels_per_call"),
            "top_kernels_ms": prof.get("top_kernels_ms"),
            "chunks": math.ceil(S / cfg.ssm_chunk), "layers": cfg.num_layers,
            "model_device_ms": model_ms, "prefill_device_ms": pre_ms,
            "share_of_prefill": model_ms / pre_ms if isinstance(
                model_ms, float) and isinstance(pre_ms, float) else
            "not measured"}
        del zx
    return out


def serve_numbers(run, launches) -> dict:
    """A phase_full line's step numbers."""
    return {"prefill_wall_ms": run["prefill_wall_s"] * 1e3,
            "decode_step_wall_ms_median": run["decode_wall_s_median"] * 1e3,
            "prefill_device_ms": run["profile"]["prefill"].get("device_ms"),
            "prefill_busy_share":
                run["profile"]["prefill"].get("busy_share"),
            "prefill_top_kernels_ms":
                run["profile"]["prefill"].get("top_kernels_ms"),
            "decode_step_device_ms":
                run["profile"]["decode_step"].get("device_ms"),
            "decode_step_busy_share":
                run["profile"]["decode_step"].get("busy_share"),
            "decode_forward_kernels": run["decode_forward"]["cuda_kernels"],
            "peak_mem_gb": run["peak_mem_gb"], "launches": launches}


def server_numbers(srv, launches) -> dict:
    """A phase_server_full line's step numbers."""
    dev_srv = srv["device_in_steps_warm"]
    return {
        "tokens_equal_cold_warm_off": srv["tokens_equal_cold_warm_off"],
        "tokens_equal_batched_vs_per_session":
            srv["tokens_equal_batched_vs_per_session"],
        "decode_step_wall_ms_median":
            srv["steps_cold"]["decode_step_wall_ms_median"],
        "decode_forward_wall_ms_median":
            srv["steps_cold"]["decode_forward_wall_ms_median"],
        "prefill_chunk_wall_ms_median":
            srv["steps_cold"]["prefill_chunk_wall_ms_median"],
        "decode_step_device_ms": dev_srv.get("decode_step", {}).get(
            "device_ms_per_step", "not measured"),
        "decode_step_busy_share": dev_srv.get("decode_step", {}).get(
            "busy_share", "not measured"),
        "prefill_step_device_ms": dev_srv.get("prefill_step", {}).get(
            "device_ms_per_step", "not measured"),
        "decode_forward_kernels": srv["decode_forward"]["cuda_kernels"],
        "peak_mem_gb": srv["peak_mem_gb"], "launches": launches}


def phase_ssm_arch(B: int, P: int, gen_len: int) -> dict:
    """mamba2-370m (SSM_ARCH): tiny through launch/serve and launch/server
    on cuda against cpu; then at full width and SSM_ARCH's depth (random
    weights from a seed, every SSD layer's A and dt drawn) full's serve
    traffic, the long run through launch/serve (SSM_LONG: 8 SSD chunks a
    prompt) with its decode held to whole-prompt prefills, the SSD's device
    cost at both prefill shapes, and server_full's server traffic (prefix
    cache cold, warm, off, batched decode off: tokens equal; whole-prompt
    prefill, stacked in rows); no kernel launched on any path (the SSD is
    plain PyTorch, as the reference's is plain jnp). Returns each full
    path's launch counts, keyed "<arch>/serve", "<arch>/long" and
    "<arch>/server"."""
    import gc
    import torch
    from repro_torch.launch.serve import make_prompts
    arch, layers = SSM_ARCH
    t_arch = time.perf_counter()
    tiny = phase_tiny(arch, label=f"ssm_arch {arch} tiny")
    server_tiny = phase_server_tiny(arch, label=f"ssm_arch {arch} server_tiny")
    t0 = time.perf_counter()
    full, cfg, params = full_model(arch, layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    paths = {}
    lb, lp, lg = SSM_LONG["B"], SSM_LONG["P"], SSM_LONG["gen_len"]
    tmp = tempfile.mkdtemp(prefix="m2cache_ssd_")
    try:
        paths[f"{arch}/serve"], serve = phase_full(
            full, cfg, params, B, P, gen_len, label=f"ssm_arch {arch} serve",
            ssd_dir=tmp)
        paths[f"{arch}/long"], long_run = phase_full(
            full, cfg, params, lb, lp, lg, label=f"ssm_arch {arch} long",
            ssd_dir=tmp)
        t0 = time.perf_counter()
        prompts = torch.as_tensor(make_prompts(cfg, lb, lp, 0), device="cuda")
        consistency = decode_consistency(cfg, params, prompts, lg,
                                         SSM_CHECK_STEPS)
        consistency["seconds"] = time.perf_counter() - t0
        log({"phase": f"ssm_arch {arch} long_consistency", **consistency})
        ssd = ssd_cost(cfg, params, [(B, P), (lb, lp)],
                       [r["profile"]["prefill"].get("device_ms")
                        for r in (serve, long_run)])
        paths[f"{arch}/server"], srv = phase_server_full(
            full, cfg, params, label=f"ssm_arch {arch} server", ssd_dir=tmp,
            per_session=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log({"phase": "ssm_arch", "config": arch,
         "depth": f"num_layers {full.num_layers} -> {cfg.num_layers}",
         "widths": {"d_model": cfg.d_model, "d_inner": cfg.d_inner,
                    "heads": cfg.ssm_nheads, "head_dim": cfg.ssm_head_dim,
                    "state": cfg.ssm_state, "chunk": cfg.ssm_chunk,
                    "conv": cfg.ssm_conv_width, "vocab": cfg.vocab_size},
         "param_gb": serve["param_gb"], "init_s": init_s,
         "ssd_bank_files_gb": serve["ssd_bank_files_gb"],
         "tiny_tokens_equal_cuda_cpu": tiny["tokens_equal"],
         "server_tiny_tokens_equal_cuda_cpu": all(
             server_tiny[k]["tokens_equal_cuda_cpu"]
             for k in ("shared_prefix", "burst")),
         "serve": serve_numbers(serve, paths[f"{arch}/serve"]),
         "long": dict(serve_numbers(long_run, paths[f"{arch}/long"]),
                      batch=lb, prompt_len=lp, gen_len=lg,
                      consistency_max_abs_err=consistency["max_abs_err"],
                      consistency_worst_err_over_tol=consistency[
                          "worst_err_over_tol"]),
         "ssd_cost": ssd,
         "server": server_numbers(srv, paths[f"{arch}/server"]),
         "seconds": time.perf_counter() - t_arch})
    return paths


def audio_inputs(cfg, B: int, P: int, device, seed: int = 0):
    """B rows of P codebook steps (B, K, P) and the config's conditioning
    frames (B, N, d), from a seeded CPU generator."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, cfg.vocab_size, (B, cfg.num_codebooks, P),
                          generator=gen)
    frames = torch.randn(B, cfg.num_prefix_embeddings, cfg.d_model,
                         generator=gen)
    return codes.to(device), frames.to(device)


def audio_generate(cfg, params, codes, frames, gen_len: int, label: str,
                   counted: bool = False):
    """A prefill of ``codes`` after ``frames``, then gen_len greedy decode
    steps (one code a codebook), through ``forward``. Returns (the greedy
    codes (B, K, gen_len), the active sets of every call, the last logits,
    per-call wall s, the launch counts summed). With ``counted``, the
    prefill must launch flash_attention and qmatmul kernel B only, and each
    decode step flash_decode and qmatmul kernel A only."""
    import torch
    from repro_torch.models import transformer as T
    dev = params["embed"].device
    B = codes.shape[0]
    buf = frames.shape[1] + codes.shape[-1] + gen_len + 1
    cache = T.init_cache(cfg, B, buf, device=dev)
    total, walls, ids = {}, [], []

    def call(tok, mode, prefix):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits, _, aux = T.forward(cfg, params, tok, prefix=prefix,
                                   cache=cache, mode=mode)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        if counted:
            require_path_kernels(f"{label} {mode}", f"forward_{mode}",
                                 counts)
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        ids.append([a.cpu() for a in aux["active_idx"]["pattern"]])
        return logits
    logits = call(codes, "prefill", frames)
    last, out = logits[..., -1, :], []
    for _ in range(gen_len):
        nxt = torch.argmax(last, dim=-1)[..., None]
        out.append(nxt)
        last = call(nxt, "decode", None)[..., 0, :]
    del cache
    return torch.cat(out, -1).cpu(), ids, last, walls, total


def phase_audio_tiny(label: str) -> dict:
    """musicgen-large tiny through forward on cuda against cpu, from the
    same weights (every predictor A drawn): a prefill of 12 codebook steps
    after the conditioning frames, then 6 greedy decode steps; greedy codes
    and active sets equal, last logits within 1e-4, the path's kernels
    launched on the card."""
    import torch
    from repro_torch.models import transformer as T
    cfg = tiny_config(AUDIO_ARCH[0])
    params = T.init_params(cfg, seed=0, device="cpu")
    draw_pred_a(params, torch.Generator().manual_seed(1), "cpu")
    runs = {}
    for device, p in (("cuda", _tree_to(params, "cuda")), ("cpu", params)):
        codes, frames = audio_inputs(cfg, 2, 12, device)
        runs[device] = audio_generate(cfg, p, codes, frames, 6, label,
                                      counted=device == "cuda")
    (tg, ig, lg, _, cg), (tc, ic, lc, _, _) = runs["cuda"], runs["cpu"]
    err = max_err(lg.cpu(), lc)
    line = {"phase": label, "config": cfg.name,
            "tokens_equal": bool(torch.equal(tg, tc)),
            "active_sets_equal": all(torch.equal(a, b) for x, y in zip(ig, ic)
                                     for a, b in zip(x, y)),
            "last_logits_max_abs_err": err, "tol_abs_rel": 1e-4,
            "launches_cuda": cg}
    log(line)
    require(line["tokens_equal"], f"{label}: cuda and cpu codes differ")
    require(line["active_sets_equal"], f"{label}: active sets differ")
    require(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4),
            f"{label}: last logits differ by {err:.3g}")
    return line


def phase_audio_arch() -> dict:
    """musicgen-large (AUDIO_ARCH) through ``forward``, as the reference's
    tests drive it (neither package's entry points serve it): tiny on cuda
    against cpu; at full width and AUDIO_ARCH's depth (random weights from
    a seed, every predictor A drawn) a prefill of AUDIO_RUN's codebook steps
    after 64 conditioning frames and 16 greedy decode steps, each call's
    kernels held to its form of the path, twice (the same codes); the
    prefill's and a decode step's device time and busy share; decode
    logits held to whole-prompt prefills (decode_consistency). Returns the
    path's launch counts, keyed "<arch>/forward"."""
    import gc
    import torch
    from repro_torch.models import transformer as T
    arch, layers = AUDIO_ARCH
    t_arch = time.perf_counter()
    tiny = phase_audio_tiny(f"audio_arch {arch} tiny")
    t0 = time.perf_counter()
    full, cfg, params = full_model(arch, layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = sum(t.numel() * t.element_size()
                   for t in _leaves(params)) / 1e9
    B, P, gen = AUDIO_RUN["B"], AUDIO_RUN["P"], AUDIO_RUN["gen_len"]
    codes, frames = audio_inputs(cfg, B, P, "cuda")
    torch.cuda.reset_peak_memory_stats()
    toks, ids, last, walls, counts = audio_generate(
        cfg, params, codes, frames, gen, f"audio_arch {arch}", counted=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks2, ids2, _, _, _ = audio_generate(cfg, params, codes, frames, gen,
                                          f"audio_arch {arch}")
    same = bool(torch.equal(toks, toks2)) and all(
        torch.equal(a, b) for x, y in zip(ids, ids2) for a, b in zip(x, y))
    finite = bool(torch.isfinite(last).all())
    buf = frames.shape[1] + P + gen + 1
    state = {}

    def prefill():
        state["cache"] = T.init_cache(cfg, B, buf, device="cuda")
        logits, _, _ = T.forward(cfg, params, codes, prefix=frames,
                                 cache=state["cache"], mode="prefill")
        state["last"] = logits[..., -1, :]

    def decode():
        if state["cache"]["pos"] >= buf - 1:
            prefill()
        nxt = torch.argmax(state["last"], dim=-1)[..., None]
        logits, _, _ = T.forward(cfg, params, nxt, cache=state["cache"],
                                 mode="decode")
        state["last"] = logits[..., 0, :]
    profile = {"prefill": device_profile(prefill, reps=2)}
    prefill()
    profile["decode_step"] = device_profile(decode, reps=5)
    state.clear()
    cost = decode_forward_cost(cfg, params, [frames.shape[1] + P + gen // 2]
                               * B, buf, rows=False)
    t0 = time.perf_counter()
    consistency = decode_consistency(cfg, params, codes, gen,
                                     AUDIO_CHECK_STEPS, prefix=frames)
    consistency["seconds"] = time.perf_counter() - t0
    log({"phase": f"audio_arch {arch} consistency", **consistency})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pre, dec = profile["prefill"], profile["decode_step"]
    line = {"phase": "audio_arch", "config": arch,
            "depth": f"num_layers {full.num_layers} -> {cfg.num_layers}",
            "widths": {"d_model": cfg.d_model, "heads": cfg.num_heads,
                       "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                       "codebooks": cfg.num_codebooks,
                       "conditioning_frames": cfg.num_prefix_embeddings},
            "pred_A": "drawn N(0, 1/d) on the device generator for this run "
                      "(the reference's init zeroes it)",
            "param_gb": param_gb, "init_s": init_s, "batch": B,
            "codebook_steps": P, "gen_len": gen, "peak_mem_gb": peak_gb,
            "tiny_tokens_equal_cuda_cpu": tiny["tokens_equal"],
            "prefill_wall_ms": walls[0] * 1e3,
            "decode_step_wall_ms_median": statistics.median(walls[1:]) * 1e3,
            "prefill_device_ms": pre.get("device_ms"),
            "prefill_busy_share": pre.get("busy_share"),
            "prefill_top_kernels_ms": pre.get("top_kernels_ms"),
            "decode_step_device_ms": dec.get("device_ms"),
            "decode_step_busy_share": dec.get("busy_share"),
            "decode_step_top_kernels_ms": dec.get("top_kernels_ms"),
            "decode_forward": cost, "launches": counts,
            "finite_logits": finite, "second_run_equal": same,
            "consistency_max_abs_err": consistency["max_abs_err"],
            "consistency_worst_err_over_tol":
                consistency["worst_err_over_tol"],
            "codes": toks.tolist(),
            "seconds": time.perf_counter() - t_arch}
    log(line)
    require(finite, "audio_arch: non-finite logits")
    require(same, "audio_arch: a second run gave other codes or sets")
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            "audio_arch: a code outside the codebook")
    require_path_kernels("audio_arch", "forward", counts)
    return {f"{arch}/forward": counts}


# ---------------------------------------------------------------------------
# Phases 15-17: the offline half of M2Cache and the trainer

#: ratio searches: Algorithm 1's settings (examples/ratio_search_demo.py at
#: tiny; two 64-token prompts and 12 steps at full width)
SEARCH_TINY = dict(B=2, P=8, memory_budget=0.25, gen_len=6)
SEARCH_FULL = dict(B=2, P=64, memory_budget=0.25, gen_len=12)
#: predictor training (benchmarks/tab14_accuracy.py's recipe; 1024 probes
#: at full width)
PREDICTOR = dict(steps=150, lr=3e-2)
#: the train_full phase: qwen2.5-14b at full width, dense FFN
TRAIN_FULL = dict(layers=4, batch=2, seq=256, steps=8, lr=3e-4, warmup=2)
#: cuda against cpu: a search's uq, a predictor's A/B/loss (relative to
#: their largest magnitude) after 150 momentum steps, and a training run's
#: loss at every one of 20 AdamW steps. Sound runs on an H100 differed by
#: at most 1.1e-7, 5.6e-7 and 1.6e-7 (fp32 sums in another order); the same
#: runs with TF32 products allowed (a control: 10-bit mantissas in every
#: cuBLAS product) by 2.0e-3, 3.7e-4 and 1.2e-5, and must exceed the
#: tolerance again
UQ_TOL = 1e-5
PREDICTOR_TOL = 1e-5
TRAIN_LOSS_TOL = 2e-6
#: remat on against off at full width: gradients within this of each
#: leaf's largest magnitude (the embedding's backward adds with atomics,
#: in no fixed order)
REMAT_TOL = 1e-5


def counted_search(cfg, params, prompts, **kw):
    """``ratio_search.search`` with every candidate's launches and wall
    seconds recorded: (result, [per-candidate {"ratio", "launches",
    "wall_s", "tiers"}], the launches summed)."""
    import torch
    from repro_torch.core import mp_ffn, ratio_search as R
    per, total = [], {}
    plain = R.uq_est

    def uq_est(cand, *a, **k):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        uq = plain(cand, *a, **k)
        torch.cuda.synchronize()
        counts = read_counts()
        per.append({"ratio": (cand.m2_ratio_fp16, cand.m2_ratio_int8,
                              cand.m2_ratio_int4),
                    "wall_s": time.perf_counter() - t0, "launches": counts,
                    "tiers": mp_ffn.tier_sizes(cand.d_ff, cand)})
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        return uq
    R.uq_est = uq_est
    try:
        res = R.search(cfg, params, prompts, **kw)
    finally:
        R.uq_est = plain
    return res, per, total


@contextlib.contextmanager
def held_to_plain(label: str, held: dict, tol_rel: float = 1e-5):
    """Inside the block every kernel call that ``kernels.ops`` makes returns
    its kernel's result after holding it against the plain version on the
    same inputs, within tol_rel x max(1, max|plain|): each ``qmatmul``
    product (of ``ops.mp_ffn``: gate, up and down a tier; at bf16 and small
    M the fused GLU's gate and up products, with its h bit-equal to the
    PyTorch composition over them, and the down products' bf16 sum),
    ``flash_decode``
    and both attention forms (``flash_attention``, ``chunk_kernel``), the
    attention forms against the plain version's fp32 result; a whole prompt
    longer than 2 x SLICE tokens on its first and last SLICE queries
    against float64 (``attention_f64``: the plain version would build Hq x
    S^2 fp32 scores, 12 GB at 8704 tokens). An output in bf16 is rounded
    once from the kernel's fp32 sums, so it may differ by half a bf16 unit
    of the result more (at most 2^-8 of it: bf16 keeps 8 significant
    bits). ``held`` gathers, by kernel and then by shape (an FFN's products
    by its M and tier split), the calls held, the largest error and the
    largest error over its tolerance. The plain versions launch no kernel:
    the counts stay the path's own."""
    import torch
    from repro_torch.kernels import ops, qmatmul, ref
    names = ("mp_ffn", "qmatmul_gathered", "glu_bf16", "ffn_down_bf16",
             "flash_attention", "chunk_kernel", "flash_decode")
    saved = {n: getattr(ops, n) for n in names}
    split = []

    def hold(kernel, key, got, want, calls=1):
        want = want.float()
        diff = (got.float() - want).abs()
        if got.dtype == torch.bfloat16:
            diff = diff - want.abs() * 2.0 ** -8
        err = max(float(diff.max()), 0.0)
        tol = tol_rel * max(1.0, float(want.abs().max()))
        require(bool(torch.isfinite(got).all()) and err <= tol,
                f"{label}: {kernel} {key}: max|d|={err:.3g} > tol {tol:.3g}")
        e = held.setdefault(kernel, {}).setdefault(
            key, {"calls": 0, "max_abs_err": 0.0, "worst_err_over_tol": 0.0})
        e["calls"] += calls
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["worst_err_over_tol"] = max(e["worst_err_over_tol"], err / tol)
        return got

    def mp_ffn(x, banks, idx, sizes, act_name):
        split.append(f"tiers={sizes['fp16']}/{sizes['int8']}/{sizes['int4']}")
        try:
            return saved["mp_ffn"](x, banks, idx, sizes, act_name)
        finally:
            split.pop()

    def qmatmul_gathered(x, w, scale=None, idx=None, *, precision="fp",
                         layout="col", out=None):
        n0 = qmatmul.launches_mma
        before = None if out is None else out.clone()
        got = saved["qmatmul_gathered"](x, w, scale, idx, precision=precision,
                                        layout=layout, out=out)
        kernel = "qmatmul_mma" if qmatmul.launches_mma > n0 else \
            "qmatmul_gemv"
        key = (f"M={x.shape[-2]} {split[-1]}" if split
               else f"x={tuple(x.shape)} {precision} {layout}")
        return hold(kernel, key, got, ref.qmm_gathered_ref(
            x, w, scale, idx, precision=precision, layout=layout, out=before))

    def glu_bf16(x, tiers, *, act="silu", products=False):
        outs = saved["glu_bf16"](x, tiers, act=act, products=True)
        key = (f"M={x.shape[-2]} {split[-1]}" if split
               else f"x={tuple(x.shape)} {[t[0] for t in tiers]}")
        for i, ((h, gate, up), (precision, wg, wu, sg, su, idx)) in \
                enumerate(zip(outs, tiers)):
            hold("qmm_glu", key, gate, ref.qmm_gathered_ref(
                x, wg, sg, idx, precision=precision), calls=0)
            hold("qmm_glu", key, up, ref.qmm_gathered_ref(
                x, wu, su, idx, precision=precision), calls=int(i == 0))
            want = ref.glu_bf16_ref(gate, up, act)
            differ = int((h.view(torch.int16) != want.view(torch.int16)).sum())
            require(differ == 0, f"{label}: qmm_glu {key} {precision} {act}: "
                                 f"h differs from the PyTorch composition "
                                 f"over its products at {differ} of "
                                 f"{h.numel()} values")
        return outs if products else [o[0] for o in outs]

    def ffn_down_bf16(terms):
        got = saved["ffn_down_bf16"](terms)
        key = (f"M={terms[0][0].shape[-2]} {split[-1]} down" if split
               else f"h={tuple(terms[0][0].shape)} down")
        want = 0.0                     # the plain sum before its rounding
        for h, w, scale, idx, precision in terms:
            want = want + ref.qmm_gathered_ref(h, w, scale, idx,
                                               precision=precision,
                                               layout="row")
        return hold("qmatmul_gemv", key, got, want, calls=len(terms))

    def flash_attention(q, k, v, *, window=0, softcap=0.0):
        got = saved["flash_attention"](q, k, v, window=window,
                                       softcap=softcap)
        key = f"q={tuple(q.shape)} kv={tuple(k.shape)} window={window}"
        S = q.shape[1]
        if S <= 2 * SLICE:
            return hold("flash_attention", key, got, ref.flash_attention_ref(
                q.float(), k.float(), v.float(), window=window,
                softcap=softcap))
        for lo in (0, S - SLICE):
            hi = lo + SLICE
            hold("flash_attention", f"{key} queries {lo}..{hi} vs float64",
                 got[:, lo:hi], attention_f64(
                     q[:, lo:hi], k[:, :hi], v[:, :hi],
                     torch.full((q.shape[0],), lo, device=q.device),
                     softcap=softcap, window=window))
        return got

    def chunk_kernel(q, k, v, pos0, *, softcap=0.0):
        return hold("chunk_attention", f"q={tuple(q.shape)} kv="
                    f"{tuple(k.shape)}", saved["chunk_kernel"](
                        q, k, v, pos0, softcap=softcap),
                    ref.chunk_attention_ref(q.float(), k.float(), v.float(),
                                            pos0, softcap=softcap))

    def flash_decode(q, k, v, slots, lengths, *, softcap=0.0):
        got = saved["flash_decode"](q, k, v, slots, lengths, softcap=softcap)
        return hold("flash_decode", f"q={tuple(q.shape)} "
                    f"kv={tuple(k.shape)}", got, ref.flash_decode_ref(
                        q, k, v, slots, lengths, softcap=softcap))
    for n, fn in (("mp_ffn", mp_ffn), ("qmatmul_gathered", qmatmul_gathered),
                  ("glu_bf16", glu_bf16), ("ffn_down_bf16", ffn_down_bf16),
                  ("flash_attention", flash_attention),
                  ("chunk_kernel", chunk_kernel),
                  ("flash_decode", flash_decode)):
        setattr(ops, n, fn)
    try:
        yield held
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def require_search_launches(label: str, cfg, per, gen_len: int):
    """Each searched candidate's launches: qmatmul 3 (gate, up, down) x its
    non-empty tiers x layers, kernel B at the prefill and kernel A at each
    of the gen_len decode forwards; flash_attention once a layer,
    flash_decode once a layer a decode forward; no other kernel."""
    L = cfg.num_layers
    for c in per:
        tiers = sum(1 for t in ("fp16", "int8", "int4") if c["tiers"][t])
        n = c["launches"]
        want = {"qmatmul_mma": 3 * tiers * L,
                "qmatmul_gemv": 3 * tiers * L * gen_len,
                "flash_attention": L, "flash_decode": L * gen_len}
        want["qmatmul"] = want["qmatmul_mma"] + want["qmatmul_gemv"]
        got = {k: n[k] for k in want}
        require(got == want, f"{label}: candidate {c['ratio']} launched "
                             f"{got}, its tiers need {want}")
        require_path_kernels(label, "ratio_search", n)


def search_prompts(cfg, B: int, P: int, device):
    import torch
    gen = torch.Generator().manual_seed(0)
    return torch.randint(0, cfg.vocab_size, (B, P), generator=gen).to(device)


def table_of(res) -> list:
    return [{"ratio": r["ratio"], "mem_cost": r["mem_cost"],
             "feasible": r["feasible"], "uq": r["uq"]} for r in res.table]


def ppl(cfg, params, eval_batches, m2: bool) -> float:
    """benchmarks/tab14_accuracy.py's perplexity: train-mode logits, the
    next-token NLL over every position, exp of its mean."""
    import torch
    from repro_torch.models import transformer as T
    tot, cnt = 0.0, 0
    dev = params["embed"].device
    with torch.no_grad():
        for b in eval_batches:
            tokens = torch.as_tensor(b["tokens"], device=dev)
            logits, _, _ = T.forward(cfg, params, tokens, mode="train", m2=m2)
            logp = torch.log_softmax(logits[:, :-1].float(), -1)
            nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
            tot += float(nll.sum())
            cnt += nll.numel()
    return math.exp(tot / cnt)


def m2_params_from_dense(cfg, params, seed: int = 1):
    """benchmarks/tab14_accuracy.py's ``_m2_params_from_dense``: every dense
    FFN to M2Cache banks (neuron-major, as the port's params hold them)
    and a predictor fitted to 128 random probes from ``init_predictor``'s
    draws (PREDICTOR). The reference keeps this in a benchmark, not in its
    package, and so does the port."""
    import torch
    from repro_torch.core.predictor import init_predictor, train_predictor
    from repro_torch.core.quantize import build_neuron_banks, to_neuron_major
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = dict(params, layers=[])
    for layer in params["layers"]:
        ffn = layer.get("ffn", {})
        if "wg" not in ffn:
            out["layers"].append(layer)
            continue
        xs = torch.randn((128, cfg.d_model), generator=gen, device=dev)
        A0, B0 = init_predictor(cfg.d_model, ffn["wg"].shape[-1],
                                cfg.m2_predictor_rank, generator=gen)
        A, B, _ = train_predictor(xs, ffn["wg"], ffn["wu"],
                                  act_name=cfg.ffn_act, A0=A0, B0=B0,
                                  **PREDICTOR)
        with torch.no_grad():
            banks = to_neuron_major(build_neuron_banks(ffn["wg"], ffn["wu"],
                                                       ffn["wd"]))
        out["layers"].append(dict(layer, ffn={"banks": banks,
                                              "pred": {"A": A, "B": B}}))
    return out


def tiny_training(cfg, device: str, steps: int) -> list:
    """The port's trainer as launch/train runs it (the CLI's AdamW config,
    batch 8, 128 tokens), every step logged: the losses."""
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    opt = AdamWConfig(lr=3e-4, total_steps=steps,
                      warmup_steps=max(steps // 10, 1))
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        _, _, hist = train(cfg, steps=steps, batch_size=8, seq_len=128,
                           opt_cfg=opt, seed=0, log_every=1, device=device)
    return [h["loss"] for h in hist]


@contextlib.contextmanager
def tf32_allowed():
    """cuBLAS products in TF32 inside the block (the script's control for
    its cuda-vs-cpu tolerances); fp32 again after it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def offline_gaps(cfg, params, cpu: dict, search) -> dict:
    """The offline_tiny runs on the card against the CPU's (``cpu``: its
    "search", "fit" and "losses"): the search through ``search`` (as
    ``ratio_search.search``), train_predictor on layer 0 from ``cpu``'s
    "xs", "A0", "B0", and 20 trainer steps. Returns the card's runs and
    the gaps: uq's largest relative gap over the feasible candidates, the
    predictor's A/B/loss relative to their largest magnitude, the loss's
    largest relative gap over the steps."""
    from repro_torch.core.predictor import train_predictor
    kw = {k: SEARCH_TINY[k] for k in ("memory_budget", "gen_len")}
    res = search(cfg, _tree_to(params, "cuda"), search_prompts(
        cfg, SEARCH_TINY["B"], SEARCH_TINY["P"], "cuda"), **kw)
    banks = params["layers"][0]["ffn"]["banks"]
    fit = train_predictor(
        cpu["xs"].cuda(), banks["wg_fp"].T.cuda(), banks["wu_fp"].T.cuda(),
        act_name=cfg.ffn_act, A0=cpu["A0"].cuda(), B0=cpu["B0"].cuda(),
        **PREDICTOR)
    losses = tiny_training(cfg, "cuda", 20)
    return {"search": res, "fit": fit, "losses": losses,
            "feasible_equal": [a["feasible"] for a in res.table]
            == [b["feasible"] for b in cpu["search"].table],
            "uq": max(abs(a["uq"] - b["uq"]) / abs(b["uq"])
                      for a, b in zip(res.table, cpu["search"].table)
                      if b["feasible"]),
            "predictor": {n: max_err(g.cpu(), c) / float(c.abs().max())
                          for n, g, c in zip(("A", "B", "loss"), fit,
                                             cpu["fit"])},
            "loss": max(abs(g - c) / c
                        for g, c in zip(losses, cpu["losses"]))}


def phase_offline_tiny() -> dict:
    """qwen2.5-14b tiny, the same weights on cuda and cpu (predictor A
    drawn): Algorithm 1's search as examples/ratio_search_demo.py calls it
    (feasibility and best ratio equal, uq within UQ_TOL, each candidate's
    launches by its non-empty tiers); train_predictor on layer 0 (A, B and
    the loss within PREDICTOR_TOL); launch/train's trainer for 20 steps
    (the loss at every step within TRAIN_LOSS_TOL, falling); the same
    three runs on the card with TF32 products, each of which must exceed
    its tolerance (the control); launch/train's CLI once on the card with
    a checkpoint; the Tab. 14 proxy on the card
    (train 60 steps; perplexity dense, M2Cache mixed, uniform int4:
    printed, not gated)."""
    import torch
    from repro_torch.core import ratio_search as R
    from repro_torch.core.predictor import init_predictor, train_predictor
    from repro_torch.data.pipeline import batches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    t_phase = time.perf_counter()
    cfg = tiny_config("qwen2.5-14b")
    params = T.init_params(cfg, seed=0, device="cpu")
    draw_pred_a(params, torch.Generator().manual_seed(1), "cpu")
    kw = {k: SEARCH_TINY[k] for k in ("memory_budget", "gen_len")}
    # the CPU's runs: the search, the predictor on layer 0's FFN, the trainer
    gen = torch.Generator().manual_seed(2)
    xs = torch.randn((128, cfg.d_model), generator=gen)
    A0, B0 = init_predictor(cfg.d_model, cfg.d_ff, cfg.m2_predictor_rank,
                            generator=gen)
    banks = params["layers"][0]["ffn"]["banks"]
    cpu = {"xs": xs, "A0": A0, "B0": B0,
           "search": R.search(cfg, params, search_prompts(
               cfg, SEARCH_TINY["B"], SEARCH_TINY["P"], "cpu"), **kw),
           "fit": train_predictor(xs, banks["wg_fp"].T, banks["wu_fp"].T,
                                  act_name=cfg.ffn_act, A0=A0, B0=B0,
                                  **PREDICTOR),
           "losses": tiny_training(cfg, "cpu", 20)}
    counted = {}

    def search(*a, **k):
        res, counted["per"], counted["total"] = counted_search(*a, **k)
        return res
    card = offline_gaps(cfg, params, cpu, search)
    per, total = counted["per"], counted["total"]
    # the control: the same runs with TF32 products must exceed each gap's
    # tolerance, or the tolerances could not tell TF32 from fp32
    with tf32_allowed():
        tf32 = offline_gaps(cfg, params, cpu, R.search)
    res_g, res_c = card["search"], cpu["search"]
    uq_err, pred_err, loss_err = card["uq"], card["predictor"], card["loss"]
    losses = {"cuda": card["losses"], "cpu": cpu["losses"]}
    tmp = tempfile.mkdtemp(prefix="m2cache_train_")
    try:
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            hist = launch_train.main(["--arch", "qwen2.5-14b", "--tiny",
                                      "--steps", "20", "--device", "cuda",
                                      "--save", os.path.join(tmp, "ck")])
        ckpt_files = sorted(os.listdir(os.path.join(tmp, "ck")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # Tab. 14's proxy on the card
    steps = 60
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        dense, _, _ = train(cfg, steps=steps, batch_size=4, seq_len=64,
                            opt_cfg=AdamWConfig(lr=3e-3, total_steps=steps,
                                                warmup_steps=5),
                            log_every=10 ** 9, device="cuda")
    ev = list(batches(cfg, batch_size=4, seq_len=64, seed=99, num_batches=3))
    reset_counts()
    ppl_dense = ppl(cfg, dense, ev, m2=False)
    dense_counts = read_counts()
    m2p = m2_params_from_dense(cfg, dense)
    reset_counts()
    ppl_mixed = ppl(cfg, m2p, ev, m2=True)
    mixed_counts = read_counts()
    cfg_i4 = dataclasses.replace(cfg, m2_ratio_fp16=0.0, m2_ratio_int8=0.0,
                                 m2_ratio_int4=1.0)
    ppl_i4 = ppl(cfg_i4, m2p, ev, m2=True)

    line = {"phase": "offline_tiny", "config": cfg.name,
            "search": {**SEARCH_TINY, "cuda": table_of(res_g),
                       "best_cuda": res_g.best_ratio,
                       "best_cpu": res_c.best_ratio,
                       "feasible_equal": card["feasible_equal"],
                       "uq_max_rel_err": uq_err, "tol": UQ_TOL,
                       "uq_max_rel_err_tf32": tf32["uq"],
                       "candidates": per, "launches": total},
            "train_predictor": {**PREDICTOR, "probes": 128,
                                "loss_cuda": float(card["fit"][2]),
                                "loss_cpu": float(cpu["fit"][2]),
                                "max_rel_err": pred_err,
                                "tol": PREDICTOR_TOL,
                                "max_rel_err_tf32": tf32["predictor"]},
            "trainer": {"steps": 20, "loss_cuda": losses["cuda"],
                        "loss_cpu": losses["cpu"],
                        "loss_max_rel_err": loss_err, "tol": TRAIN_LOSS_TOL,
                        "loss_max_rel_err_tf32": tf32["loss"],
                        "cli_history_steps": [h["step"] for h in hist],
                        "cli_final_loss": hist[-1]["loss"],
                        "checkpoint_files": ckpt_files},
            "tab14_proxy": {"train_steps": steps, "ppl_dense": ppl_dense,
                            "ppl_m2cache_mixed": ppl_mixed,
                            "ppl_uniform_int4": ppl_i4,
                            "mixed_better": ppl_mixed <= ppl_i4,
                            "launches_dense": dense_counts,
                            "launches_mixed": mixed_counts},
            "seconds": time.perf_counter() - t_phase}
    log(line)
    require(card["feasible_equal"],
            "offline_tiny: feasibility differs cuda vs cpu")
    require(uq_err <= UQ_TOL, f"offline_tiny: uq differs by {uq_err:.3g}")
    require(res_g.best_ratio == res_c.best_ratio,
            "offline_tiny: the best ratio differs cuda vs cpu")
    require_search_launches("offline_tiny", cfg, per, kw["gen_len"])
    require(all(e <= PREDICTOR_TOL for e in pred_err.values()),
            f"offline_tiny: train_predictor differs {pred_err}")
    require(loss_err <= TRAIN_LOSS_TOL,
            f"offline_tiny: training losses differ by {loss_err:.3g}")
    require(tf32["uq"] > UQ_TOL
            and max(tf32["predictor"].values()) > PREDICTOR_TOL
            and tf32["loss"] > TRAIN_LOSS_TOL,
            f"offline_tiny: a TF32 control passed its fp32 tolerance "
            f"(uq {tf32['uq']:.3g}, predictor {tf32['predictor']}, "
            f"loss {tf32['loss']:.3g})")
    require(losses["cuda"][-1] < losses["cuda"][0],
            "offline_tiny: the training loss did not fall")
    require(ckpt_files == ["meta.json", "opt_state.npz", "params.npz"],
            f"offline_tiny: checkpoint holds {ckpt_files}")
    require(all(math.isfinite(v) for v in (ppl_dense, ppl_mixed, ppl_i4)),
            "offline_tiny: non-finite perplexity")
    require_path_kernels("offline_tiny dense", "train", dense_counts)
    require_path_kernels("offline_tiny mixed", "train_m2", mixed_counts)
    return line


def phase_ratio_search_full(cfg, params) -> dict:
    """On the shared full-width weights: every layer's predictor (rank 64)
    fitted with train_predictor to 1024 random probes from
    init_predictor's draws (PREDICTOR), its loss and recall (k = the
    config's active count) before and after, and put in the params; then
    Algorithm 1 (SEARCH_FULL) with each candidate's uq, wall seconds and
    launches, every qmatmul, flash_attention and flash_decode call of it
    held against its plain version on the same inputs (held_to_plain; each
    searched split at the decode's M = 2 and the prefill's M = 128). (1, 0,
    0) must come out infeasible. Returns the launches and each kernel's
    largest error."""
    import torch
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.predictor import (init_predictor, predictor_recall,
                                            train_predictor)
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    k = tier_sizes(cfg.d_ff, cfg)["k"]
    fits = []
    for l, layer in enumerate(params["layers"]):
        ffn = layer["ffn"]
        wg, wu = ffn["banks"]["wg_fp"].T, ffn["banks"]["wu_fp"].T
        xs = torch.randn((1024, cfg.d_model), generator=gen, device="cuda")
        A0, B0 = init_predictor(cfg.d_model, cfg.d_ff, cfg.m2_predictor_rank,
                                generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss0 = train_predictor(xs, wg, wu, act_name=cfg.ffn_act,
                                      A0=A0, B0=B0, steps=1)
        A, B, loss = train_predictor(xs, wg, wu, act_name=cfg.ffn_act,
                                     A0=A0, B0=B0, **PREDICTOR)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        recall = {name: float(predictor_recall(a, b, xs, wg, wu,
                                               act_name=cfg.ffn_act, k=k))
                  for name, (a, b) in (("served_drawn", (ffn["pred"]["A"],
                                                         ffn["pred"]["B"])),
                                       ("initial", (A0, B0)),
                                       ("trained", (A, B)))}
        ffn["pred"] = {"A": A, "B": B}
        fits.append({"layer": l, "loss_initial": float(loss0),
                     "loss_trained": float(loss), "recall": recall,
                     "fit_s": fit_s})
    kw = {k_: SEARCH_FULL[k_] for k_ in ("memory_budget", "gen_len")}
    prompts = search_prompts(cfg, SEARCH_FULL["B"], SEARCH_FULL["P"], "cuda")
    t0 = time.perf_counter()
    with held_to_plain("ratio_search_full", {}) as held:
        res, per, total = counted_search(cfg, params, prompts, **kw)
    search_s = time.perf_counter() - t0
    corner = next(r for r in res.table if r["ratio"] == (1.0, 0.0, 0.0))
    line = {"phase": "ratio_search_full", "config": cfg.name,
            "predictor": {**PREDICTOR, "probes": 1024,
                          "rank": cfg.m2_predictor_rank, "k": k,
                          "layers": fits},
            "search": {**SEARCH_FULL, "table": table_of(res),
                       "best_ratio": res.best_ratio, "best_uq": res.best_uq,
                       "candidates": per, "search_s": search_s,
                       "wall_note": "every kernel call held against its "
                                    "plain version inside the wall"},
            "held_to_plain": held, "tol_rel": 1e-5,
            "launches": total, "seconds": time.perf_counter() - t_phase}
    log(line)
    # every launch of the search was held against its plain version, and
    # every searched split at the decode's M = B and the prefill's M = B*P
    B, P = SEARCH_FULL["B"], SEARCH_FULL["P"]
    calls = {n: sum(e["calls"] for e in held.get(n, {}).values())
             for n in ("qmatmul_gemv", "qmatmul_mma", "flash_attention",
                       "flash_decode")}
    require(all(calls[n] == total[n] for n in calls),
            f"ratio_search_full: calls held {calls}, launches {total}")
    for c in per:
        t = c["tiers"]
        split = f"tiers={t['fp16']}/{t['int8']}/{t['int4']}"
        for kernel, M in (("qmatmul_gemv", B), ("qmatmul_mma", B * P)):
            require(f"M={M} {split}" in held[kernel],
                    f"ratio_search_full: {c['ratio']} not held at "
                    f"{kernel} M={M}")
    require(not corner["feasible"], "ratio_search_full: (1, 0, 0) feasible")
    require(all(math.isfinite(r["uq"]) for r in res.table if r["feasible"]),
            "ratio_search_full: a non-finite uq")
    require(all(math.isfinite(f["loss_trained"]) for f in fits),
            "ratio_search_full: a non-finite predictor loss")
    require_search_launches("ratio_search_full", cfg, per, kw["gen_len"])
    return total, {n: max(e["max_abs_err"] for e in by_key.values())
                   for n, by_key in held.items()}


def phase_train_full() -> dict:
    """qwen2.5-14b at full width, depth 48 -> TRAIN_FULL["layers"], the
    dense FFN (init_params(m2=False)): remat on against off for one step's
    gradients (REMAT_TOL), then TRAIN_FULL's AdamW steps with remat on the
    synthetic corpus: the loss and grad_norm at each step, a step's wall
    and device ms, the peak memory; the loss finite and falling."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import batches
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    t_phase = time.perf_counter()
    tf = TRAIN_FULL
    full = get_config("qwen2.5-14b")
    cfg = dataclasses.replace(full, num_layers=tf["layers"])
    params = T.init_params(cfg, seed=0, device="cuda", m2=False)
    param_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(params)) / 1e9
    it = batches(cfg, batch_size=tf["batch"], seq_len=tf["seq"], seed=0)

    def on_card(b):
        return {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
    first = on_card(next(it))

    def grads(remat: bool):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, _ = T.lm_loss(cfg, params, first, remat=remat)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
    torch.cuda.reset_peak_memory_stats()
    l_on, g_on = grads(True)
    peak_remat_gb = torch.cuda.max_memory_allocated() / 1e9
    del g_on
    torch.cuda.reset_peak_memory_stats()
    l_off, g_off = grads(False)
    peak_no_remat_gb = torch.cuda.max_memory_allocated() / 1e9
    del g_off
    l_on, g_on = grads(True)
    _, g_off = grads(False)
    remat_err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(g_on, g_off))
    del g_on, g_off
    torch.cuda.empty_cache()

    opt = AdamWConfig(lr=tf["lr"], total_steps=tf["steps"],
                      warmup_steps=tf["warmup"])
    state = init_opt_state(params)
    step = make_train_step(cfg, opt, remat=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = []
    batch = first
    for i in range(tf["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        hist.append({"step": i, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                     "wall_ms": (time.perf_counter() - t0) * 1e3})
        batch = on_card(next(it))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = read_counts()
    holder = {"p": params, "s": state}

    def one_step():
        holder["p"], holder["s"], _ = step(holder["p"], holder["s"], batch)
    profile = device_profile(one_step, reps=1)
    losses = [h["loss"] for h in hist]
    line = {"phase": "train_full", "config": cfg.name,
            "depth_cut": f"num_layers {full.num_layers} -> {cfg.num_layers}",
            "widths": {"d_model": cfg.d_model, "heads": cfg.num_heads,
                       "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
                       "vocab": cfg.vocab_size},
            **tf, "param_gb": param_gb,
            "remat_vs_off": {"loss_on": float(l_on), "loss_off": float(l_off),
                             "grad_max_rel_err": remat_err, "tol": REMAT_TOL,
                             "peak_gb_remat": peak_remat_gb,
                             "peak_gb_no_remat": peak_no_remat_gb},
            "steps_log": hist, "peak_mem_gb": peak_gb,
            "step_wall_ms_median": statistics.median(
                h["wall_ms"] for h in hist[1:]),
            "step_profile": profile,
            "launches": counts, "seconds": time.perf_counter() - t_phase}
    log(line)
    require_path_kernels("train_full", "train", counts)
    require(all(math.isfinite(x) for x in losses),
            "train_full: a non-finite loss")
    require(losses[-1] < losses[0], f"train_full: the loss did not fall "
                                    f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    require(remat_err <= REMAT_TOL,
            f"train_full: remat changes gradients by {remat_err:.3g}")
    require(float(l_on) == float(l_off), "train_full: remat changes the loss")
    return line


# ---------------------------------------------------------------------------
# Phases 18-20: long-context serving (the window override, the int8 K/V
# cache, launch/steps.build_case)

#: long_context_full: launch/steps' long_500k on full_model()'s weights:
#: its one row and 524288 positions, a ring of LONG_CONTEXT_WINDOW (8192)
#: slots; a prompt of the ring and 512 tokens more (the window masks the
#: last 512 queries, the prompt wraps the ring), gen_len greedy decode
#: steps, with the int8 K/V off and on; decode logits at LONG_CHECK_STEPS
#: held to whole-prompt prefills' within RING_TOL
LONG_RUN = dict(B=1, P=8192 + 512, gen_len=16, max_seq=524288)
LONG_CHECK_STEPS = (1, 16)
#: the query slices a whole prompt longer than 2 x SLICE is held on
#: against float64 (the plain version's Hq x S^2 fp32 scores are 12 GB at
#: 8704 tokens)
SLICE = 512
#: the int8 K/V measurement row: decode_32k's 32768 slots, its batch of
#: 128 cut to 8 to fit one card
INT8_ROW = dict(B=8, S=32768)
#: the kernel table's rows at long_context_full's shapes, by the kernel
#: held_to_plain names
LONG_ROWS = {"flash_attention": "flash_attention_window_8k",
             "flash_decode": "flash_decode_ring_8k",
             "qmatmul_gemv": "qmatmul_gemv_b1",
             "qmatmul_mma": "qmatmul_mma_m8704"}
#: steps_tiny: qwen2.5-14b tiny through launch/steps.build_case's serve
#: step: (input shape, kv_quant, the cache's pos before the decode steps:
#: 0 leaves it where the prefill did, 524272 puts RoPE at long_500k's
#: positions)
STEPS_TINY = (("long_500k", False, 0), ("long_500k", True, 0),
              ("long_500k", True, 524272), ("decode_32k", True, 0))
STEPS_TINY_RUN = dict(P=64, steps=4)


def phase_kernels_long(dev) -> dict:
    """The kernels at long_context_full's shapes (qwen2.5-14b: D = 128,
    G = 5, one row): the whole prompt of LONG_RUN["P"] tokens within the
    8192 window against the plain ``chunked_attention`` and, on its first
    and last SLICE queries, float64 (library: SDPA over K/V expanded to
    the query heads beforehand, the window as a boolean mask);
    flash_decode over the wrapped 8192-slot ring; one layer's FFN at M = 1
    (kernels A and B) and at M = 8704 (B); and the measurement row of a
    decode step's attention over int8 K/V at INT8_ROW's slots (dequantize
    to fp32, then flash_decode), timed against the bound of the int8
    bytes, with each part timed apart."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import _plan as whole_plan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch.steps import LONG_CONTEXT_WINDOW as W
    from repro_torch.models.common import chunked_attention
    from repro_torch.models.transformer import (_kv_dequantize, _kv_quantize,
                                                decode_slots)
    g = torch.Generator(device=dev).manual_seed(8704)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    cfg = get_config("qwen2.5-14b")
    hq, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = hq // hkv
    P, gen = LONG_RUN["P"], LONG_RUN["gen_len"]
    out, checks = {}, []
    check = checker(checks)

    # --- the whole prompt within the window
    q, kp, vp = randn(1, P, hq, D), randn(1, P, hkv, D), randn(1, P, hkv, D)
    run = lambda: flash_attention(q, kp, vp, window=W)
    pos = torch.arange(P, device=dev)[None]
    plain = lambda: chunked_attention(q, kp, vp, pos, pos, window=W)
    got = run()
    errs = [check(f"flash_attention S={P} window={W}", got, plain(), 1e-5)]
    for lo in (0, P - SLICE):
        hi = lo + SLICE
        errs.append(check(
            f"flash_attention S={P} window={W} queries {lo}..{hi} vs float64",
            got[:, lo:hi], attention_f64(
                q[:, lo:hi], kp[:, :hi], vp[:, :hi],
                torch.tensor([lo], device=dev), window=W), 1e-5))
    require(torch.equal(run(), got), "flash_attention window: two calls "
            "differ")
    del got
    qt = q.transpose(1, 2).contiguous()
    kt = kp.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = vp.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    i = torch.arange(P, device=dev)
    mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - W)
    pairs = int(mask.sum())
    out["flash_attention_window_8k"] = {
        "max_abs_err": max(errs), "B": 1, "S": P, "Hq": hq, "Hkv": hkv,
        "D": D, "window": W, "key_query_pairs": pairs,
        "plan": whole_plan(P, hq, hkv, D, build.sm_count(dev))._asdict(),
        "plain": "models.common.chunked_attention (512-query chunks)",
        "library": "SDPA, K/V expanded to the query heads beforehand, the "
                   "window as a boolean mask",
        **kernel_row(run, plain, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), (2 * q.numel() + 2 * kp.numel()) * 4,
            4 * hq * D * pairs, plain_reps=5)}
    del q, kp, vp, qt, kt, vt, mask

    # --- flash_decode over the wrapped ring at the last decode step
    out["flash_decode_ring_8k"] = decode_row(
        check, randn, dev, "flash_decode_ring_8k", W, hkv, G, D,
        [P + gen - 1], full_checks=True, sweep=(64, 256, 1024), ring=True,
        plain_reps=5)

    # --- one layer's FFN at the decode step (M = 1) and the prompt (8704)
    rows = serve_ffn_rows(check, g, dev, cfg, 1, P)[0]
    out["qmatmul_gemv_b1"] = rows["qmatmul_gemv"]
    out["qmatmul_mma_m8704"] = rows["qmatmul_mma"]
    torch.cuda.empty_cache()

    # --- a decode step's attention over int8 K/V (measurement)
    B8, S8 = INT8_ROW["B"], INT8_ROW["S"]
    q8 = randn(B8, hkv, G, D)
    k32, v32 = randn(B8, S8, hkv, D), randn(B8, S8, hkv, D)
    (kq, ks), (vq, vs) = _kv_quantize(k32), _kv_quantize(v32)
    # the card's quantizer against the CPU's on one row, bit for bit
    want_q, want_s = _kv_quantize(k32[:1].cpu())
    require(torch.equal(kq[:1].cpu(), want_q)
            and torch.equal(ks[:1].cpu(), want_s),
            "_kv_quantize: the card's bytes or scales differ from the CPU's")
    del k32, v32, want_q, want_s
    slots, ln = decode_slots(torch.full((B8,), S8 - 1, device=dev), S8)

    def dequantize():
        return (_kv_dequantize(kq, ks, torch.float32),
                _kv_dequantize(vq, vs, torch.float32))

    def step():
        return flash_decode(q8, *dequantize(), slots, ln)
    kd, vd = dequantize()
    decode = lambda: flash_decode(q8, kd, vd, slots, ln)
    err = check(f"flash_decode over int8 K/V B={B8} S={S8}", step(),
                ref.flash_decode_ref(q8, kd, vd, slots, ln), 1e-5)
    int8_bytes = (kq.numel() + vq.numel() + 4 * (ks.numel() + vs.numel())
                  + 4 * (2 * q8.numel() + slots.numel() + B8))
    flops = 4 * B8 * S8 * hq * D
    b_ms, b_by = bound(int8_bytes, flops)
    fp32_ms, _ = bound(4 * (kq.numel() + vq.numel() + 2 * q8.numel()
                            + slots.numel() + B8), flops)
    qt = q8.reshape(B8, hq, 1, D)
    kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True)
    out["flash_decode_int8_32k"] = {
        "max_abs_err": err, "B": B8, "S": S8, "kv_int8_mb": int8_bytes / 1e6,
        "kv_fp32_mb": 4 * (kd.numel() + vd.numel()) / 1e6,
        "function": "dequantize the int8 K/V to fp32, then flash_decode "
                    "(the port's decode step over an int8 cache)",
        "ms": time_ms(step), "dequantize_ms": time_ms(dequantize),
        "flash_decode_ms": time_ms(decode),
        "plain_ms": time_ms(lambda: ref.flash_decode_ref(
            q8, *dequantize(), slots, ln), reps=5),
        "library_ms": None,
        "library_note": "no one PyTorch call dequantizes and attends; SDPA "
                        "over the dequantized K/V is a yardstick",
        "sdpa_dequantized_ms": time_ms(sdpa),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_note": "the int8 bytes and scales read once, q and out",
        "bound_fp32_kv_ms": fp32_ms,
        "profile": device_profile(step),
        "dequantize_profile": device_profile(dequantize),
        "flash_decode_profile": device_profile(decode)}
    del q8, kq, vq, ks, vs, kd, vd, kt, vt
    for row in out.values():
        row["config"] = cfg.name
    torch.cuda.empty_cache()
    log({"phase": "kernels_long", "checks": checks, "kernels": out})
    return out


def ring_cpu(cache) -> dict:
    """A copy of the first pattern entry's leaves (every layer's ring) on
    the CPU."""
    return {n: t.to("cpu", copy=True) for n, t in cache["pattern"][0].items()}


def phase_long_context_full(cfg, params) -> tuple:
    """launch/steps' long_500k at full width on ``full_model()``'s weights
    (LONG_RUN: one row, the window override of LONG_CONTEXT_WINDOW slots
    over 524288 positions, a ring), through forward: a prompt of 8704
    tokens, then 16 greedy decode steps, with the int8 K/V off and on.
    Each run twice: first with every kernel call held against its plain
    version (held_to_plain; the whole prompt on its first and last SLICE
    queries against float64) and each call's kernels held to its form of
    the path, counted; then timed, the same tokens. kv_quant off: decode
    logits at LONG_CHECK_STEPS held to whole-prompt prefills'
    (decode_consistency over the ring, RING_TOL) with equal greedy tokens.
    kv_quant on: the ring's bytes and scales after the prefill equal
    ``_kv_quantize`` run on the CPU over the off run's fp32 ring, bit for
    bit (both runs compute the same K); its tokens' agreement with the off
    run counted. The prefill's and a decode step's wall, device time and
    busy share; the ring's bytes a layer; peak memory; the dequantize's
    share of a decode step. Returns ({"long_context": the counted runs'
    launches}, each held kernel's largest error)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.steps import LONG_CONTEXT_WINDOW as W
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    B, P, gen, max_seq = (LONG_RUN[k] for k in ("B", "P", "gen_len",
                                                "max_seq"))
    prompts = torch.as_tensor(make_prompts(cfg, B, P, 0), device="cuda")
    total, held, runs = {}, {}, {}
    for kv_quant in (False, True):
        label = f"long_context_full kv_quant={kv_quant}"

        def generate(counted: bool):
            """Prefill, then gen greedy decode steps: (tokens (B, gen), the
            ring after the prefill on the CPU, the last logits, per-call
            wall s)."""
            cache = T.init_cache(cfg, B, max_seq, window=W, kv_quant=kv_quant,
                                 device="cuda")
            walls, toks = [], []

            def call(tok, mode):
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                logits, _, _ = T.forward(cfg, params, tok, cache=cache,
                                         mode=mode, window=W)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if counted:
                    counts = read_counts()
                    require_path_kernels(f"{label} {mode}", f"forward_{mode}",
                                         counts)
                    for n, c in counts.items():
                        total[n] = total.get(n, 0) + c
                return logits
            last = call(prompts, "prefill")[:, -1].clone()
            ring = ring_cpu(cache)
            for _ in range(gen):
                nxt = torch.argmax(last, dim=-1)[:, None]
                toks.append(nxt)
                last = call(nxt, "decode")[:, 0]
            return torch.cat(toks, -1).cpu(), ring, last, walls
        with held_to_plain(label, held):
            toks, ring, last, _ = generate(counted=True)
        torch.cuda.reset_peak_memory_stats()
        toks2, _, _, walls = generate(counted=False)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        state = {}

        def prefill():
            state["cache"] = T.init_cache(cfg, B, max_seq, window=W,
                                          kv_quant=kv_quant, device="cuda")
            logits, _, _ = T.forward(cfg, params, prompts,
                                     cache=state["cache"], mode="prefill",
                                     window=W)
            state["last"] = logits[:, -1].clone()

        def decode():
            nxt = torch.argmax(state["last"], dim=-1)[:, None]
            logits, _, _ = T.forward(cfg, params, nxt, cache=state["cache"],
                                     mode="decode", window=W)
            state["last"] = logits[:, 0]
        profile = {"prefill": device_profile(prefill, reps=2)}
        prefill()
        profile["decode_step"] = device_profile(decode, reps=5)
        entry = state["cache"]["pattern"][0]
        layer_mb = sum(t[0].numel() * t.element_size()
                       for t in entry.values()) / 1e6
        if kv_quant:
            dq = device_profile(lambda: [T._kv_dequantize(
                entry[n][0], entry[f"{n}_s"][0], torch.float32)
                for n in ("k", "v")]).get("device_ms")
            dec_ms = profile["decode_step"].get("device_ms")
            dequantize = {"device_ms_a_layer": dq, "layers": cfg.num_layers,
                          "share_of_decode_step": dq * cfg.num_layers
                          / dec_ms if isinstance(dq, float) and isinstance(
                              dec_ms, float) else "not measured"}
        state.clear()
        runs[kv_quant] = dict(
            toks=toks, ring=ring, finite=bool(torch.isfinite(last).all()),
            second_run_equal=bool(torch.equal(toks, toks2)),
            line={"prefill_wall_ms": walls[0] * 1e3,
                  "decode_step_wall_ms_median": statistics.median(
                      walls[1:]) * 1e3,
                  "prefill_device_ms": profile["prefill"].get("device_ms"),
                  "prefill_busy_share": profile["prefill"].get("busy_share"),
                  "prefill_top_kernels_ms": profile["prefill"].get(
                      "top_kernels_ms"),
                  "decode_step_device_ms": profile["decode_step"].get(
                      "device_ms"),
                  "decode_step_busy_share": profile["decode_step"].get(
                      "busy_share"),
                  "decode_step_top_kernels_ms": profile["decode_step"].get(
                      "top_kernels_ms"),
                  "kernels_per_call": {k: v.get("kernels_per_call")
                                       for k, v in profile.items()},
                  "ring_mb_a_layer": layer_mb, "peak_mem_gb": peak_gb,
                  **({"dequantize": dequantize} if kv_quant else {}),
                  "tokens": toks.tolist()})
        torch.cuda.empty_cache()
    # the int8 ring after the prefill: the quantizer on the CPU over the
    # fp32 ring of the run without it
    fp32, int8 = runs[False]["ring"], runs[True]["ring"]
    quant_equal = {}
    for n in ("k", "v"):
        want_q, want_s = T._kv_quantize(fp32[n])
        quant_equal[n] = (torch.equal(int8[n], want_q)
                          and torch.equal(int8[f"{n}_s"], want_s))
    del fp32, int8
    t0 = time.perf_counter()
    consistency = decode_consistency(cfg, params, prompts, gen,
                                     LONG_CHECK_STEPS, window=W)
    consistency["seconds"] = time.perf_counter() - t0
    log({"phase": "long_context_full consistency", **consistency})
    agree = int((runs[True]["toks"] == runs[False]["toks"]).sum())
    line = {"phase": "long_context_full", "config": cfg.name,
            "depth_cut": f"num_layers {get_config(cfg.name).num_layers} "
                         f"-> {cfg.num_layers}",
            "input_shape": "long_500k", **LONG_RUN, "window": W,
            "ring_slots": W, "held_to_plain": held, "tol_rel": 1e-5,
            "kv_quant_off": runs[False]["line"],
            "kv_quant_on": runs[True]["line"],
            "int8_ring_equals_cpu_quantizer": quant_equal,
            "tokens_agreeing_int8_vs_fp32": f"{agree} of {B * gen}",
            "consistency_max_abs_err": consistency["max_abs_err"],
            "consistency_worst_err_over_tol":
                consistency["worst_err_over_tol"],
            "launches": total, "seconds": time.perf_counter() - t_phase}
    log(line)
    for kv_quant, r in runs.items():
        require(r["finite"], f"long_context_full kv_quant={kv_quant}: "
                "non-finite logits")
        require(r["second_run_equal"], f"long_context_full kv_quant="
                f"{kv_quant}: a second run gave other tokens")
    require(all(quant_equal.values()), "long_context_full: the int8 ring "
            "differs from the CPU quantizer over the fp32 ring: "
            f"{quant_equal}")
    require(all(consistency["argmax_equal_by_step"].values()),
            "long_context_full: a decode step's greedy token differs from "
            f"the whole prompt's: {consistency['argmax_equal_by_step']}")
    require_path_kernels("long_context_full", "forward", total)
    return {"long_context": total}, {
        n: max(e["max_abs_err"] for e in by_key.values())
        for n, by_key in held.items()}


def _shapes(tree, path: str = "") -> dict:
    """Every tensor leaf's shape and dtype, by its path in the tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), tree.dtype)} if hasattr(
        tree, "shape") else {}


def _cache_to(cache, device) -> dict:
    """A copy of a cache on ``device``."""
    return {"pattern": [{n: t.to(device, copy=True) for n, t in e.items()}
                        for e in cache["pattern"]],
            "remainder": [{n: t.to(device, copy=True) for n, t in e.items()}
                          for e in cache["remainder"]],
            "pos": cache["pos"]}


def _ring_gap(got, want, at=None) -> tuple:
    """(bytes apart, the largest distance, the scales' largest relative
    error over the written slots) of two caches' first pattern entries,
    compared on the card: every slot, or slot ``at`` alone (0, 0, 0.0
    without the int8 K/V)."""
    apart, worst, rel = 0, 0, 0.0
    for n in ("k", "v"):
        if f"{n}_s" not in want:
            continue
        a, b, sa, sb = (t.to("cuda") if at is None else t[:, :, at].to("cuda")
                        for t in (got[n], want[n], got[f"{n}_s"],
                                  want[f"{n}_s"]))
        d = (a.int() - b.int()).abs()
        apart, worst = apart + int((d > 0).sum()), max(worst, int(d.max()))
        rel = max(rel, float(((sa - sb).abs() / sb.clamp_min(1e-30)).max()))
    return apart, worst, rel


def phase_steps_tiny() -> list:
    """qwen2.5-14b tiny through launch/steps.build_case (variant m2): each
    STEPS_TINY case's serve step on cuda against cpu from the same weights
    (every predictor A drawn), the params' and cache's shapes those of the
    case's meta args: a prefill of STEPS_TINY_RUN["P"] tokens a row
    through forward with the case's window, then 4 greedy serve steps,
    each device on its own cache. The prefill's last logits within 1e-4
    (abs and rel); with the int8 K/V its bytes at most 1 apart (at .5
    ties, counted) and its scales within 1e-5 relative. Without the int8
    K/V: tokens equal, every step's logits within 1e-4. With it one byte
    apart moves the logits by ~1e-3, which flips a greedy token whose top
    two logits lie closer, and at decode_32k's 128 rows the flip spreads
    through the batch's shared active set: the free run is printed, and
    each step runs again on the card from the CPU's cache before it, with
    the CPU's token: the bytes it writes at most 1 apart, and where they
    are equal the same greedy tokens and logits within 1e-4 (else the gap
    printed). Every kernel of the path launched on the card."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.steps import build_case
    from repro_torch.models import transformer as T
    arch = "qwen2.5-14b"
    cfg = tiny_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    draw_pred_a(params, torch.Generator().manual_seed(1), "cpu")
    gpu = _tree_to(params, "cuda")
    P, n_steps = STEPS_TINY_RUN["P"], STEPS_TINY_RUN["steps"]
    close = lambda a, b: torch.allclose(a, b, atol=1e-4, rtol=1e-4)
    lines = []
    for shape_name, kv_quant, far in STEPS_TINY:
        t0 = time.perf_counter()
        label = f"steps_tiny {shape_name} kv_quant={kv_quant}" + (
            f" pos={far}" if far else "")
        case = build_case(arch, shape_name, variant="m2", kv_quant=kv_quant,
                          tiny=True)
        shape = INPUT_SHAPES[shape_name]
        B, window = shape.global_batch, case.meta["window"]
        require(_shapes(params) == _shapes(case.args[0]),
                f"{label}: the params are not the case's")
        prompts = torch.as_tensor(make_prompts(cfg, B, P, 0))
        runs = {}
        for dev, p in (("cpu", params), ("cuda", gpu)):
            cache = T.init_cache(cfg, B, shape.seq_len, window=window,
                                 kv_quant=kv_quant, device=dev)
            require(_shapes(cache) == _shapes(case.args[1]),
                    f"{label}: the cache is not the case's")
            reset_counts()
            logits, cache, _ = T.forward(cfg, p, prompts.to(dev), cache=cache,
                                         mode="prefill", window=window,
                                         m2=case.meta["m2"])
            if far:
                cache["pos"] = far
            run = dict(lasts=[logits[:, -1].cpu()], toks=[], before=[],
                       prefill_ring=ring_cpu(cache))
            for _ in range(n_steps):
                run["toks"].append(torch.argmax(run["lasts"][-1], dim=-1)[
                    :, None].to(torch.int32))
                if dev == "cpu":
                    run["before"].append(_cache_to(cache, "cpu"))
                last, cache = case.fn(p, cache,
                                      {"tokens": run["toks"][-1].to(dev)})
                run["lasts"].append(last.cpu())
            run["counts"] = read_counts()
            run["toks"] = torch.cat(run["toks"], -1)
            if dev == "cpu":
                run["before"].append(cache)
            runs[dev] = run
            del cache
        cpu, cuda = runs["cpu"], runs["cuda"]
        prefill_gap = _ring_gap(cuda["prefill_ring"], cpu["prefill_ring"])
        sbuf = cpu["prefill_ring"]["k"].shape[2]
        # each step on the card from the CPU's cache before it
        fixed = []
        for i in range(n_steps):
            before, after = cpu["before"][i], cpu["before"][i + 1]
            cache = _cache_to(before, "cuda")
            last, cache = case.fn(gpu, cache, {"tokens": cpu["toks"][
                :, i:i + 1].to("cuda")})
            at = before["pos"] % sbuf if window else before["pos"]
            new = _ring_gap(cache["pattern"][0], after["pattern"][0], at)
            want = cpu["lasts"][i + 1]
            fixed.append({"step": i + 1, "slot": at,
                          "new_bytes_apart": new[0],
                          "new_bytes_worst_apart": new[1],
                          "new_scale_max_rel_err": new[2],
                          "max_abs_err": max_err(last.cpu(), want),
                          "logits_close": close(last.cpu(), want),
                          "tokens_equal": bool(torch.equal(
                              last.argmax(-1).cpu(), want.argmax(-1)))})
            del cache
        del cpu["before"]
        line = {"phase": label, "config": cfg.name, "case": case.name,
                "meta": case.meta, "batch": B, "cache_positions":
                shape.seq_len, "prompt_len": P, "decode_steps": n_steps,
                "start_pos": far or P,
                "prefill_last_logits_max_abs_err": max_err(
                    cuda["lasts"][0], cpu["lasts"][0]),
                "prefill_int8_bytes_apart": prefill_gap[0],
                "prefill_int8_worst_apart": prefill_gap[1],
                "prefill_scale_max_rel_err": prefill_gap[2],
                "free_running": {
                    "tokens_equal": bool(torch.equal(cuda["toks"],
                                                     cpu["toks"])),
                    "tokens_apart": int((cuda["toks"] != cpu["toks"]).sum()),
                    "last_logits_max_abs_err_by_step": [
                        max_err(a, b) for a, b in zip(cuda["lasts"],
                                                      cpu["lasts"])]},
                "cpu_min_top2_gap_by_step": [
                    float(torch.topk(l, 2).values.diff().abs().min())
                    for l in cpu["lasts"]],
                "from_cpu_cache": fixed, "tol_abs_rel": 1e-4,
                "launches_cuda": cuda["counts"],
                "seconds": time.perf_counter() - t0}
        log(line)
        require(close(cuda["lasts"][0], cpu["lasts"][0]),
                f"{label}: prefill logits differ")
        if not kv_quant:
            require(line["free_running"]["tokens_equal"]
                    and all(close(a, b) for a, b in zip(cuda["lasts"],
                                                        cpu["lasts"])),
                    f"{label}: cuda and cpu differ: {line['free_running']}")
        for gap in [prefill_gap] + [(f["new_bytes_apart"],
                                     f["new_bytes_worst_apart"],
                                     f["new_scale_max_rel_err"])
                                    for f in fixed]:
            require(gap[1] <= 1 and gap[2] <= 1e-5,
                    f"{label}: int8 bytes {gap[1]} apart, scales {gap[2]:.3g}")
        for f in fixed:
            require(f["new_bytes_apart"] > 0 or (f["logits_close"]
                                                 and f["tokens_equal"]),
                    f"{label}: from the CPU's cache, step {f['step']}: {f}")
        require_path_kernels(label, "forward", cuda["counts"],
                             each_qmm_kernel=False)
        lines.append(line)
    return lines


# ---------------------------------------------------------------------------
# Phase 21: the mesh tooling (the dry run's records and roofline, then one
# real long_500k serve step at full depth against its bound)

#: mesh_full: the dry run's combinations of qwen2.5-14b's full config
#: (mesh, variant, input shape), then the real step's
MESH_ARCH = "qwen2.5-14b"
MESH_DRYRUN = tuple((mesh, "dense", shape) for mesh in ("host", "single")
                    for shape in ("train_4k", "prefill_32k", "decode_32k",
                                  "long_500k")) + (("single", "m2",
                                                    "decode_32k"),)
#: the reference's per-device FLOPs of each 16 x 16 combination held here,
#: (arch, input shape, variant) -> flops_per_device, from its own dry run on
#: the CPU: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun
#: --arch all --shape all --mesh single --variant dense`` (and ``--variant
#: m2``), its HLO's dots counted by repro/roofline/hlo_cost.py
MESH_REFERENCE_FLOPS = {
    ("qwen2.5-14b", "train_4k", "dense"): 556176789995520.0,
    ("qwen2.5-14b", "prefill_32k", "dense"): 378493992960000.0,
    ("qwen2.5-14b", "decode_32k", "dense"): 30096752640.0,
    ("qwen2.5-14b", "long_500k", "dense"): 392417280.0,
    ("qwen2.5-14b", "decode_32k", "m2"): 23020290048.0,
    ("recurrentgemma-2b", "train_4k", "dense"): 130657267220480.0,
    ("recurrentgemma-2b", "prefill_32k", "dense"): 111670659645440.0,
    ("mamba2-370m", "train_4k", "dense"): 12516675551232.0,
    ("musicgen-large", "train_4k", "dense"): 125750199975936.0,
    ("musicgen-large", "prefill_32k", "dense"): 79302007717888.0,
    ("mistral-large-123b", "prefill_32k", "dense"): 1581647476555776.0,
    ("llama4-maverick-400b-a17b", "long_500k", "dense"): 6405706240.0}
#: the 16 x 16 dry runs (dense) that each run through the dry-run CLI in a
#: process of their own, all at once, beside (a): the five that torch
#: 2.11's DTensor could not trace before the port gave it a flip rule, the
#: RG-LRU's gates replicated inputs and the prompt's attention local shards,
#: and the two that counted furthest from the reference (15x and 6.5x its
#: FLOPs before their placements were GSPMD's)
MESH_SUBPROCESS = (("recurrentgemma-2b", "train_4k"),
                   ("recurrentgemma-2b", "prefill_32k"),
                   ("mamba2-370m", "train_4k"),
                   ("musicgen-large", "train_4k"),
                   ("musicgen-large", "prefill_32k"),
                   ("mistral-large-123b", "prefill_32k"),
                   ("llama4-maverick-400b-a17b", "long_500k"))
#: how far a record's flops_per_device may lie from the reference's
MESH_FLOPS_TOL = 0.01
#: the real step: long_500k's one row, its 8192-slot ring started at the
#: position steps_tiny starts from, MESH_STEPS serve steps
MESH_START, MESH_STEPS = 524272, 16
MESH_CACHE_SEED = 3
#: the measured device time a step must reach, as a share of the roofline's
#: larger term: a bound above the card's own time is a counting fault
MESH_BOUND_SHARE = 0.95


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if hasattr(t, "element_size"))


def phase_mesh_full() -> dict:
    """(a) launch/dryrun.run_one for MESH_ARCH's full config at every
    MESH_DRYRUN combination (fake DTensors on placeholder ranks, traced on
    the host CPU): each record's memory, roofline terms, bottleneck and
    trace seconds printed, status "ok" required, and on 16 x 16 its
    flops_per_device within MESH_FLOPS_TOL of MESH_REFERENCE_FLOPS; beside
    it, the dry-run CLI for each MESH_SUBPROCESS combination on 16 x 16 in
    a process of its own, status "ok" and the same tolerance required, its
    trace seconds and torch version printed. (b) The real step:
    build_case(MESH_ARCH, "long_500k", mesh=make_host_mesh(),
    variant="dense"), materialised on the card at all 48 layers and full
    width (init_params(m2=False): 59.1 GB of fp32 weights) with the
    window's 8192-slot ring at MESH_START, its K/V seeded normal values,
    MESH_STEPS serve steps: 48
    flash_decode launches a step (its counter); the first step's calls held
    against the plain version (held_to_plain); the host record's
    argument_gb equal to the real params', cache's and tokens' bytes; the
    median device ms of a step (device_profile, five sessions of one step)
    at least MESH_BOUND_SHARE x the record's max(compute_s, memory_s).
    Returns ({"mesh_full": launches}, the held kernels' largest errors)."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, release_mesh
    from repro_torch.launch.steps import build_case
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="mesh_repaired_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    repaired = [(arch, shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(out_dir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for arch, shape in MESH_SUBPROCESS]

    def off_reference(arch, shape, variant, flops):
        """flops_per_device / the reference's, where it is held, else
        None."""
        want = MESH_REFERENCE_FLOPS.get((arch, shape, variant))
        return None if want is None or flops is None else flops / want
    try:
        records = {}
        for mesh, variant, shape in MESH_DRYRUN:
            rec = dryrun.run_one(MESH_ARCH, shape, mesh=mesh,
                                 variant=variant, verbose=False)
            records[(mesh, variant, shape)] = rec
            r = rec["roofline"]
            log({"phase": "mesh_full dryrun", "arch": MESH_ARCH,
                 "shape": shape, "mesh": rec["mesh"], "variant": variant,
                 "status": rec["status"], "memory": rec["memory"],
                 "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                 "collective_s": r["collective_s"],
                 "bottleneck": r["bottleneck"],
                 "collectives": r["collectives"],
                 "useful_flops_ratio": r["useful_flops_ratio"],
                 "trace_s": rec["trace_s"], "cost": rec["cost"]})
            require(rec["status"] == "ok", f"mesh_full: the dry run of "
                    f"{shape} on {mesh} ({variant}) is {rec['status']}")
            if mesh == "single":
                flops = r["flops_per_device"]
                ratio = off_reference(MESH_ARCH, shape, variant, flops)
                log({"phase": "mesh_full reference", "arch": MESH_ARCH,
                     "shape": shape, "variant": variant, "mesh": "16x16",
                     "flops_per_device": flops, "flops_reference":
                     MESH_REFERENCE_FLOPS[(MESH_ARCH, shape, variant)],
                     "over_reference": ratio})
                require(abs(ratio - 1) <= MESH_FLOPS_TOL,
                        f"mesh_full: the dry run of {MESH_ARCH} {shape} "
                        f"({variant}) on 16 x 16 counts {ratio:.4f} x the "
                        "reference's FLOPs a device")
        for arch, shape, proc in repaired:
            text, _ = proc.communicate()
            path = out_dir / f"{arch}__{shape}__single__dense.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            flops = rec.get("roofline", {}).get("flops_per_device")
            ratio = off_reference(arch, shape, "dense", flops)
            log({"phase": "mesh_full subprocess", "arch": arch,
                 "shape": shape, "mesh": "16x16", "variant": "dense",
                 "torch": torch.__version__, "status": rec.get("status"),
                 "trace_s": rec.get("trace_s"),
                 "error": rec.get("error"), "exit": proc.returncode,
                 "flops_per_device": flops, "flops_reference":
                 MESH_REFERENCE_FLOPS[(arch, shape, "dense")],
                 "over_reference": ratio,
                 "bytes_per_device": rec.get("roofline", {}).get(
                     "bytes_per_device")})
            require(proc.returncode == 0 and rec.get("status") == "ok",
                    f"mesh_full: the dry run of {arch} {shape} on 16 x 16 "
                    f"failed: {rec.get('error') or text[-2000:]}")
            require(abs(ratio - 1) <= MESH_FLOPS_TOL,
                    f"mesh_full: the dry run of {arch} {shape} on 16 x 16 "
                    f"counts {ratio:.4f} x the reference's FLOPs a device")
    finally:
        for *_, proc in repaired:      # a failure above leaves none
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shutil.rmtree(out_dir, ignore_errors=True)
    dry_s = time.perf_counter() - t_phase
    host = records[("host", "dense", "long_500k")]
    bound_ms = max(host["roofline"]["compute_s"],
                   host["roofline"]["memory_s"]) * 1e3

    cfg = get_config(MESH_ARCH)
    mesh = make_host_mesh()
    held, launches = {}, {}
    try:
        case = build_case(MESH_ARCH, "long_500k", mesh=mesh, variant="dense")
        require(case.meta["chips"] == 1 and case.meta["window"],
                f"mesh_full: the case is not one card's ring: {case.meta}")
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, seed=0, device="cuda", m2=False)
        cache = T.init_cache(cfg, 1, INPUT_SHAPES["long_500k"].seq_len,
                             window=case.meta["window"], device="cuda")
        cache["pos"] = MESH_START
        # every slot of the ring holds seeded K/V, so that the first step's
        # hold sees which slot the token writes and which slots it reads
        gen = torch.Generator(device="cuda").manual_seed(MESH_CACHE_SEED)
        for t in _leaves(cache):
            if isinstance(t, torch.Tensor):
                t.normal_(generator=gen)
        require(_shapes(params) == _shapes(case.args[0])
                and _shapes(cache) == _shapes(case.args[1]),
                "mesh_full: the real params or cache are not the case's")
        tok = torch.full((1, 1), 17, dtype=torch.int32, device="cuda")
        real_bytes = _tensor_bytes(params) + _tensor_bytes(cache) \
            + _tensor_bytes(tok)
        arg_bytes = host["memory"]["argument_gb"] * 2 ** 30
        walls, toks, per_step = [], [], []
        for i in range(MESH_STEPS):
            held_step = held_to_plain("mesh_full", held) if i == 0 \
                else contextlib.nullcontext()
            with held_step:
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                logits, cache = case.fn(params, cache, {"tokens": tok})
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            counts = read_counts()
            per_step.append(counts["flash_decode"])
            for n, c in counts.items():
                launches[n] = launches.get(n, 0) + c
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            toks.append(int(tok))
        finite = bool(torch.isfinite(logits).all())

        def step():
            cache["pos"] = MESH_START
            case.fn(params, cache, {"tokens": tok})
        profiles = [device_profile(step, reps=1) for _ in range(5)]
        dev = [p["device_ms"] for p in profiles
               if isinstance(p.get("device_ms"), float)]
        dev_ms = statistics.median(dev) if dev else "not measured"
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        del params, cache, logits
    finally:
        release_mesh()
    torch.cuda.empty_cache()
    ratio = dev_ms / bound_ms if dev else "not measured"
    line = {"phase": "mesh_full", "config": cfg.name, "layers":
            cfg.num_layers, "case": case.name, "meta": case.meta,
            "start_pos": MESH_START, "steps": MESH_STEPS,
            "flash_decode_launches_by_step": per_step,
            "held_to_plain": held, "tol_rel": 1e-5,
            "argument_bytes_record": arg_bytes, "argument_bytes_real":
            real_bytes, "step_wall_ms_median": statistics.median(
                walls[1:]) * 1e3, "step_wall_ms_first": walls[0] * 1e3,
            "step_device_ms_median": dev_ms, "step_device_ms_sessions": dev,
            "busy_share": [p.get("busy_share") for p in profiles],
            "kernels_per_step": profiles[-1].get("kernels_per_call"),
            "top_kernels_ms": profiles[-1].get("top_kernels_ms"),
            "roofline_bound_ms": bound_ms,
            "roofline_bottleneck": host["roofline"]["bottleneck"],
            "device_ms_over_bound": ratio, "bound_share_required":
            MESH_BOUND_SHARE, "max_memory_allocated_gib": peak_gb,
            "record_per_device_gib": host["memory"]["per_device_gb"],
            "tokens": toks, "dryrun_seconds": dry_s,
            "launches": launches, "seconds": time.perf_counter() - t_phase}
    log(line)
    require(finite, "mesh_full: non-finite logits")
    require(all(n == cfg.num_layers for n in per_step),
            f"mesh_full: flash_decode launches by step {per_step}, want "
            f"{cfg.num_layers} each")
    require(arg_bytes == real_bytes, f"mesh_full: the record's arguments "
            f"{arg_bytes} bytes, the real ones {real_bytes}")
    require(isinstance(ratio, float) and ratio >= MESH_BOUND_SHARE,
            f"mesh_full: a step's device time {dev_ms} ms against the "
            f"roofline's {bound_ms:.4g} ms")
    require_path_kernels("mesh_full", "dense_decode", launches)
    return {"mesh_full": launches}, {
        n: max(e["max_abs_err"] for e in by_key.values())
        for n, by_key in held.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# bf16, the reference's default precision: the kernels' bf16 forms, the
# families tiny at bf16, and the full-depth long_500k steps at bf16

#: bf16_tiny: the families, each tiny at bf16 through forward on cuda
#: against cpu from the same weights
BF16_FAMILIES = ("qwen2.5-14b", "internvl2-1b", "grok-1-314b",
                 "llama4-maverick-400b-a17b", "recurrentgemma-2b",
                 "mamba2-370m")
#: |cuda - cpu| a family's logit may differ by at bf16, as a share of
#: max(1, max|cpu logits|), about 3x its largest reading with the CPU's
#: active sets replayed on the card (H100 80GB HBM3, 700 W: qwen2.5-14b
#: 0.0100, internvl2-1b 0.0133, grok-1-314b 0.0166, llama4 0.0253,
#: recurrentgemma-2b 0.0066, mamba2-370m 0.0065, the same in four runs).
#: Every kernel call is held to its plain version (held_to_plain); the
#: rest is rounding: the kernels sum in fp32 and round once (qmatmul a
#: product, attention its output) where the CPU's plain versions round
#: every bf16 op, so the residual stream differs by bf16 units from the
#: first layer on. The control each M2Cache family's limit must fail: the
#: sets left free, where a predictor score that ties within a bf16 unit
#: swaps a neuron (qwen2.5-14b 0.117, internvl2-1b 0.118,
#: recurrentgemma-2b 0.029). Greedy tokens must agree where the CPU's
#: top-2 margin is wider than the limit
BF16_TINY_TOL = {"qwen2.5-14b": 0.03, "internvl2-1b": 0.04,
                 "grok-1-314b": 0.05, "llama4-maverick-400b-a17b": 0.075,
                 "recurrentgemma-2b": 0.02, "mamba2-370m": 0.02}
#: mesh_bf16_full: the first step's logits through the kernels against the
#: same step through the plain versions on the card, with the kernels'
#: active sets replayed, as a share of max(1, max|plain|): about 2x the
#: readings (m2 0.0610, dense 0.0586, logits below 1, H100 80GB HBM3,
#: 700 W), 48 layers of bf16 activations rounded at other places on the
#: two sides (the kernels sum in fp32 and round once, the plain versions
#: round every bf16 op). The control it must fail: the m2 step with the
#: sets left free, 1.14 apart (a predictor score that ties within a bf16
#: unit swaps a neuron, and 48 layers of random weights carry each swap on)
MESH_BF16_TOL = 0.125
#: moe_bf16_full: llama4-maverick at full width, its depth cut to this
MOE_BF16_LAYERS = 1
#: mesh_bf16_full's and bf16_tiny's held kernels -> their rows of the
#: kernel table
BF16_MESH_ROWS = {"qmatmul_gemv": "qmatmul_gemv_bf16_b1",
                  "qmm_glu": "qmm_glu_bf16",
                  "flash_decode": "flash_decode_bf16_ring_8k"}
BF16_TINY_ROWS = {"qmatmul_gemv": "qmatmul_gemv_bf16_b1",
                  "qmm_glu": "qmm_glu_bf16",
                  "qmatmul_mma": "qmatmul_mma_bf16_m512",
                  "flash_decode": "flash_decode_bf16",
                  "flash_attention": "flash_attention_bf16"}


@contextlib.contextmanager
def active_sets(record: list, replay: bool):
    """Inside the block the M2Cache FFN's active sets are appended to
    ``record`` (``replay`` False) or taken from it in order (``replay``
    True), in place of the predictor's top-k."""
    from repro_torch.core import mp_ffn
    saved = mp_ffn.shared_topk_indices
    it = iter(list(record))

    def topk(scores, k):
        if replay:
            return next(it).to(scores.device)
        idx = saved(scores, k)
        record.append(idx)
        return idx
    mp_ffn.shared_topk_indices = topk
    try:
        yield record
    finally:
        mp_ffn.shared_topk_indices = saved


@contextlib.contextmanager
def plain_on_card():
    """Inside the block ``kernels.ops`` sends every tensor to its plain
    PyTorch version, on the card: the same step without the kernels."""
    from repro_torch.kernels import ops
    saved = ops._on_cpu
    ops._on_cpu = lambda t: True
    try:
        yield
    finally:
        ops._on_cpu = saved


def bf16_counts() -> dict:
    """The bf16 launches of each kernel since the counts were last reset."""
    from repro_torch.kernels import (chunk_attention, flash_attention,
                                     flash_decode, qmatmul)
    return {"qmatmul": qmatmul.launches_bf16,
            "qmm_glu": qmatmul.launches_glu,
            "flash_decode": flash_decode.launches_bf16,
            "flash_attention": flash_attention.launches_bf16,
            "chunk_attention": chunk_attention.launches_bf16}


def reset_bf16_counts():
    from repro_torch.kernels import (chunk_attention, flash_attention,
                                     flash_decode, qmatmul)
    for mod in (qmatmul, flash_decode, flash_attention, chunk_attention):
        mod.launches_bf16 = 0
    qmatmul.launches_glu = 0


def ffn_bf16_issued(R: int, M: int, d: int, k16: int, k8: int, k4: int,
                    dev) -> float:
    """Operations the bf16 kernel B's MMAs issue for one layer's FFN over R
    rows of M, tiles as its plan gives them (``qmatmul._plan``: 16 or 64
    rows by 64 outputs, 64 deep, each split's last tile whole), gate and up
    (col) and down (row) for each tier, the int tiers' down products in
    as many terms as the kernel splits h times the scale into
    (``qmatmul.bf16_row_terms``)."""
    from repro_torch.kernels import qmatmul as qm

    def up(n, m):
        return -(-n // m) * m

    def one(N, K, layout):
        _, tile, splits, k_split = qm._plan(M, N, K, layout, dev)
        deep = sum(up(min(k_split, K - s * k_split), 64)
                   for s in range(splits))
        return up(M, tile) * up(N, 64) * deep
    total = 0
    row_terms = qm.bf16_row_terms()
    for n, terms in ((k16, 1), (k8, row_terms), (k4, row_terms)):
        total += 2 * one(n, d, "col") + terms * one(d, n, "row")
    return 2.0 * R * total


def attention_bf16_issued(B: int, S: int, Hq: int, D: int,
                          pos0=None) -> float:
    """Operations the bf16 attention kernels' MMAs issue: each (row, query
    head, 16-row sub-tile) multiplies whole 32-key tiles up to its last
    query's position, S = Q K^T once and P V in as many bf16 terms as the
    kernel splits P into (``flash_attention.bf16_p_terms``: 2)."""
    from repro_torch.kernels import flash_attention as fa
    keys = 0
    for p in pos0 or [0] * B:
        for r0 in range(0, S, 16):
            keys += 32 * ((p + min(r0 + 16, S) - 1) // 32 + 1)
    return 2.0 * 16 * keys * Hq * D * (1 + fa.bf16_p_terms())


def glu_tiers(banks, idx, sizes) -> list:
    """(precision, wg, wu, sg, su, idx) of each non-empty tier of a layer's
    neuron-major banks over active sets idx (R, k), as ``ops.mp_ffn`` hands
    them to the fused GLU."""
    out, start = [], 0
    for precision, tier, sfx in (("fp", "fp16", "_fp"), ("int8", "int8", "_i8"),
                                 ("int4", "int4", "_i4")):
        n = sizes[tier]
        if n == 0:
            continue
        t_idx = idx[:, start:start + n].contiguous()
        start += n
        sg, su = ((None, None) if precision == "fp" else
                  (banks[f"wg{sfx}_s"], banks[f"wu{sfx}_s"]))
        out.append((precision, banks[f"wg{sfx}"], banks[f"wu{sfx}"], sg, su,
                    t_idx if idx.shape[0] > 1 else t_idx[0]))
    return out


def glu_check(label: str, x, tiers, act: str) -> dict:
    """The fused GLU of each tier on x (R, 1, d) bf16 with its products:
    gate and up held within 1e-5 x max(1, max|plain|) of the plain
    products and equal bit for bit to kernel A's col form's (the same sums
    in the same order); h against ``activation(gate.to(bf16)) *
    up.to(bf16)`` computed by PyTorch on the card over those products,
    values that differ counted (the caller requires none)."""
    import torch
    from repro_torch.kernels import qmatmul, ref
    xs = x if x.shape[0] > 1 else x[0]
    out = {"values": 0, "h_differs": 0, "products_differ_from_col": 0,
           "max_abs_err": 0.0}
    for precision, wg, wu, sg, su, idx in tiers:
        (h, gate, up), = qmatmul.glu_bf16(
            xs, [(precision, wg, wu, sg, su, idx)], act=act, products=True)
        for got, w, s in ((gate, wg, sg), (up, wu, su)):
            want = ref.qmm_gathered_ref(xs, w, s, idx, precision=precision)
            err = max_err(got, want)
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            require(err <= tol, f"{label} {precision}: a product {err:.3g} "
                                f"from the plain one, tol {tol:.3g}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            col = qmatmul.qmatmul_gathered(xs, w, s, idx,
                                           precision=precision)
            out["products_differ_from_col"] += int((col != got).sum())
        want = ref.glu_bf16_ref(gate, up, act)
        out["values"] += h.numel()
        out["h_differs"] += int((h.view(torch.int16)
                                 != want.view(torch.int16)).sum())
    require(out["products_differ_from_col"] == 0,
            f"{label}: the fused products differ from the col form's: {out}")
    return out


def phase_kernels_bf16(cfg, dev) -> dict:
    """Each bf16 form at the shapes the bf16 paths give it, held against its
    plain version (qmatmul's and flash_decode's fp32 outputs within 1e-5 x
    max(1, max|plain|); the attention forms' bf16 outputs within half a
    bf16 unit of the plain fp32 result plus that) and timed:
    qwen2.5-14b's FFN (d = 5120, f = 13824, bf16 fp tier) at M = 1 (kernel
    A, the m2 long_500k step) and R = 4 rows of M = 1 (kernel A, per-row
    sets), at M = 512 (kernel B, a prompt) and R = 4 rows of a 16-token
    chunk (kernel B): a layer's FFN, 9 calls, each held (library call: the
    three products by torch.matmul on the gathered, dequantized bf16
    weights); flash_decode over long_500k's wrapped 8192-slot ring and at
    the serve step; flash_attention on a 128-token prompt and its chunk form
    at 16 tokens over 256 slots (library call: SDPA at bf16). Two
    measurement rows no path runs, each against its library call: kernel B
    at long_500k's prefill, x (8704, 5120), and the whole prompt at 2048
    tokens. The kernels on the bf16 tensor cores (kernel B, the attention
    forms) take a second bound: the operations their MMAs issue."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import (build_neuron_banks,
                                           to_neuron_major, unpack_int4)
    from repro_torch.kernels import ops, qmatmul, ref
    from repro_torch.models.common import activation
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(26)
    d, f = cfg.d_model, cfg.d_ff
    banks = to_neuron_major(build_neuron_banks(
        *(torch.randn(s, generator=g, device=dev).mul_(s[0] ** -0.5).to(bf)
          for s in ((d, f), (d, f), (f, d)))))
    sizes = tier_sizes(f, cfg)
    k16, k8, k4, k = sizes["fp16"], sizes["int8"], sizes["int4"], sizes["k"]
    act = activation(cfg.ffn_act)
    rows = {}

    def gathered(idx):
        """The three dequantized bf16 products' weights of one active set
        (the library call's operands)."""
        i16, i8, i4 = idx[:k16], idx[k16:k16 + k8], idx[k16 + k8:]

        def one(w):
            return torch.cat([
                banks[f"{w}_fp"][i16],
                banks[f"{w}_i8"][i8].to(bf) * banks[f"{w}_i8_s"][i8].to(
                    bf)[:, None],
                unpack_int4(banks[f"{w}_i4"][i4], 1).to(bf)
                * banks[f"{w}_i4_s"][i4].to(bf)[:, None]])
        return one("wg").t().contiguous(), one("wu").t().contiguous(), \
            one("wd").contiguous()
    ffn_bytes = 3 * d * (2 * k16 + k8 + k4 / 2) + 3 * 4 * (k8 + k4)
    # kernel A on the CUDA cores; kernel B on the bf16 tensor cores
    for name, R, M, mma in (("qmatmul_gemv_bf16_b1", 1, 1, False),
                            ("qmatmul_gemv_bf16_rows", 4, 1, False),
                            ("qmatmul_mma_bf16_m512", 1, 512, True),
                            ("qmatmul_mma_bf16_rows", 4, 16, True),
                            ("qmatmul_mma_bf16_m8704", 1, 8704, True)):
        per_row = R > 1
        measure = M > 512       # a measurement row: no fp32 form
        x = torch.randn(R, M, d, generator=g, device=dev).to(bf)
        sets = torch.stack([torch.randperm(f, generator=g, device=dev)[:k]
                            for _ in range(R)]).to(torch.int32)
        idx = sets if per_row else sets[0]
        held = {}
        with held_to_plain(name, held):
            y = ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)
        require(y.dtype == bf and bool(torch.isfinite(y.float()).all()),
                f"{name}: the FFN's output {y.dtype}")
        ws = [gathered(s) for s in sets]

        def lib():
            for r, (wg, wu, wd) in enumerate(ws):
                (act(x[r] @ wg) * (x[r] @ wu)) @ wd
        fp32_form = None
        if not measure:
            xf = x.float()
            fp32_banks = {n: (t.float() if t.dtype == bf else t)
                          for n, t in banks.items()}

            def fp32_form():
                return ops.mp_ffn(xf, fp32_banks, idx, sizes, cfg.ffn_act)
        row = kernel_row(
            lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act),
            lambda: ref.mp_ffn_gathered_ref(x, banks, idx, sizes,
                                            cfg.ffn_act),
            lib, R * (ffn_bytes + 2 * M * d * 2), R * 2 * M * d * 3 * k,
            peak=H100_SXM.flops_bf16, tf32_products=None,
            issued_bf16=ffn_bf16_issued(R, M, d, k16, k8, k4, dev) if mma
            else None,
            fp32_form=fp32_form, plain_reps=3 if measure else 10)
        fp32_form = xf = fp32_banks = ws = None      # free them
        # kernel A's rows: the fused GLU, then the down products
        kernels = {"qmatmul_mma"} if mma else {"qmm_glu", "qmatmul_gemv"}
        require(set(held) == kernels, f"{name}: kernels held {set(held)}")
        row.update(max_abs_err=max(e["max_abs_err"] for kernel in kernels
                                   for e in held[kernel].values()),
                   calls_held=sum(e["calls"] for kernel in kernels
                                  for e in held[kernel].values()),
                   shape=f"x ({R}, {M}, {d}) bf16, tiers "
                         f"{k16}/{k8}/{k4} of {f}")
        rows[name] = row
        log({"phase": "kernels_bf16", "row": name, **row})

    # the fused GLU alone: one layer's launch (its three tiers) at M = 1
    x = torch.randn(1, 1, d, generator=g, device=dev).to(bf)
    idx = torch.randperm(f, generator=g, device=dev)[:k].to(torch.int32)
    tiers = glu_tiers(banks, idx[None], sizes)
    wg, wu, _ = gathered(idx)

    def glu_run():
        return qmatmul.glu_bf16(x[0], tiers, act=cfg.ffn_act)
    glu_bits = glu_check("qmm_glu_bf16", x, tiers, cfg.ffn_act)
    row = kernel_row(
        glu_run,
        lambda: ref.qmm_glu_ref(x[0], tiers, act_name=cfg.ffn_act),
        lambda: act(x[0] @ wg) * (x[0] @ wu),
        2 * d * (2 * k16 + k8 + k4 / 2) + 2 * 4 * (k8 + k4) + 2 * d + 6 * k,
        2 * 2 * d * k, peak=H100_SXM.flops_bf16, tf32_products=None,
        plain_reps=10)
    row.update(max_abs_err=glu_bits["max_abs_err"], bits=glu_bits,
               shape=f"x (1, 1, {d}) bf16, gate and up of tiers "
                     f"{k16}/{k8}/{k4} of {f}, {cfg.ffn_act}")
    rows["qmm_glu_bf16"] = row
    log({"phase": "kernels_bf16", "row": "qmm_glu_bf16", **row})
    del wg, wu
    # h bit-equal to the PyTorch composition for every activation, here
    # and at recurrentgemma-2b's widths (d = 2560, f = 7680)
    glu_acts = {d: {a: glu_check(f"glu_bits d={d} {a}", x, tiers, a)
                    for a in qmatmul.GLU_ACTS}}
    del banks, tiers
    torch.cuda.empty_cache()
    cfg2 = get_config("recurrentgemma-2b")
    d2, f2 = cfg2.d_model, cfg2.d_ff
    sizes2 = tier_sizes(f2, cfg2)
    banks2 = to_neuron_major(build_neuron_banks(
        *(torch.randn(s, generator=g, device=dev).mul_(s[0] ** -0.5).to(bf)
          for s in ((d2, f2), (d2, f2), (f2, d2)))))
    x2 = torch.randn(4, 1, d2, generator=g, device=dev).to(bf)
    idx2 = torch.stack([torch.randperm(f2, generator=g, device=dev)[
        :sizes2["k"]] for _ in range(4)]).to(torch.int32)
    tiers2 = glu_tiers(banks2, idx2, sizes2)
    glu_acts[d2] = {a: glu_check(f"glu_bits d={d2} {a}", x2, tiers2, a)
                    for a in qmatmul.GLU_ACTS}
    log({"phase": "kernels_bf16", "glu_bits": glu_acts})
    for dd, by_act in glu_acts.items():
        for a, r in by_act.items():
            require(r["h_differs"] == 0, f"glu_bits d={dd} {a}: {r}")
    del banks2, tiers2
    torch.cuda.empty_cache()

    def decode(name, B, S, lengths, ring):
        hkv, G, D = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.head_dim
        q = torch.randn(B, hkv, G, D, generator=g, device=dev).to(bf)
        kk = torch.randn(B, S, hkv, D, generator=g, device=dev).to(bf)
        vv = torch.randn(B, S, hkv, D, generator=g, device=dev).to(bf)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        slot = torch.arange(S, dtype=torch.int32, device=dev)[None]
        if ring:      # slot s holds the latest position = s mod S
            slots = (ln[:, None] - torch.remainder(ln[:, None] - slot, S))
        else:
            slots = slot.repeat(B, 1)
        slots = slots.to(torch.int32).contiguous()
        held = {}
        with held_to_plain(name, held):
            ops.flash_decode(q, kk, vv, slots, ln)
        valid = (slots >= 0) & (slots <= ln[:, None])
        mask = valid[:, None, None, :]
        qs = q.reshape(B, hkv * G, 1, D)
        qf, kf, vf = q.float(), kk.float(), vv.float()
        n_valid = int(valid.sum())
        row = kernel_row(
            lambda: ops.flash_decode(q, kk, vv, slots, ln),
            lambda: ref.flash_decode_ref(q, kk, vv, slots, ln),
            lambda: F.scaled_dot_product_attention(
                qs, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
                enable_gqa=True),
            q.numel() * 2 + 2 * n_valid * hkv * D * 2 + slots.numel() * 4
            + q.numel() * 4, 4 * n_valid * hkv * G * D,
            peak=H100_SXM.flops_bf16, tf32_products=None,
            fp32_form=lambda: ops.flash_decode(qf, kf, vf, slots, ln),
            plain_reps=10)
        # the fp32 form on the widened inputs: the same function, its sums
        # in another order (the bf16 form's products are MMAs)
        fp32_out = ops.flash_decode(qf, kf, vf, slots, ln)
        fp32_err = max_err(ops.flash_decode(q, kk, vv, slots, ln), fp32_out)
        fp32_tol = 1e-5 * max(1.0, float(fp32_out.abs().max()))
        require(fp32_err <= fp32_tol, f"{name}: {fp32_err:.3g} from the fp32 "
                                      f"form on the widened inputs")
        row.update(max_abs_err=held["flash_decode"][next(iter(
            held["flash_decode"]))]["max_abs_err"],
                   max_abs_err_fp32_form=fp32_err,
                   shape=f"q {tuple(q.shape)}, kv {tuple(kk.shape)} bf16"
                         + (", wrapped ring" if ring else ""))
        rows[name] = row
        log({"phase": "kernels_bf16", "row": name, **row})
    decode("flash_decode_bf16_ring_8k", 1, 8192, [8719], True)
    decode("flash_decode_bf16", 4, 145, [128, 133, 138, 143], False)

    hq, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for name, B, S, sbuf, pos0 in (("flash_attention_bf16", 4, 128, 128,
                                    None),
                                   ("chunk_attention_bf16", 4, 16, 256,
                                    [0, 48, 96, 112]),
                                   ("flash_attention_bf16_2k", 1, 2048, 2048,
                                    None)):
        q = torch.randn(B, S, hq, D, generator=g, device=dev).to(bf)
        kk = torch.randn(B, sbuf, hkv, D, generator=g, device=dev).to(bf)
        vv = torch.randn(B, sbuf, hkv, D, generator=g, device=dev).to(bf)
        qf, kf, vf = q.float(), kk.float(), vv.float()
        held = {}
        if pos0 is None:
            pos = torch.arange(S, device=dev)[None].repeat(B, 1)
            run = lambda: ops.prefill_attention(q, kk, vv, pos)  # noqa: E731
            fp32 = lambda: ops.prefill_attention(qf, kf, vf, pos)  # noqa: E731
            plain = lambda: ref.flash_attention_ref(q, kk, vv)  # noqa: E731
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                is_causal=True, enable_gqa=True)
            pairs = B * S * (S + 1) // 2
            nbytes = (q.numel() * 2 + 2 * kk.numel()) * 2
        else:
            p0 = torch.tensor(pos0, device=dev)
            pos = p0[:, None] + torch.arange(S, device=dev)[None]
            run = lambda: ops.chunk_attention(q, kk, vv, pos)  # noqa: E731
            fp32 = lambda: ops.chunk_attention(qf, kf, vf, pos)  # noqa: E731
            p32 = p0.to(torch.int32)
            plain = lambda: ref.chunk_attention_ref(  # noqa: E731
                q, kk, vv, p32)
            kv_pos = torch.arange(sbuf, device=dev)
            mask = (kv_pos[None, None, None, :] <= pos[:, None, :, None])
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
            fronts = [p + S for p in pos0]
            pairs = sum(p * S + S * (S + 1) // 2 for p in pos0)
            nbytes = q.numel() * 2 * 2 + 2 * sum(fronts) * hkv * D * 2
        with held_to_plain(name, held):
            run()
        kernel = "flash_attention" if pos0 is None else "chunk_attention"
        row = kernel_row(run, plain, lib, nbytes, 4 * pairs * hq * D,
                         peak=H100_SXM.flops_bf16, tf32_products=None,
                         issued_bf16=attention_bf16_issued(B, S, hq, D, pos0),
                         fp32_form=None if S > 128 else fp32, plain_reps=10)
        row.update(max_abs_err=held[kernel][next(iter(held[kernel]))][
            "max_abs_err"], shape=f"q {tuple(q.shape)}, kv "
            f"{tuple(kk.shape)} bf16" + ("" if pos0 is None else
                                         f", pos0 {pos0}"))
        rows[name] = row
        log({"phase": "kernels_bf16", "row": name, **row})
    return rows


def phase_bf16_tiny() -> tuple:
    """BF16_FAMILIES, each tiny at bf16 (random weights from seed 0, the
    predictor or router drawn), through forward on cuda against cpu from
    the same weights, the card replaying the CPU's active sets: a prompt of
    2 x 16 tokens (internvl2-1b behind a 4-frame bf16 prefix), then 4
    decode steps fed the CPU's greedy tokens; on the card every kernel call
    held against its plain version (held_to_plain), the bf16 kernel forms
    only (every launch bf16), each of the family's kernels launched; the
    logits within the family's BF16_TINY_TOL x max(1, max|cpu logits|),
    greedy tokens equal where the CPU's top-2 margin is wider. Returns
    ({"<arch>/bf16": launches}, the held kernels' largest errors)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    bf = torch.bfloat16
    out, failed, errors = {}, [], {}
    for arch in BF16_FAMILIES:
        cfg = get_config(arch, tiny=True)
        params = T.init_params(cfg, seed=0, dtype=bf, device="cpu")
        draw_pred_a(params, torch.Generator().manual_seed(1), "cpu")
        rng = torch.Generator().manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=rng)
        prefix = None
        if cfg.num_prefix_embeddings:
            prefix = torch.randn(2, 4, cfg.d_model, generator=rng).to(bf)
        n_pre = 0 if prefix is None else 4
        steps, sets, held = {}, [], {}
        for name in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(name), params)
            chosen = active_sets(sets, replay=name == "cuda")
            chosen.__enter__()
            checked = held_to_plain(f"bf16_tiny {arch}", held) \
                if name == "cuda" else contextlib.nullcontext()
            checked.__enter__()
            cache = T.init_cache(cfg, 2, 32 + n_pre, dtype=bf, device=name)
            reset_counts()
            reset_bf16_counts()
            logits, cache, _ = T.forward(
                cfg, p, tokens.to(name), cache=cache, mode="prefill",
                prefix=None if prefix is None else prefix.to(name))
            got = [logits[:, -1].float().cpu()]
            for i in range(4):
                nxt = (steps["cpu"][i] if name == "cuda" else got[-1]).argmax(
                    -1)[:, None]
                logits, cache, _ = T.forward(cfg, p, nxt.to(name),
                                             cache=cache, mode="decode")
                got.append(logits[:, -1].float().cpu())
            checked.__exit__(None, None, None)
            chosen.__exit__(None, None, None)
            steps[name] = got
        counts, bf16 = read_counts(), bf16_counts()
        errs, tols, sure_eq = [], [], True
        for c, gcu in zip(steps["cpu"], steps["cuda"]):
            errs.append(float((c - gcu).abs().max()))
            tols.append(BF16_TINY_TOL[arch] * max(1.0,
                                                  float(c.abs().max())))
            top2 = c.topk(2, -1).values
            sure = top2[:, 0] - top2[:, 1] > tols[-1]
            sure_eq &= bool(torch.equal(c.argmax(-1)[sure],
                                        gcu.argmax(-1)[sure]))
        want = set()
        if cfg.family != "ssm":
            want |= {"flash_attention", "flash_decode"}
        if any("banks" in layer.get("ffn", {}) for layer in params["layers"]):
            # the decode steps' FFN: the fused GLU and the down products
            want |= {"qmatmul", "qmm_glu"}
        ran = {n for n in ("qmatmul", "qmm_glu", "flash_decode",
                           "flash_attention", "chunk_attention") if counts[n]}
        log({"phase": "bf16_tiny", "arch": arch,
             "tol_rel": BF16_TINY_TOL[arch], "max_abs_err_by_step": errs,
             "tol_by_step": tols, "greedy_equal_where_sure": sure_eq,
             "held_to_plain": held, "kernel_tol_rel": 1e-5,
             "launches": counts, "launches_bf16": bf16})
        calls = {n: sum(e["calls"] for e in held.get(n, {}).values())
                 for n in ("qmatmul_gemv", "qmatmul_mma", "qmm_glu",
                           "flash_decode", "flash_attention",
                           "chunk_attention")}
        if any(calls[n] != counts[n] for n in calls):
            failed.append(f"{arch}: calls held {calls}, launches {counts}")
        for n, by_key in held.items():
            errors[n] = max([errors.get(n, 0.0)] + [
                e["max_abs_err"] for e in by_key.values()])
        if not all(e <= t for e, t in zip(errs, tols)) or not sure_eq:
            failed.append(f"{arch}: cuda against cpu {errs}, tolerances "
                          f"{tols}, tokens equal where sure: {sure_eq}")
        if ran != want:
            failed.append(f"{arch}: kernels {ran}, want {want}")
        if not all(bf16[n] == counts[n] for n in bf16):
            failed.append(f"{arch}: fp32 launches in a bf16 run: {counts} "
                          f"against {bf16}")
        out[f"{arch}/bf16"] = {**counts, **{f"{n}_bf16": c
                                            for n, c in bf16.items()}}
    require(not failed, "bf16_tiny: " + "; ".join(failed))
    return out, errors


def phase_mesh_bf16_full() -> dict:
    """build_case(MESH_ARCH, "long_500k", mesh=make_host_mesh(), variant,
    dtype=bf16) at all 48 layers and full width, for variant "m2" (about 45
    GB: the bf16 fp tier, int8 and int4 banks, the predictor drawn) and then
    "dense" (about 30 GB): the window's 8192-slot ring at MESH_START, its
    K/V seeded normal values, MESH_STEPS serve steps. Per step the bf16
    launches of qmatmul (m2: the 3 down products a layer), the fused GLU
    (m2: 1 a layer) and flash_decode (48), and flash_decode's device ms a
    launch; the first
    step's kernel calls held against their plain versions (held_to_plain),
    and its logits against the same step through the plain versions on the
    card within MESH_BF16_TOL x max(1, max|plain|); the bf16 dry-run
    record's argument_gb equal to the real tensors' bytes, and a step's
    median device ms at least MESH_BOUND_SHARE x its roofline bound.
    Returns ({"mesh_bf16_m2": launches, "mesh_bf16_dense": launches},
    the held kernels' largest errors)."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, release_mesh
    from repro_torch.launch.steps import build_case
    from repro_torch.models import transformer as T
    bf = torch.bfloat16
    cfg = get_config(MESH_ARCH)
    paths, errors = {}, {}
    for variant in ("m2", "dense"):
        t_phase = time.perf_counter()
        rec = dryrun.run_one(MESH_ARCH, "long_500k", mesh="host",
                             variant=variant, dtype=bf, verbose=False)
        require(rec["status"] == "ok", f"mesh_bf16_full: the dry run of "
                f"{variant} is {rec['status']}")
        r = rec["roofline"]
        bound_ms = max(r["compute_s"], r["memory_s"]) * 1e3
        mesh = make_host_mesh()
        held, launches, per_step = {}, {}, []
        try:
            case = build_case(MESH_ARCH, "long_500k", mesh=mesh,
                              variant=variant, dtype=bf)
            torch.cuda.reset_peak_memory_stats()
            t_init = time.perf_counter()
            params = T.init_params(cfg, seed=0, device="cuda", dtype=bf,
                                   m2=variant == "m2")
            if variant == "m2":
                draw_pred_a(params, torch.Generator(device="cuda")
                            .manual_seed(1), "cuda")
            cache = T.init_cache(cfg, 1, INPUT_SHAPES["long_500k"].seq_len,
                                 window=case.meta["window"], dtype=bf,
                                 device="cuda")
            cache["pos"] = MESH_START
            gen = torch.Generator(device="cuda").manual_seed(MESH_CACHE_SEED)
            for t in _leaves(cache):
                if isinstance(t, torch.Tensor):
                    t.normal_(generator=gen)
            init_s = time.perf_counter() - t_init
            require(_shapes(params) == _shapes(case.args[0])
                    and _shapes(cache) == _shapes(case.args[1]),
                    "mesh_bf16_full: the real params or cache are not the "
                    "case's")
            tok = torch.full((1, 1), 17, dtype=torch.int32, device="cuda")
            real_bytes = _tensor_bytes(params) + _tensor_bytes(cache) \
                + _tensor_bytes(tok)
            arg_bytes = rec["memory"]["argument_gb"] * 2 ** 30
            # the first step through the plain versions, from a copy of the
            # cache, left free and with the kernels' active sets (recorded
            # in the kernels' step below, so run after it)
            saved = [t.clone() for t in _leaves(cache)
                     if isinstance(t, torch.Tensor)]

            def restore():
                for t, s in zip([t for t in _leaves(cache)
                                 if isinstance(t, torch.Tensor)], saved):
                    t.copy_(s)
                cache["pos"] = MESH_START
            with plain_on_card():
                free_logits, _ = case.fn(params, cache, {"tokens": tok})
            restore()
            sets = []
            walls, toks = [], []
            for i in range(MESH_STEPS):
                step_held = held_to_plain("mesh_bf16_full", held) if i == 0 \
                    else contextlib.nullcontext()
                step_sets = active_sets(sets, False) if i == 0 \
                    else contextlib.nullcontext()
                with step_held, step_sets:
                    torch.cuda.synchronize()
                    reset_counts()
                    reset_bf16_counts()
                    t0 = time.perf_counter()
                    logits, cache = case.fn(params, cache, {"tokens": tok})
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                if i == 0:
                    first = logits.float()
                    after = [t.clone() for t in _leaves(cache)
                             if isinstance(t, torch.Tensor)]
                    restore()
                    with plain_on_card(), active_sets(sets, True):
                        plain_logits, _ = case.fn(params, cache,
                                                  {"tokens": tok})
                    for t, s in zip([t for t in _leaves(cache)
                                     if isinstance(t, torch.Tensor)], after):
                        t.copy_(s)
                    cache["pos"] = MESH_START + 1
                    del after
                counts, bf16 = read_counts(), bf16_counts()
                per_step.append({"qmatmul": bf16["qmatmul"],
                                 "qmm_glu": bf16["qmm_glu"],
                                 "flash_decode": bf16["flash_decode"]})
                require(all(bf16[n] == counts[n] for n in bf16),
                        f"mesh_bf16_full: fp32 launches in a bf16 step "
                        f"{counts}")
                for n, c in counts.items():
                    launches[n] = launches.get(n, 0) + c
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
                toks.append(int(tok))
            del saved
            finite = bool(torch.isfinite(logits.float()).all())
            logit_err = max_err(first, plain_logits)
            free_err = max_err(first, free_logits)
            logit_tol = MESH_BF16_TOL * max(
                1.0, float(plain_logits.float().abs().max()))
            same_token = int(first.argmax()) == int(plain_logits.argmax())

            def step():
                cache["pos"] = MESH_START
                case.fn(params, cache, {"tokens": tok})
            profiles = [device_profile(step, reps=1,
                                       sum_of=("flash_decode",))
                        for _ in range(5)]
            dev = [p["device_ms"] for p in profiles
                   if isinstance(p.get("device_ms"), float)]
            dev_ms = statistics.median(dev) if dev else "not measured"
            # flash_decode's device ms a launch: its kernels' time in each
            # session over the step's launches, the median
            decode_ms = statistics.median(
                p["sum_ms"]["flash_decode"] / cfg.num_layers
                for p in profiles if "sum_ms" in p) if dev else "not measured"
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            del params, cache, logits, plain_logits, free_logits, first
        finally:
            release_mesh()
        torch.cuda.empty_cache()
        ratio = dev_ms / bound_ms if dev else "not measured"
        label = f"mesh_bf16_{variant}"
        log({"phase": "mesh_bf16_full", "variant": variant, "config":
             cfg.name, "layers": cfg.num_layers, "case": case.name,
             "meta": case.meta, "start_pos": MESH_START, "steps": MESH_STEPS,
             "bf16_launches_by_step": per_step, "held_to_plain": held,
             "kernel_tol_rel": 1e-5, "first_logits_max_abs_err": logit_err,
             "first_logits_tol": logit_tol, "first_token_equal": same_token,
             "first_logits_max_abs_err_free_sets": free_err,
             "active_sets_replayed": len(sets),
             "argument_bytes_record": arg_bytes,
             "argument_bytes_real": real_bytes, "init_s": init_s,
             "step_wall_ms_median": statistics.median(walls[1:]) * 1e3,
             "step_device_ms_median": dev_ms, "step_device_ms_sessions": dev,
             "busy_share": [p.get("busy_share") for p in profiles],
             "kernels_per_step": profiles[-1].get("kernels_per_call"),
             "top_kernels_ms": profiles[-1].get("top_kernels_ms"),
             "flash_decode_ms_per_launch": decode_ms,
             "roofline_bound_ms": bound_ms,
             "roofline_bottleneck": r["bottleneck"],
             "device_ms_over_bound": ratio,
             "max_memory_allocated_gib": peak_gb,
             "record_memory": rec["memory"], "tokens": toks,
             "launches": launches,
             "seconds": time.perf_counter() - t_phase})
        require(finite, f"{label}: non-finite logits")
        # m2 a layer: one fused GLU and the tiers' down products
        want = {"qmatmul": 3 * cfg.num_layers if variant == "m2" else 0,
                "qmm_glu": cfg.num_layers if variant == "m2" else 0,
                "flash_decode": cfg.num_layers}
        require(all(s == want for s in per_step),
                f"{label}: bf16 launches by step {per_step}, want {want}")
        require(arg_bytes == real_bytes, f"{label}: the record's arguments "
                f"{arg_bytes} bytes, the real ones {real_bytes}")
        require(logit_err <= logit_tol, f"{label}: the first step's logits "
                f"{logit_err:.4g} from the plain versions', tol "
                f"{logit_tol:.4g}")
        require(isinstance(ratio, float) and ratio >= MESH_BOUND_SHARE,
                f"{label}: a step's device time {dev_ms} ms against the "
                f"roofline's {bound_ms:.4g} ms")
        paths[label] = launches
        for n, by_key in held.items():
            errors[n] = max([errors.get(n, 0.0)] + [
                e["max_abs_err"] for e in by_key.values()])
    return paths, errors


def phase_moe_bf16_full(B: int, P: int, gen_len: int) -> dict:
    """llama4-maverick at full width, depth 48 -> MOE_BF16_LAYERS, bf16
    weights (the router drawn): ``forward`` with full's traffic (batch B,
    prompt P, gen_len new tokens), device ms a step (CUDA events around the
    synchronised step) and the bf16 attention kernels' launches; the
    weights dropped after. Returns {"llama4/bf16_full": launches}."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    bf = torch.bfloat16
    arch = "llama4-maverick-400b-a17b"
    cfg = dataclasses.replace(get_config(arch), num_layers=MOE_BF16_LAYERS)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, seed=0, dtype=bf, device="cuda")
    draw_pred_a(params, torch.Generator(device="cuda").manual_seed(1), "cuda")
    weights_gb = _tensor_bytes(params) / 1e9
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda")
    cache = T.init_cache(cfg, B, P + gen_len, dtype=bf, device="cuda")
    reset_counts()
    reset_bf16_counts()
    ms = []

    def timed_step(*a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = T.forward(cfg, params, *a, **kw)
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
        return out
    logits, cache, _ = timed_step(tokens, cache=cache, mode="prefill")
    for _ in range(gen_len - 1):
        nxt = logits[:, -1].argmax(-1)[:, None]
        logits, cache, _ = timed_step(nxt, cache=cache, mode="decode")
    finite = bool(torch.isfinite(logits.float()).all())
    counts, bf16 = read_counts(), bf16_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, cache, logits
    torch.cuda.empty_cache()
    log({"phase": "moe_bf16_full", "config": cfg.name, "layers":
         cfg.num_layers, "weights_gb": weights_gb, "batch": B, "prompt": P,
         "new_tokens": gen_len, "prefill_ms": ms[0],
         "decode_step_ms_median": statistics.median(ms[1:]),
         "decode_step_ms": ms[1:], "launches": counts, "launches_bf16": bf16,
         "max_memory_allocated_gib": peak_gb,
         "seconds": time.perf_counter() - t_phase})
    require(finite, "moe_bf16_full: non-finite logits")
    require(bf16["flash_attention"] == counts["flash_attention"] > 0
            and bf16["flash_decode"] == counts["flash_decode"] > 0
            and bf16["qmatmul"] == counts["qmatmul"],
            f"moe_bf16_full: launches {counts}, bf16 {bf16}")
    return {"llama4/bf16_full": {**counts, **{f"{n}_bf16": c
                                              for n, c in bf16.items()}}}


# ---------------------------------------------------------------------------


def main(only=None):
    """Every phase, the kernel table and the result line; ``only`` (a set
    of phase names) runs the device phase and those alone, then stops
    after the timing line, with no table and no result line."""
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no src/repro_torch: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    # the softcap rows' library call is compiled: its caches stay in build/
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    log({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0],
         "kernel_build_s": time.perf_counter() - t0,
         "ptxas": {n: [l.strip() for l in txt.splitlines()
                       if "registers" in l or "spill" in l]
                   for n, txt in build.build_log.items()}})
    B, P, gen_len = 4, 128, 16
    cfg = get_config("qwen2.5-14b")
    seconds = {"device": time.perf_counter() - t0}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out
    if only:
        dev = torch.device("cuda")
        calls = {"kernels_server": (phase_kernels_server, cfg, dev),
                 "kernels_audio": (phase_kernels_audio, dev),
                 "ssm_arch": (phase_ssm_arch, B, P, gen_len),
                 "audio_arch": (phase_audio_arch,),
                 "offline_tiny": (phase_offline_tiny,),
                 "ratio_search_full": (lambda: phase_ratio_search_full(
                     *full_model()[1:]),),
                 "train_full": (phase_train_full,),
                 "kernels_long": (phase_kernels_long, dev),
                 "steps_tiny": (phase_steps_tiny,),
                 "long_context_full": (lambda: phase_long_context_full(
                     *full_model()[1:]),),
                 "mesh_full": (phase_mesh_full,),
                 "kernels_bf16": (phase_kernels_bf16, cfg, dev),
                 "bf16_tiny": (phase_bf16_tiny,),
                 "mesh_bf16_full": (phase_mesh_bf16_full,),
                 "moe_bf16_full": (phase_moe_bf16_full, B, P, gen_len)}
        for name in only:
            timed(name, *calls[name])
        log({"phase": "timing", "seconds": seconds,
             "total_s": time.perf_counter() - t0})
        return
    kern = timed("kernels", phase_kernels, cfg, torch.device("cuda"), B, P,
                 gen_len)
    kern.update(timed("kernels_server", phase_kernels_server, cfg,
                      torch.device("cuda")))
    kern.update(timed("kernels_dense", phase_kernels_dense,
                      torch.device("cuda"), B, P, gen_len))
    kern.update(timed("kernels_moe", phase_kernels_moe,
                      torch.device("cuda"), B, P, gen_len))
    kern.update(timed("kernels_hybrid", phase_kernels_hybrid,
                      torch.device("cuda"), B, P, gen_len))
    kern.update(timed("kernels_audio", phase_kernels_audio,
                      torch.device("cuda")))
    kern.update(timed("kernels_long", phase_kernels_long,
                      torch.device("cuda")))
    kern.update(timed("kernels_bf16", phase_kernels_bf16, cfg,
                      torch.device("cuda")))
    timed("tiny", phase_tiny)
    timed("server_tiny", phase_server_tiny)
    timed("offline_tiny", phase_offline_tiny)
    timed("steps_tiny", phase_steps_tiny)
    full, full_cfg, params = timed("full_model", full_model)
    paths = {"serve_full": timed("full", phase_full, full, full_cfg, params,
                                 B, P, gen_len)[0]}
    paths["server_full"] = timed("server_full", phase_server_full, full,
                                 full_cfg, params)[0]
    for name, fn in (("server_obs_full", phase_server_obs_full),
                     ("cluster_full", phase_cluster_full),
                     ("divergence", phase_divergence)):
        paths[name] = timed(name, fn, full_cfg, params)
    paths["ratio_search_full"], held = timed(
        "ratio_search_full", phase_ratio_search_full, full_cfg, params)
    # the search's kernel calls, held against their plain versions at its
    # own shapes, count in the errors of the d = 5120 rows it launches
    for name, err in held.items():
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], err)
    long_paths, held = timed("long_context_full", phase_long_context_full,
                             full_cfg, params)
    paths.update(long_paths)
    for name, err in held.items():
        row = kern[LONG_ROWS[name]]
        row["max_abs_err"] = max(row["max_abs_err"], err)
    del params
    torch.cuda.empty_cache()
    timed("train_full", phase_train_full)
    torch.cuda.empty_cache()
    mesh_paths, held = timed("mesh_full", phase_mesh_full)
    paths.update(mesh_paths)
    for name, err in held.items():
        row = kern[LONG_ROWS[name]]
        row["max_abs_err"] = max(row["max_abs_err"], err)
    mesh_paths, held = timed("mesh_bf16_full", phase_mesh_bf16_full)
    paths.update(mesh_paths)
    for name, err in held.items():
        row = kern[BF16_MESH_ROWS[name]]
        row["max_abs_err"] = max(row["max_abs_err"], err)
    tiny_paths, held = timed("bf16_tiny", phase_bf16_tiny)
    paths.update(tiny_paths)
    for name, err in held.items():
        row = kern[BF16_TINY_ROWS[name]]
        row["max_abs_err"] = max(row["max_abs_err"], err)
    paths.update(timed("moe_bf16_full", phase_moe_bf16_full, B, P, gen_len))
    paths.update(timed("dense_archs", phase_dense_archs, B, P, gen_len))
    paths.update(timed("moe_archs", phase_moe_archs, B, P, gen_len))
    paths.update(timed("hybrid_arch", phase_hybrid_arch, B, P, gen_len))
    paths.update(timed("ssm_arch", phase_ssm_arch, B, P, gen_len))
    paths.update(timed("audio_arch", phase_audio_arch))
    timed("softcap_library", phase_softcap_library)
    log({"phase": "timing", "seconds": seconds,
         "total_s": time.perf_counter() - t0})

    # name -> (source, the TPU kernel it replaces, counter, paths that run
    # it); a dense config's launches count in the row of its own shape
    # where the table has one, else in the row of the same kernel and form
    k = "src/repro/kernels/"
    c = "src/repro_torch/csrc/"
    qwen32, cmdr, mistral, vl = DENSE_ARCHS
    grok = next(a for a, depth in MOE_ARCHS.items() if depth)
    hybrid = HYBRID_ARCH[0]
    audio = AUDIO_ARCH[0]
    server_paths = ("server_full", "server_obs_full", "cluster_full")
    dense_serve = tuple(f"{a}/serve" for a in (qwen32, cmdr, vl))
    dense_server = tuple(f"{a}/server" for a in (qwen32, cmdr, vl))
    decode_paths = ("serve_full",) + server_paths + ("divergence",
                                                     "ratio_search_full",
                                                     f"{qwen32}/serve",
                                                     f"{qwen32}/server")
    whole_paths = ("serve_full", "divergence", "ratio_search_full",
                   f"{qwen32}/serve", f"{cmdr}/serve")
    chunk_paths = server_paths + (f"{qwen32}/server", f"{cmdr}/server")
    bf16_tiny = tuple(f"{a}/bf16" for a in BF16_FAMILIES)
    rows = {
        "qmatmul_gemv": (c + "qmatmul.cu", k + "qmatmul.py:38",
                         "qmatmul_gemv", ("serve_full", "divergence",
                                          "ratio_search_full") + dense_serve),
        "qmatmul_mma": (c + "qmatmul.cu", k + "qmatmul.py:38",
                        "qmatmul_mma", ("serve_full", "divergence",
                                        "ratio_search_full") + dense_serve),
        "qmatmul_gemv_rows": (c + "qmatmul.cu", k + "qmatmul.py:38",
                              "qmatmul_gemv", server_paths + dense_server),
        "qmatmul_mma_rows": (c + "qmatmul.cu", k + "qmatmul.py:38",
                             "qmatmul_mma", server_paths + dense_server),
        "qmatmul_gemv_d12288": (c + "qmatmul.cu", k + "qmatmul.py:38",
                                "qmatmul_gemv", (f"{mistral}/serve",)),
        "qmatmul_mma_d12288": (c + "qmatmul.cu", k + "qmatmul.py:38",
                               "qmatmul_mma", (f"{mistral}/serve",)),
        "qmatmul_gemv_rows_d12288": (c + "qmatmul.cu", k + "qmatmul.py:38",
                                     "qmatmul_gemv", (f"{mistral}/server",)),
        "qmatmul_mma_rows_d12288": (c + "qmatmul.cu", k + "qmatmul.py:38",
                                    "qmatmul_mma", (f"{mistral}/server",)),
        "flash_decode": (c + "flash_decode.cu", k + "flash_decode.py:26",
                         "flash_decode", decode_paths),
        # the same kernel over a server decode batch, and at 4 K and 32 K
        # slots: its launches are those of the row above
        "flash_decode_rows": (c + "flash_decode.cu", k + "flash_decode.py:26",
                              "flash_decode", server_paths),
        "flash_decode_long": (c + "flash_decode.cu", k + "flash_decode.py:26",
                              "flash_decode", decode_paths),
        "flash_decode_32k": (c + "flash_decode.cu", k + "flash_decode.py:26",
                             "flash_decode", decode_paths),
        # G = 12 in two head groups, G = 7 at D = 64, G = 8
        "flash_decode_g12": (c + "flash_decode.cu", k + "flash_decode.py:26",
                             "flash_decode", (f"{mistral}/serve",
                                              f"{mistral}/server")),
        "flash_decode_rows_g12": (c + "flash_decode.cu",
                                  k + "flash_decode.py:26", "flash_decode",
                                  (f"{mistral}/server",)),
        "flash_decode_g7": (c + "flash_decode.cu", k + "flash_decode.py:26",
                            "flash_decode", (f"{vl}/serve", f"{vl}/server")),
        "flash_decode_g8": (c + "flash_decode.cu", k + "flash_decode.py:26",
                            "flash_decode", (f"{cmdr}/serve",
                                             f"{cmdr}/server")),
        "flash_attention": (c + "flash_attention.cu",
                            k + "flash_attention.py:26", "flash_attention",
                            whole_paths),
        "chunk_attention": (c + "flash_attention.cu",
                            k + "flash_attention.py:26", "chunk_attention",
                            chunk_paths),
        "flash_attention_g12": (c + "flash_attention.cu",
                                k + "flash_attention.py:26",
                                "flash_attention", (f"{mistral}/serve",)),
        "flash_attention_g7": (c + "flash_attention.cu",
                               k + "flash_attention.py:26",
                               "flash_attention", (f"{vl}/serve",)),
        "chunk_attention_g12": (c + "flash_attention.cu",
                                k + "flash_attention.py:26",
                                "chunk_attention", (f"{mistral}/server",)),
        "chunk_attention_g7": (c + "flash_attention.cu",
                               k + "flash_attention.py:26",
                               "chunk_attention", (f"{vl}/server",)),
        # the two forms at a 2048-token prompt: the same kernels, whose
        # launches are those of the rows above
        "flash_attention_long": (c + "flash_attention.cu",
                                 k + "flash_attention.py:26",
                                 "flash_attention", whole_paths),
        "chunk_attention_long": (c + "flash_attention.cu",
                                 k + "flash_attention.py:26",
                                 "chunk_attention", chunk_paths),
        # the softcap forms at grok-1-314b's shapes (G = 6): their launches
        # are grok's paths' (and its server's decode batch shares the row)
        "flash_decode_softcap": (c + "flash_decode.cu",
                                 k + "flash_decode.py:26",
                                 "flash_decode_softcap",
                                 (f"{grok}/serve", f"{grok}/server")),
        "flash_decode_rows_softcap": (c + "flash_decode.cu",
                                      k + "flash_decode.py:26",
                                      "flash_decode_softcap",
                                      (f"{grok}/server",)),
        "flash_attention_softcap": (c + "flash_attention.cu",
                                    k + "flash_attention.py:26",
                                    "flash_attention_softcap",
                                    (f"{grok}/serve",)),
        "chunk_attention_softcap": (c + "flash_attention.cu",
                                    k + "flash_attention.py:26",
                                    "chunk_attention_softcap",
                                    (f"{grok}/server",)),
        # head dim 256 (recurrentgemma-2b): the serve step and the server's
        # decode batch share the first row, the ring run the second
        "flash_decode_d256": (c + "flash_decode.cu", k + "flash_decode.py:26",
                              "flash_decode", (f"{hybrid}/serve",
                                               f"{hybrid}/server")),
        "flash_decode_ring_d256": (c + "flash_decode.cu",
                                   k + "flash_decode.py:26", "flash_decode",
                                   (f"{hybrid}/ring",)),
        "flash_attention_d256": (c + "flash_attention.cu",
                                 k + "flash_attention.py:26",
                                 "flash_attention", (f"{hybrid}/serve",
                                                     f"{hybrid}/server")),
        "flash_attention_window_d256": (c + "flash_attention.cu",
                                        k + "flash_attention.py:26",
                                        "flash_attention", (f"{hybrid}/ring",)),
        "qmatmul_gemv_d2560": (c + "qmatmul.cu", k + "qmatmul.py:38",
                               "qmatmul_gemv", (f"{hybrid}/serve",
                                                f"{hybrid}/ring",
                                                f"{hybrid}/server")),
        "qmatmul_mma_d2560": (c + "qmatmul.cu", k + "qmatmul.py:38",
                              "qmatmul_mma", (f"{hybrid}/serve",
                                              f"{hybrid}/ring",
                                              f"{hybrid}/server")),
        # G = 1 (multi-head attention, D = 64) and the FFN at d = 2048
        # (musicgen-large, through forward)
        "flash_decode_g1": (c + "flash_decode.cu", k + "flash_decode.py:26",
                            "flash_decode", (f"{audio}/forward",)),
        "flash_attention_g1": (c + "flash_attention.cu",
                               k + "flash_attention.py:26", "flash_attention",
                               (f"{audio}/forward",)),
        "qmatmul_gemv_d2048": (c + "qmatmul.cu", k + "qmatmul.py:38",
                               "qmatmul_gemv", (f"{audio}/forward",)),
        "qmatmul_mma_d2048": (c + "qmatmul.cu", k + "qmatmul.py:38",
                              "qmatmul_mma", (f"{audio}/forward",)),
        # long_500k's window override at full width (qwen2.5-14b, one
        # row): the whole prompt of 8704 tokens within the 8192 window, the
        # ring's decode, the FFN at M = 1 and 8704; and a decode step over
        # int8 K/V at 8 x 32768 slots (measurement: the launches are those
        # of the ring row)
        "flash_attention_window_8k": (c + "flash_attention.cu",
                                      k + "flash_attention.py:26",
                                      "flash_attention", ("long_context",)),
        "flash_decode_ring_8k": (c + "flash_decode.cu",
                                 k + "flash_decode.py:26", "flash_decode",
                                 ("long_context", "mesh_full")),
        "qmatmul_gemv_b1": (c + "qmatmul.cu", k + "qmatmul.py:38",
                            "qmatmul_gemv", ("long_context",)),
        "qmatmul_mma_m8704": (c + "qmatmul.cu", k + "qmatmul.py:38",
                              "qmatmul_mma", ("long_context",)),
        "flash_decode_int8_32k": (c + "flash_decode.cu",
                                  k + "flash_decode.py:26", "flash_decode",
                                  ("long_context",)),
        "atu_update": (c + "atu_update.cu", k + "atu_update.py:24",
                       "atu_update", ()),
        "atu_update_int8": (c + "atu_update.cu", k + "atu_update.py:24",
                            "atu_update", ()),
        "atu_update_int8_fp32": (c + "atu_update.cu", k + "atu_update.py:24",
                                 "atu_update", ()),
        "mp_glu_ffn": (c + "qmatmul.cu", k + "ops.py:54", None, ()),
        # the bf16 forms (bf16 in, fp32 inside): qwen2.5-14b's m2 long_500k
        # step at 48 layers, the families tiny at bf16, llama4 at full width
        "qmatmul_gemv_bf16_b1": (c + "qmatmul_bf16.cu", k + "qmatmul.py:38",
                                 "qmatmul_gemv", ("mesh_bf16_m2",)
                                 + bf16_tiny),
        # the fused GLU of the bf16 FFN at small M (its down products count
        # in the row above, kernel A's row form)
        "qmm_glu_bf16": (c + "qmatmul_bf16.cu", k + "qmatmul.py:38",
                         "qmm_glu", ("mesh_bf16_m2",) + bf16_tiny),
        "qmatmul_gemv_bf16_rows": (c + "qmatmul_bf16.cu",
                                   k + "qmatmul.py:38",
                                   "qmatmul_gemv", ()),
        "qmatmul_mma_bf16_m512": (c + "qmatmul_bf16.cu",
                                  k + "qmatmul.py:38",
                                  "qmatmul_mma", bf16_tiny),
        "qmatmul_mma_bf16_rows": (c + "qmatmul_bf16.cu",
                                  k + "qmatmul.py:38",
                                  "qmatmul_mma", ()),
        # measurement: kernel B at long_500k's prefill M (its launches are
        # those of the M = 512 row)
        "qmatmul_mma_bf16_m8704": (c + "qmatmul_bf16.cu",
                                   k + "qmatmul.py:38",
                                   "qmatmul_mma", bf16_tiny),
        "flash_decode_bf16_ring_8k": (c + "flash_decode_bf16.cu",
                                      k + "flash_decode.py:26",
                                      "flash_decode", ("mesh_bf16_m2",
                                                       "mesh_bf16_dense")),
        "flash_decode_bf16": (c + "flash_decode_bf16.cu",
                              k + "flash_decode.py:26",
                              "flash_decode", bf16_tiny
                              + ("llama4/bf16_full",)),
        "flash_attention_bf16": (c + "flash_attention_bf16.cu",
                                 k + "flash_attention.py:26",
                                 "flash_attention", bf16_tiny
                                 + ("llama4/bf16_full",)),
        "chunk_attention_bf16": (c + "flash_attention_bf16.cu",
                                 k + "flash_attention.py:26",
                                 "chunk_attention", ()),
        # measurement: the whole prompt at 2048 tokens (the launches are
        # those of the row above)
        "flash_attention_bf16_2k": (c + "flash_attention_bf16.cu",
                                    k + "flash_attention.py:26",
                                    "flash_attention", bf16_tiny
                                    + ("llama4/bf16_full",)),
    }
    table = []
    for name, (src, replaces, counter, on) in rows.items():
        kk = kern[name]
        by_path = {p: paths[p][counter] for p in on}
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": kk["max_abs_err"], "ms": kk["ms"],
            "plain_ms": kk["plain_ms"], "bound_ms": kk["bound_ms"],
            "bound_by": kk["bound_by"], "library_ms": kk["library_ms"],
            "device_ms": kk["profile"].get("device_ms"),
            "library_device_ms": None if kk["library_ms"] is None else
            kk.get("library_device_ms", kk.get("library_profile", {}).get(
                "device_ms", "not measured")),
            **({"library_graph_ms": kk["library_graph_ms"]}
               if "library_graph_ms" in kk else {}),
            **{key: kk[key] for key in ("gemv_device_ms", "mma_device_ms",
                                        "bound_tf32_ms", "bound_tf32_by",
                                        "bound_issued_ms", "bound_issued_by",
                                        "uncapped_device_ms",
                                        "sdpa_uncapped_ms",
                                        "library_max_abs_err",
                                        "dequantize_ms", "flash_decode_ms",
                                        "bound_fp32_kv_ms",
                                        "sdpa_dequantized_ms",
                                        "fp32_form_ms", "shape")
               if key in kk}})
    print(nvidia_smi(), flush=True)
    log({"kernels": table})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--softcap-library"]:
        log(softcap_library(sys.argv[2]))
    elif sys.argv[1:2] == ["--only"]:
        main(only=sys.argv[2].split(","))
    else:
        main()
