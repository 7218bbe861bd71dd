"""Arrival workloads for the serving subsystem.

``poisson_trace`` draws exponential inter-arrival gaps (the open-loop
"heavy traffic" model); ``bursty_trace`` clusters arrivals into bursts
separated by idle gaps (the flash-crowd model that makes scheduling
policies matter — under a burst the queue is deep and admission *order*
decides who meets their TTFT); ``closed_trace`` releases everything at
t=0 (the offline-batch model); ``shared_prefix_trace`` generates
chat-style conversations whose prompts share token-ID prefixes (system
prompts reused across requests, multi-turn histories re-sent every
turn) — the traffic that makes the radix prefix cache matter;
``diurnal_trace`` samples million-user-scale day-cycle traffic
(sinusoidal-rate Poisson arrivals + shared prefixes) for the cluster
router and its carbon autoscaler (``serving/cluster.py``). Traces
are plain event lists so recorded production traces can be replayed
through ``requests_from_trace`` unchanged. Events may carry an
``slo_class`` naming an entry of ``repro_torch.serving.request.SLO_CLASSES``;
``assign_slo_classes`` samples a mix over an existing trace. Events may
also carry explicit ``prompt_tokens`` (shared-prefix traces must pin
the actual token ids, not just lengths, for prefixes to collide). All
times are modeled-clock seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import SLO_CLASSES, ServingRequest


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    rid: int
    arrival_s: float
    prompt_len: int
    max_new_tokens: int
    slo_class: Optional[str] = None    # key into SLO_CLASSES, or None
    prompt_tokens: Optional[tuple] = None   # explicit token ids (prefix
                                            # workloads); len == prompt_len


def poisson_trace(n: int, rate_rps: float, *, seed: int = 0,
                  prompt_len: Tuple[int, int] = (16, 64),
                  gen_len: Tuple[int, int] = (16, 32)) -> List[ArrivalEvent]:
    rng = np.random.default_rng(seed)
    t = 0.0
    events = []
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate_rps))
        events.append(ArrivalEvent(
            rid=rid, arrival_s=t,
            prompt_len=int(rng.integers(prompt_len[0], prompt_len[1] + 1)),
            max_new_tokens=int(rng.integers(gen_len[0], gen_len[1] + 1))))
    return events


def bursty_trace(n: int, *, burst_size: int = 6, burst_gap_s: float = 30.0,
                 rate_in_burst_rps: float = 8.0, seed: int = 0,
                 prompt_len: Tuple[int, int] = (16, 64),
                 gen_len: Tuple[int, int] = (16, 32)) -> List[ArrivalEvent]:
    """Bursts of ``burst_size`` Poisson arrivals at ``rate_in_burst_rps``,
    separated by ``burst_gap_s`` of silence — queueing pressure inside the
    burst, slack between bursts (where a carbon policy can place work)."""
    rng = np.random.default_rng(seed)
    events = []
    t = 0.0
    rid = 0
    while rid < n:
        for _ in range(min(burst_size, n - rid)):
            t += float(rng.exponential(1.0 / rate_in_burst_rps))
            events.append(ArrivalEvent(
                rid=rid, arrival_s=t,
                prompt_len=int(rng.integers(prompt_len[0],
                                            prompt_len[1] + 1)),
                max_new_tokens=int(rng.integers(gen_len[0],
                                                gen_len[1] + 1))))
            rid += 1
        t += burst_gap_s
    return events


def closed_trace(n: int, *, prompt_len: int = 32,
                 gen_len: int = 32) -> List[ArrivalEvent]:
    return [ArrivalEvent(rid=i, arrival_s=0.0, prompt_len=prompt_len,
                         max_new_tokens=gen_len) for i in range(n)]


def shared_prefix_trace(n: int, *, rate_rps: float = 2.0,
                        num_groups: int = 4, prefix_len: int = 64,
                        reuse_ratio: float = 0.7, turns: int = 1,
                        think_time_s: float = 10.0,
                        suffix_len: Tuple[int, int] = (8, 24),
                        gen_len: Tuple[int, int] = (16, 32),
                        vocab_size: int = 50000,
                        seed: int = 0) -> List[ArrivalEvent]:
    """Chat traffic with realistic prefix reuse.

    Conversations arrive as a Poisson process at ``rate_rps``. With
    probability ``reuse_ratio`` a conversation opens with one of
    ``num_groups`` shared system prompts (``prefix_len`` tokens,
    deterministic per group — the "hot prefix" every chat product has);
    otherwise its prefix is unique. Each conversation runs ``turns``
    turns: turn *t*'s prompt is the full turn *t-1* prompt plus a
    simulated assistant response plus a fresh user suffix, arriving
    after an exponential think-time gap — so multi-turn requests re-send
    (and can reuse) their entire history, the second big sharing pattern
    prefix caches exploit. Events pin explicit ``prompt_tokens`` so
    prefixes actually collide byte-for-byte."""
    rng = np.random.default_rng(seed)
    group_prefix = [rng.integers(0, vocab_size, prefix_len).tolist()
                    for _ in range(num_groups)]
    events = []
    t, rid = 0.0, 0
    while rid < n:
        t += float(rng.exponential(1.0 / rate_rps))
        if rng.random() < reuse_ratio:
            hist = list(group_prefix[int(rng.integers(num_groups))])
        else:
            hist = rng.integers(0, vocab_size, prefix_len).tolist()
        arr = t
        for _ in range(turns):
            if rid >= n:
                break
            sfx = int(rng.integers(suffix_len[0], suffix_len[1] + 1))
            hist = hist + rng.integers(0, vocab_size, sfx).tolist()
            gl = int(rng.integers(gen_len[0], gen_len[1] + 1))
            events.append(ArrivalEvent(
                rid=rid, arrival_s=arr, prompt_len=len(hist),
                max_new_tokens=gl, prompt_tokens=tuple(hist)))
            rid += 1
            # next turn re-sends history + a simulated response
            hist = hist + rng.integers(0, vocab_size, gl).tolist()
            arr += float(rng.exponential(think_time_s))
    events.sort(key=lambda e: e.arrival_s)
    return [dataclasses.replace(e, rid=i) for i, e in enumerate(events)]


def diurnal_trace(n: int, *, period_s: float = 240.0,
                  mean_rps: Optional[float] = None,
                  peak_to_trough: float = 4.0, peak_at: float = 0.5,
                  num_groups: int = 8, prefix_len: int = 64,
                  reuse_ratio: float = 0.8,
                  suffix_len: Tuple[int, int] = (8, 24),
                  gen_len: Tuple[int, int] = (16, 32),
                  vocab_size: int = 50000,
                  seed: int = 0) -> List[ArrivalEvent]:
    """Diurnal shared-prefix traffic — the cluster router's workload.

    Arrivals are a nonhomogeneous Poisson process (thinning) whose rate
    follows a sinusoidal day cycle on the modeled clock: one period is
    ``period_s`` seconds (matching
    ``CarbonIntensityTrace.diurnal(period_s=...)``), the peak/trough
    rate ratio is ``peak_to_trough`` and the rate peaks at fraction
    ``peak_at`` of the period — 0.5 by default, i.e. traffic peaks
    half a day after the grid-intensity peak (midday solar trough), so
    by default the busy hours are the *clean* hours. ``mean_rps``
    defaults to ``n / period_s`` so the ``n`` sampled events span about
    one modeled day. Prompt structure matches
    :func:`shared_prefix_trace`: with probability ``reuse_ratio`` a
    prompt opens with one of ``num_groups`` deterministic shared system
    prompts, and explicit ``prompt_tokens`` are pinned so prefixes
    collide byte-for-byte.

    Scale semantics: this is a *statistical sample* of million-user
    traffic, not a literal replay. A fleet serving 1M users at ~10
    requests/user/day sees ~115 req/s of wall-clock traffic; with the
    repo's convention of one modeled day = ``period_s`` seconds that
    compresses to thousands of modeled req/s. Raise ``n``/``mean_rps``
    to densify the sample — the diurnal shape, the peak-to-trough
    ratio and the prefix-sharing structure (what routers and
    autoscalers actually react to) are preserved at any ``n``.
    """
    if peak_to_trough < 1.0:
        raise ValueError("peak_to_trough must be >= 1")
    rng = np.random.default_rng(seed)
    lam = mean_rps if mean_rps is not None else max(n / period_s, 1e-9)
    amp = (peak_to_trough - 1.0) / (peak_to_trough + 1.0)
    lam_max = lam * (1.0 + amp)
    group_prefix = [rng.integers(0, vocab_size, prefix_len).tolist()
                    for _ in range(num_groups)]
    events = []
    t, rid = 0.0, 0
    while rid < n:
        t += float(rng.exponential(1.0 / lam_max))
        rate = lam * (1.0 + amp * np.cos(
            2.0 * np.pi * (t / period_s - peak_at)))
        if rng.random() > rate / lam_max:        # thinning rejection
            continue
        if rng.random() < reuse_ratio:
            toks = list(group_prefix[int(rng.integers(num_groups))])
        else:
            toks = rng.integers(0, vocab_size, prefix_len).tolist()
        sfx = int(rng.integers(suffix_len[0], suffix_len[1] + 1))
        toks = toks + rng.integers(0, vocab_size, sfx).tolist()
        events.append(ArrivalEvent(
            rid=rid, arrival_s=t, prompt_len=len(toks),
            max_new_tokens=int(rng.integers(gen_len[0], gen_len[1] + 1)),
            prompt_tokens=tuple(toks)))
        rid += 1
    return events


def assign_slo_classes(events: Sequence[ArrivalEvent],
                       mix: Dict[str, float], *,
                       seed: int = 0) -> List[ArrivalEvent]:
    """Sample an SLO class per event from ``mix`` (class name -> weight;
    weights are normalised). Classes must exist in ``SLO_CLASSES``."""
    for name in mix:
        if name not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {name!r}")
    names = list(mix)
    w = np.asarray([mix[k] for k in names], dtype=float)
    w = w / w.sum()
    rng = np.random.default_rng(seed)
    return [dataclasses.replace(e, slo_class=str(rng.choice(names, p=w)))
            for e in events]


def requests_from_trace(events: Sequence[ArrivalEvent], *,
                        vocab_size: Optional[int] = None,
                        seed: int = 0) -> List[ServingRequest]:
    """Materialise requests; with ``vocab_size`` set, attach real token
    prompts (left-padded to the trace's max length so the real-tiny engine
    jits one prefill shape). ``prompt_len`` stays the *true* length so
    modeled prefill compute, KV footprint and admission checks are not
    skewed toward the longest prompt in the trace. Events carrying
    explicit ``prompt_tokens`` (shared-prefix traces) keep those ids
    verbatim — with or without ``vocab_size`` — so prefix-cache lookups
    see colliding prefixes even on analytic engines. Events with an
    ``slo_class`` get the matching :class:`SLOSpec` attached."""
    rng = np.random.default_rng(seed)
    pad_to = max((e.prompt_len for e in events), default=0)
    out = []
    for e in events:
        toks = None
        if e.prompt_tokens is not None:
            toks = np.asarray(e.prompt_tokens, dtype=np.int64)
        elif vocab_size is not None:
            toks = rng.integers(0, vocab_size, e.prompt_len)
        prompt = None
        if toks is not None:
            prompt = np.pad(toks, (pad_to - e.prompt_len, 0)).astype(np.int32)
        out.append(ServingRequest(
            rid=e.rid, prompt_len=e.prompt_len,
            max_new_tokens=e.max_new_tokens,
            arrival_s=e.arrival_s, prompt=prompt,
            slo=SLO_CLASSES[e.slo_class] if e.slo_class else None))
    return out
