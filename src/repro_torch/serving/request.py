"""Serving request lifecycle for the continuous-batching scheduler.

A request moves QUEUED → PREFILLING → RUNNING → (PREEMPTED → …)* →
FINISHED. With chunked prefill a request can be preempted mid-prefill
(``prompt_done`` < ``prompt_len``) and resumes where it left off.

All timestamps are on the engine's modeled clock in **seconds**, rebased
to the scheduler run's origin, so latency percentiles are comparable with
the paper's modeled token rates. SLO targets (:class:`SLOSpec`) are also
modeled seconds: ``ttft_s`` bounds time-to-first-token, ``tpot_s`` bounds
mean time-per-output-token after the first, ``deadline_s`` bounds full
completion relative to arrival.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    FAILED = "failed"          # recovery attempts exhausted — the request
                               # lands in ServingReport.failed, the server
                               # keeps serving everyone else


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Service-level objective class for a request.

    ``priority`` orders classes (lower = more urgent); ``deferrable``
    marks work a carbon-aware policy may hold back for a low-intensity
    grid window (it must still meet ``deadline_s``).
    """
    name: str
    ttft_s: float              # time-to-first-token bound (s, modeled)
    tpot_s: float              # mean time-per-output-token bound (s)
    deadline_s: float          # completion bound relative to arrival (s)
    priority: int = 1
    deferrable: bool = False


#: The benchmark/test SLO classes. Interactive is chat-like (tight TTFT),
#: standard is API traffic, batch is offline work a carbon-aware policy
#: may shift in time. Bounds are modeled-clock seconds calibrated to the
#: paper-scale analytic regime (llama-7b streaming layers from flash:
#: unloaded TTFT ≈ 5 s, decode ≈ 0.35 s/token), so "interactive" is
#: attainable unloaded but misses under burst queueing — which is what
#: gives an EDF policy something to win.
SLO_CLASSES = {
    "interactive": SLOSpec("interactive", ttft_s=7.0, tpot_s=0.6,
                           deadline_s=45.0, priority=0),
    "standard": SLOSpec("standard", ttft_s=15.0, tpot_s=1.2,
                        deadline_s=90.0, priority=1),
    "batch": SLOSpec("batch", ttft_s=120.0, tpot_s=4.0, deadline_s=360.0,
                     priority=2, deferrable=True),
}


@dataclasses.dataclass
class RequestFailure:
    """Structured error slot for a request that exhausted its recovery
    budget — the clean-failure contract: the server never dies, the
    caller gets a machine-readable reason instead of a crash."""
    rid: int
    reason: str                # e.g. "payload checksum mismatch (ssd)"
    bid: int                   # the block whose loss was fatal
    recovery_attempts: int     # recoveries tried before giving up
    t_failed_s: float          # run-relative modeled time of the failure

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServingRequest:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival_s: float = 0.0
    prompt: Optional[np.ndarray] = None       # real-tiny mode only
    slo: Optional[SLOSpec] = None             # None -> no SLO accounting
    state: RequestState = RequestState.QUEUED
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    generated: int = 0
    prompt_done: int = 0                      # prefill tokens completed
    preemptions: int = 0
    prefix_hit: int = 0                       # prompt tokens served by the
                                              # radix prefix cache
    # operational gCO2 attributed to this request (scheduler splits each
    # iteration's slice across the requests that did work in it,
    # proportional to tokens processed; idle/overhead carbon stays
    # unattributed — see docs/OBSERVABILITY.md)
    gco2_g: float = 0.0
    gco2_prefill_g: float = 0.0
    gco2_decode_g: float = 0.0
    session: object = None                    # engine DecodeSession
    _true_prompt: Optional[tuple] = None      # memoized unpadded tokens
    # fault recovery (docs/RELIABILITY.md): when a KV block is
    # unrecoverably lost, the request is re-enqueued and re-prefilled
    # from its prompt + the tokens already emitted — those move into
    # ``recovered_prefix`` so the final stream stays byte-identical.
    # ``gco2_recovery_g`` is the slice of prefill carbon spent redoing
    # work a fault destroyed.
    recoveries: int = 0
    recovered_prefix: list = dataclasses.field(default_factory=list)
    failure: Optional["RequestFailure"] = None
    gco2_recovery_g: float = 0.0

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    @property
    def prefilled(self) -> bool:
        return self.prompt_done >= self.prompt_len

    def true_prompt(self) -> tuple:
        """The unpadded prompt token ids (prefix-cache lookup key); ()
        when the request carries no token prompt. Memoized — the
        admission loop asks every waiting request each iteration and the
        prompt never changes."""
        if self._true_prompt is None:
            self._true_prompt = () if self.prompt is None else \
                tuple(int(t) for t in self.prompt[-self.prompt_len:])
        return self._true_prompt

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first (s, modeled)."""
        if self.finish_s is None or self.first_token_s is None:
            return None
        if self.generated <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) / (self.generated - 1)

    @property
    def total_tokens(self) -> int:
        """Tokens this request pins in KV: prompt + generated. After a
        recovery the re-emitted tokens live inside ``prompt_len``
        (re-prefill extends the prompt), so subtract the overlap."""
        return self.prompt_len + self.generated - len(self.recovered_prefix)

    def final_tokens(self) -> list:
        """The request's complete emitted token stream: tokens generated
        before the last recovery (now part of the re-prefill prompt)
        followed by the current session's tokens. Byte-identical to the
        fault-free run under greedy decode + pure block-chunked
        prefill."""
        out = list(self.recovered_prefix)
        if self.session is not None and getattr(self.session, "tokens",
                                                None) is not None:
            out.extend(int(t) for t in self.session.tokens)
        return out

    @property
    def own_kv_tokens(self) -> int:
        """Tokens needing KV blocks of the request's *own* (prefix-hit
        tokens live in shared radix-node blocks)."""
        return max(self.total_tokens - self.prefix_hit, 1)

    # -- SLO accounting -------------------------------------------------
    @property
    def deadline_s(self) -> Optional[float]:
        """Absolute completion deadline on the run clock (arrival + SLO)."""
        if self.slo is None:
            return None
        return self.arrival_s + self.slo.deadline_s

    @property
    def ttft_deadline_s(self) -> Optional[float]:
        """Absolute first-token deadline — what EDF admission orders by."""
        if self.slo is None:
            return None
        return self.arrival_s + self.slo.ttft_s

    def slo_met(self) -> Optional[bool]:
        """All three bounds satisfied? None when the request carries no SLO
        or has not finished."""
        if self.slo is None or self.finish_s is None:
            return None
        return (self.ttft_s <= self.slo.ttft_s
                and self.tpot_s <= self.slo.tpot_s
                and self.latency_s <= self.slo.deadline_s)
