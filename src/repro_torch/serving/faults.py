"""Deterministic fault injection for the tiered serving stack.

The paper's pitch is serving from cheap, old hardware — consumer SSDs,
commodity DRAM, outdated interconnects — exactly the hardware class
where storage IO errors, bit flips and stalled DMA channels are routine
rather than exceptional.  This module provides the seeded
:class:`FaultInjector` that the cache/prefetch/scheduler layers consult
at every storage and transfer boundary, so degraded operation can be
reproduced bit-for-bit and gated in CI (``benchmarks/serving_faults.py``).

Fault points
------------

=================  ====================================================
``ssd.read``       SSD payload read raises an IO error (retryable)
``ssd.write``      SSD payload write raises an IO error (retryable)
``ssd.corrupt``    silent bit flip in a payload read back from SSD
``dram.corrupt``   silent bit flip in a payload promoted from DRAM
``dma.stall``      a prefetch DMA transfer is delayed by ``stall_s``
``dma.fail``       a prefetch DMA transfer dies; the waiter must redo
                   it synchronously
``provider.export``  transient device→host KV capture error (retried)
``provider.import``  transient host→device KV restore error (retried)
=================  ====================================================

Plans are either *rate-based* (per-opportunity probability from a
per-point RNG seeded by ``(seed, point)``) or *scripted at modeled
time* (``after_s``/``until_s`` windows on the run-relative clock), with
an optional ``max_fires`` budget per rule.  Two runs with the same seed,
plan and workload inject the identical fault sequence.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np

FAULT_POINTS = (
    "ssd.read", "ssd.write", "ssd.corrupt", "dram.corrupt",
    "dma.stall", "dma.fail", "provider.export", "provider.import",
)


class FaultError(RuntimeError):
    """An injected fault at a named point (transient, retryable)."""

    def __init__(self, point: str, detail: str = ""):
        super().__init__(f"injected fault at {point}" +
                         (f": {detail}" if detail else ""))
        self.point = point
        self.detail = detail


class KVBlockLostError(RuntimeError):
    """A KV block's payload is unrecoverably gone (read retries
    exhausted or checksum mismatch with no clean copy left).

    ``rid >= 0`` names a live request's own block; ``rid < 0`` names a
    prefix-tree node — the scheduler routes the two to different
    recovery paths (request re-prefill vs subtree invalidation).
    """

    def __init__(self, rid: int, bid: int, reason: str):
        super().__init__(f"KV block {bid} (rid {rid}) lost: {reason}")
        self.rid = rid
        self.bid = bid
        self.reason = reason


# ----------------------------------------------------------------------
# payload checksums
# ----------------------------------------------------------------------

def payload_checksum(banks: Dict[str, np.ndarray]) -> int:
    """crc32 over a payload dict's keys, dtypes, shapes and raw bytes.

    Computed when a block's payload crosses a storage boundary
    (demote / spill / persisted-tree save) and verified when it comes
    back (promote / restore / load): any single flipped bit in the
    stored bytes changes the digest.  Shared by ``TieredKVCache`` and
    ``PrefixCache`` (which re-exports it for back-compat).
    """
    crc = 0
    for k in sorted(banks):
        a = np.ascontiguousarray(banks[k])
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(str(a.dtype).encode(), crc)
        crc = zlib.crc32(str(a.shape).encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc


def flip_one_byte(banks: Dict[str, np.ndarray], rng: np.random.Generator,
                  ) -> Dict[str, np.ndarray]:
    """Return a copy of ``banks`` with exactly one byte XOR-flipped.

    Used by the ``ssd.corrupt``/``dram.corrupt`` points (and the
    property tests) to model a silent single-event upset; CRC-32
    detects every single-bit error, so the flip can never decode
    silently once checksums are on.
    """
    keys = [k for k in sorted(banks) if np.asarray(banks[k]).nbytes > 0]
    if not keys:
        return banks
    k = keys[int(rng.integers(len(keys)))]
    a = np.ascontiguousarray(banks[k])
    raw = bytearray(a.tobytes())
    off = int(rng.integers(len(raw)))
    mask = 1 << int(rng.integers(8))
    raw[off] ^= mask
    out = dict(banks)
    out[k] = np.frombuffer(bytes(raw), dtype=a.dtype).reshape(a.shape)
    return out


# ----------------------------------------------------------------------
# fault rules + injector
# ----------------------------------------------------------------------

@dataclasses.dataclass
class FaultRule:
    point: str
    rate: float = 1.0                 # per-opportunity fire probability
    after_s: Optional[float] = None   # run-relative modeled-time window
    until_s: Optional[float] = None
    max_fires: Optional[int] = None   # total budget for this rule
    stall_s: float = 0.0              # extra delay for dma.stall
    fired: int = 0

    def to_dict(self) -> dict:
        d = {"point": self.point, "rate": self.rate}
        if self.after_s is not None:
            d["after_s"] = self.after_s
        if self.until_s is not None:
            d["until_s"] = self.until_s
        if self.max_fires is not None:
            d["max_fires"] = self.max_fires
        if self.stall_s:
            d["stall_s"] = self.stall_s
        return d


class FaultInjector:
    """Seeded, plan-driven fault source consulted at every boundary.

    Each fault point draws from its own ``PCG64`` stream seeded by
    ``(seed, crc32(point))``, so arming one point never perturbs the
    fire sequence of another and runs replay deterministically.
    """

    def __init__(self, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        self.seed = int(seed)
        self._rules: Dict[str, List[FaultRule]] = {}
        self._rngs: Dict[str, np.random.Generator] = {}
        self._clock = clock or (lambda: 0.0)
        self.fired: Dict[str, int] = {}
        self.checked: Dict[str, int] = {}
        self.events: List[dict] = []
        self._trace = None
        self._metric = None

    # -- construction --------------------------------------------------
    def arm(self, point: str, *, rate: float = 1.0,
            after_s: Optional[float] = None, until_s: Optional[float] = None,
            max_fires: Optional[int] = None, stall_s: float = 0.0) -> "FaultInjector":
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; "
                             f"known: {', '.join(FAULT_POINTS)}")
        self._rules.setdefault(point, []).append(FaultRule(
            point=point, rate=float(rate), after_s=after_s, until_s=until_s,
            max_fires=max_fires, stall_s=float(stall_s)))
        return self

    @classmethod
    def from_plan(cls, plan, *, clock=None) -> "FaultInjector":
        """Build from a plan dict or a path to a JSON plan file.

        ``{"seed": 0, "rules": [{"point": "ssd.read", "rate": 1.0,
        "after_s": 0.0, "until_s": 2.0, "max_fires": 3}, ...]}``
        """
        if isinstance(plan, str):
            with open(plan) as f:
                plan = json.load(f)
        inj = cls(seed=int(plan.get("seed", 0)), clock=clock)
        for r in plan.get("rules", []):
            r = dict(r)
            inj.arm(r.pop("point"), **r)
        return inj

    def plan_dict(self) -> dict:
        return {"seed": self.seed,
                "rules": [r.to_dict() for rs in self._rules.values()
                          for r in rs]}

    def set_clock(self, clock: Callable[[], float]):
        """Modeled-time source for scripted windows (run-relative s)."""
        self._clock = clock

    def attach_obs(self, trace=None, metrics=None):
        self._trace = trace
        if metrics is not None:
            self._metric = metrics.counter(
                "serving_faults_injected_total",
                "faults injected by point")

    # -- firing --------------------------------------------------------
    def _rng(self, point: str) -> np.random.Generator:
        if point not in self._rngs:
            self._rngs[point] = np.random.default_rng(
                (self.seed, zlib.crc32(point.encode())))
        return self._rngs[point]

    def fire(self, point: str, *, detail: Any = None) -> Optional[FaultRule]:
        """Should an injected fault hit this opportunity?

        Returns the matched rule (carrying e.g. ``stall_s``) or None.
        The RNG is drawn once per armed opportunity so the stream stays
        aligned across runs regardless of which rules match their
        windows.
        """
        self.checked[point] = self.checked.get(point, 0) + 1
        rules = self._rules.get(point)
        if not rules:
            return None
        now = float(self._clock())
        u = float(self._rng(point).random())
        for rule in rules:
            if rule.max_fires is not None and rule.fired >= rule.max_fires:
                continue
            if rule.after_s is not None and now < rule.after_s:
                continue
            if rule.until_s is not None and now >= rule.until_s:
                continue
            if u >= rule.rate:
                continue
            rule.fired += 1
            self.fired[point] = self.fired.get(point, 0) + 1
            ev = {"point": point, "t_s": now}
            if detail is not None:
                ev["detail"] = detail
            self.events.append(ev)
            if self._trace is not None:
                self._trace.instant("faults", f"fault:{point}", **ev)
            if self._metric is not None:
                self._metric.inc(1, point=point)
            return rule
        return None

    def corrupt(self, point: str, banks: Dict[str, np.ndarray],
                *, detail: Any = None) -> Dict[str, np.ndarray]:
        """Apply a silent one-byte flip to ``banks`` if ``point`` fires."""
        if self.fire(point, detail=detail) is None:
            return banks
        return flip_one_byte(banks, self._rng(point))

    # -- reporting -----------------------------------------------------
    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def stats(self) -> dict:
        return {"seed": self.seed,
                "faults_injected": self.total_fired,
                "fired": dict(self.fired),
                "checked": dict(self.checked)}

    def export_events_jsonl(self, path: str) -> int:
        """Dump the injected-fault event log (one JSON object per line)
        for replay/diagnosis; a run output, never committed."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return len(self.events)
