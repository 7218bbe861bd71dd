"""Block-access trace: the replay format for the replacement-policy lab.

Every ``TieredKVCache`` mutation — promote, demote, spill, pin, evict —
becomes one :class:`BlockAccessEvent`. The collector keeps them in
order and exports JSONL (one event per line, stable key order) that a
future replacement-policy simulator replays against candidate policies
without re-running the serving stack.

Format spec (``docs/OBSERVABILITY.md`` carries the authoritative copy):

* line 1 is a header record: ``{"format": "kv-block-trace",
  "version": 2, ...}``
* every other line is an event::

      {"t": <modeled_s>, "op": <str>, "bid": <int>, "rid": <int>,
       "tier": <str>, "prev_tier": <str|null>, "nbytes": <int>,
       "tok0": <int>, "cause": <str|null>, "precision": <str|null>}

  ``op`` ∈ {alloc, touch, promote, demote, spill, evict, pin, unpin,
  free, adopt}; ``tier`` is the block's tier *after* the op; ``cause``
  says why (e.g. "hbm_pressure", "prefetch", "preempt"); ``precision``
  (v2, fp16 | int8 | int4, null on v1 files) labels the storage
  precision of the bytes that moved — for promotes, the precision the
  block was *stored at* on its source tier (``nbytes`` is sized
  accordingly).

``read_block_trace`` parses a file back into events;
``BlockAccessEvent.to_record``/``from_record`` round-trip exactly,
which ``tests/test_obs.py`` locks in.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional

FORMAT_NAME = "kv-block-trace"
FORMAT_VERSION = 2        # v2: + per-event storage precision label

OPS = ("alloc", "touch", "promote", "demote", "spill", "evict",
       "pin", "unpin", "free", "adopt")


@dataclasses.dataclass(frozen=True)
class BlockAccessEvent:
    t: float                      # modeled seconds (raw engine clock)
    op: str                       # one of OPS
    bid: int                      # block id
    rid: int                      # owning request id (negative: prefix node)
    tier: str                     # tier after the op: hbm | dram | ssd
    prev_tier: Optional[str] = None
    nbytes: int = 0
    tok0: int = 0                 # first token index covered by the block
    cause: Optional[str] = None
    precision: Optional[str] = None   # storage precision of the moved
                                      # bytes (v2; None on v1 files)

    def to_record(self) -> Dict:
        return {"t": self.t, "op": self.op, "bid": self.bid,
                "rid": self.rid, "tier": self.tier,
                "prev_tier": self.prev_tier, "nbytes": self.nbytes,
                "tok0": self.tok0, "cause": self.cause,
                "precision": self.precision}

    @classmethod
    def from_record(cls, rec: Dict) -> "BlockAccessEvent":
        return cls(t=float(rec["t"]), op=str(rec["op"]),
                   bid=int(rec["bid"]), rid=int(rec["rid"]),
                   tier=str(rec["tier"]),
                   prev_tier=rec.get("prev_tier"),
                   nbytes=int(rec.get("nbytes", 0)),
                   tok0=int(rec.get("tok0", 0)),
                   cause=rec.get("cause"),
                   precision=rec.get("precision"))


class BlockTraceCollector:
    """Ordered in-memory collector with JSONL export."""

    def __init__(self, capacity: Optional[int] = None):
        self._events: List[BlockAccessEvent] = []
        self.capacity = capacity
        self.dropped = 0
        self.per_op: Dict[str, int] = {}

    def record(self, ev: BlockAccessEvent):
        if ev.op not in OPS:
            raise ValueError(f"unknown block op {ev.op!r}")
        self.per_op[ev.op] = self.per_op.get(ev.op, 0) + 1
        if self.capacity is not None and len(self._events) >= self.capacity:
            self.dropped += 1
            return
        self._events.append(ev)

    def emit(self, t: float, op: str, bid: int, rid: int, tier: str,
             **kw):
        self.record(BlockAccessEvent(t=float(t), op=op, bid=int(bid),
                                     rid=int(rid), tier=tier, **kw))

    def events(self) -> List[BlockAccessEvent]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def stats(self) -> Dict[str, int]:
        out = {f"block_{op}": n for op, n in sorted(self.per_op.items())}
        out["block_events"] = len(self._events)
        out["block_dropped"] = self.dropped
        return out

    def export_jsonl(self, path) -> str:
        with open(path, "w") as f:
            json.dump({"format": FORMAT_NAME, "version": FORMAT_VERSION,
                       "events": len(self._events),
                       "dropped": self.dropped}, f)
            f.write("\n")
            for ev in self._events:
                json.dump(ev.to_record(), f)
                f.write("\n")
        return str(path)


def read_block_trace(path) -> Iterator[BlockAccessEvent]:
    """Parse a JSONL block trace; validates the header line."""
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("format") != FORMAT_NAME:
            raise ValueError(f"not a {FORMAT_NAME} file: {path}")
        if int(header.get("version", -1)) > FORMAT_VERSION:
            raise ValueError(
                f"block trace version {header.get('version')} is newer "
                f"than supported ({FORMAT_VERSION})")
        for line in f:
            line = line.strip()
            if line:
                yield BlockAccessEvent.from_record(json.loads(line))
