"""The device trace of a ``--trace 1`` run: two ``torch.profiler``
sessions over stretches of the window. The first records the device
alone (kernel events add little host work): the device's busy time, the
kernels' times and counts, the device operations that took most time. The
second, shorter, records the host's operations too, which slows the host,
and serves only to say what the host was doing in each idle gap.

In some states of a process the profiler loses the first kernel event of
a session; every session here starts with two spin kernels that the
readings leave out (as ``chip_smoke.py``'s ``open_session``).
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

SENTINEL = "spin_kernel"
#: a host range the harness opens around each step or request of the
#: host session
SPAN = "portbench::"
TOP = 10


class Session:
    """A profiler session around part of the window (the device's
    activity, and with ``host`` the host's operations); ``open``/``close``
    bracket it, each after a device synchronise."""

    def __init__(self, host: bool):
        self.host = host
        self.prof = None
        self.t0 = self.t1 = None

    def open(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA]
        if self.host:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        for _ in range(2):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def close(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)


def events(prof):
    """(start us, end us, name, on the device, thread) of every event of a
    session, from its raw results where the installed torch gives them
    (parsing them into FunctionEvents costs ~70 us an event)."""
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None and hasattr(raw, "events"):
        for e in raw.events():
            s0 = e.start_ns() / 1e3
            yield (s0, s0 + e.duration_ns() / 1e3, e.name(),
                   e.device_type() == DeviceType.CUDA, e.start_thread_id())
        return
    for e in prof.events():
        yield (e.time_range.start, e.time_range.end, e.name,
               e.device_type == DeviceType.CUDA, e.thread)


def _kernels(evs):
    return sorted((s, e, n) for s, e, n, dev, _ in evs
                  if dev and SENTINEL not in n and not n.startswith(SPAN))


class Trace:
    """What the sessions saw. ``kernels``: (start us, end us, name) of
    every device operation of the device session but the sentinels, by
    start; ``busy_s``: the union of their intervals; ``window_s``: the
    device session's length on the host's clock, from just after its
    sentinels to its end. ``host``: the host session, for
    :meth:`idle_gaps`."""

    def __init__(self, device: Session, host: Optional[Session] = None):
        self.kernels = _kernels(list(events(device.prof)))
        self.busy_s = _union(self.kernels) / 1e6
        self.window_s = device.t1 - device.t0
        self.host = host

    def kernel_time(self, *parts: str) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose names hold any
        of ``parts``."""
        sel = [(s, e) for s, e, n in self.kernels if any(p in n for p in parts)]
        return sum(e - s for s, e in sel) / 1e6, len(sel)

    def device_ops(self) -> List[list]:
        """The device operations that took most time: [[name, seconds]]."""
        tot: Dict[str, float] = {}
        for s, e, n in self.kernels:
            tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
        return [[n[:120], t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """The host session's device idle time inside the harness's spans,
        summed by the innermost host operation running at each gap's middle
        (or the span's name where none runs): [[name, seconds]], the
        largest first."""
        if self.host is None:
            return []
        evs = list(events(self.host.prof))
        kernels = _kernels(evs)
        hosted = [(s, e, n, t) for s, e, n, dev, t in evs if not dev]
        spans = sorted((s, e, n[len(SPAN):]) for s, e, n, _ in hosted
                       if n.startswith(SPAN))
        main = _main_thread(hosted)
        ops = sorted((s, e, n) for s, e, n, t in hosted
                     if t == main and not n.startswith(SPAN))
        gaps = []
        for s0, s1, span in spans:
            lo = bisect.bisect_left(kernels, (s0,))
            hi = bisect.bisect_right(kernels, (s1, float("inf")))
            at = s0
            for s, e, _ in kernels[lo:hi]:
                if s > at:
                    gaps.append((at, s, span))
                at = max(at, e)
            if s1 > at:
                gaps.append((at, s1, span))
        tot: Dict[str, float] = {}
        for (a, b, span), op in zip(gaps, _innermost(
                ops, [(a + b) / 2 for a, b, _ in gaps])):
            key = op or span
            tot[key] = tot.get(key, 0.0) + (b - a) / 1e6
        return [[n[:120], t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]


def _main_thread(host) -> Optional[int]:
    count: Dict[int, int] = {}
    for _, _, _, t in host:
        count[t] = count.get(t, 0) + 1
    return max(count, key=count.get) if count else None


def _union(iv) -> float:
    total, end = 0.0, float("-inf")
    for s, e, _ in iv:
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _innermost(ops, times):
    """For each of ``times`` (in any order), the name of the latest-starting
    host op that contains it, or None. ``ops`` sorted by start."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out: List[Optional[str]] = [None] * len(times)
    stack: List[tuple] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(ops) and ops[j][0] <= t:
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        for s, e, n in reversed(stack):
            if s <= t <= e:
                out[i] = n
                break
    return out
