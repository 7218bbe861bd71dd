"""The timed loops: set-up, warm-up and the measured window of each kind
of traffic, recording what each step or request did on the host's clock.
With ``trace``, a profiler session covers a stretch of the window
(``TRACE``) and the rest runs as without it.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List

import torch

from portbench.harness import check as C
from portbench.harness import program as P
from portbench.harness import traffic as TR
from portbench.harness import trace as TRC

#: the items of a ``--trace 1`` run's window that its profiler sessions
#: cover: (first item, items of the device session, items of the host
#: session that follows it). The items before the first session keep the
#: host's clock clean (once the profiler has run, every launch costs the
#: host more)
TRACE = {"decode": (200, 16, 4), "prefill": (24, 8, 2)}
#: decode steps run in set-up
DECODE_WARM = 3


class Window:
    """A run's records: ``items`` (a dict each step or request, its
    "phase": "clean" before any profiler session, "device" or "host"
    inside one, "after" them), the window's start and end on the host's
    clock, the profiler sessions if any."""

    def __init__(self, kind: str, trace: bool):
        self.items: List[Dict] = []
        self.t0 = self.t1 = None
        self.plan = TRACE[kind] if trace else None
        self.sessions: Dict[str, TRC.Session] = {}
        self.open = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def phase(self, i: int) -> str:
        """Open or close the profiler sessions before item ``i``; the
        item's phase."""
        if self.plan is None:
            return "clean"
        first, n_dev, n_host = self.plan
        if i == first:
            self._start("device", False)
        elif i == first + n_dev:
            self._start("host", True)
        elif i == first + n_dev + n_host:
            self._stop()
        if i < first:
            return "clean"
        return self.open or "after"

    def _start(self, name: str, host: bool):
        self._stop()
        self.sessions[name] = TRC.Session(host)
        self.sessions[name].open()
        self.open = name

    def _stop(self):
        if self.open is not None:
            self.sessions[self.open].close()
            self.open = None

    def finish(self, t1: float):
        self.t1 = t1
        self._stop()


def _span(name: str, on: bool):
    """The harness's host range of a step or request in the host session."""
    if on:
        return torch.profiler.record_function(TRC.SPAN + name)
    return contextlib.nullcontext()


class Decode:
    """A decode cell: params, the seeded cache and first tokens. For the
    comparison its window keeps, by reference (no copy), the active sets of
    every step of the current segment and the logits of the last
    ``checks["logit_steps"]`` steps."""

    def __init__(self, mc, cfg, traffic, checks, seed, device, dtype):
        self.mc, self.cfg, self.traffic = mc, cfg, traffic
        self.checks, self.seed, self.device = checks, seed, device
        self.params = P.build_params(cfg, seed, device, dtype)
        self.cache = P.decode_cache(mc, cfg, traffic, seed, device, dtype)
        self.first = TR.first_tokens(traffic, cfg["vocab"], seed)

    def _restart(self):
        self.cache["pos"] = self.traffic["history"]
        return torch.as_tensor(self.first, dtype=torch.int32,
                               device=self.device)[:, None]

    def warm(self):
        tok = self._restart()
        for _ in range(DECODE_WARM):
            nxt = P.decode_step(self.mc, self.params, self.cache,
                                tok)[0].argmax(dim=-1)
            nxt.cpu()
            tok = nxt.to(torch.int32)[:, None]

    @torch.no_grad()
    def window(self, seconds: float, trace: bool, step_hook=None,
               limit: int = 0) -> Window:
        """Closed loop: each step's tokens reach the host before the next
        step starts; at ``slots`` the position returns to ``reset_to``.
        Ends at the first step that finishes ``seconds`` in, or after
        ``limit`` steps where one is given."""
        tr = self.traffic
        win = Window("decode", trace)
        tok = self._restart()
        tok_host = self.first.copy()
        pos, segment = tr["history"], 0
        win.held = collections.deque(maxlen=self.checks["logit_steps"])
        win.sets = {}
        win.t0 = time.perf_counter()
        i = 0
        while True:
            phase = win.phase(i)
            with _span("decode_step", phase == "host"):
                s0 = time.perf_counter()
                logits, sets = P.decode_step(self.mc, self.params,
                                             self.cache, tok)
                s1 = time.perf_counter()
                nxt = logits.argmax(dim=-1)
                if step_hook is not None:
                    nxt = step_hook(i, logits, nxt)
                out = nxt.cpu()
                s2 = time.perf_counter()
            win.items.append({"start": s0, "issued": s1, "done": s2,
                              "pos": pos, "rows": tr["sessions"],
                              "tokens_in": tok_host,
                              "tokens_out": out.numpy(), "segment": segment,
                              "phase": phase})
            win.held.append((i, logits))
            win.sets[i] = sets
            tok_host = out.numpy()
            tok = nxt.to(torch.int32)[:, None]
            pos += 1
            if pos >= tr["slots"]:
                pos = self.cache["pos"] = tr["reset_to"]
                segment += 1
                win.sets = {}
            i += 1
            if s2 - win.t0 >= seconds or i == limit:
                break
        win.finish(win.items[-1]["done"])
        return win

    def segment_kv(self, upto: int) -> Dict[str, torch.Tensor]:
        """The cache's K and V of every layer from slot ``reset_to`` up to
        slot ``upto``, copied: (layers, B, n, hkv, D)."""
        base = self.traffic["reset_to"]
        return {w: P.layer_kv(self.cache, w)[:, :, base:upto + 1].clone()
                for w in ("k", "v")}

    def free(self):
        self.params = self.cache = None


class Prefill:
    """A prefill cell: params; prompts drawn per request. Its window keeps,
    of the requests the comparison samples (drawn before it), the logits
    of the last ``checks["logit_positions"]`` positions (copied), each
    layer's active set and the cache (by reference)."""

    def __init__(self, mc, cfg, traffic, checks, seed, device, dtype):
        self.mc, self.cfg, self.traffic = mc, cfg, traffic
        self.checks, self.seed = checks, seed
        self.device, self.dtype = device, dtype
        self.params = P.build_params(cfg, seed, device, dtype)
        self.sampled = set(C.sample_requests(traffic, checks["sample"], seed))

    def prompt(self, i: int):
        return TR.prompt(self.traffic, self.cfg["vocab"], self.seed, i)

    def _serve(self, ids):
        tokens = torch.as_tensor(ids, dtype=torch.int32).to(self.device)
        return P.prefill(self.mc, self.params, tokens[None], self.dtype)[0][-1]

    def warm(self):
        """Every prompt length of the mix once (each is a shape the window
        uses), longest first."""
        for n in reversed(TR.prompt_lengths(self.traffic)):
            self._serve(TR.rng(self.seed, "warm").integers(
                0, self.cfg["vocab"], n)).argmax().cpu()

    @torch.no_grad()
    def window(self, seconds: float, trace: bool, request_hook=None,
               limit: int = 0) -> Window:
        """Closed loop, one client: a request is submitted when the last
        one's first token has reached the host. Keeps each request's last
        logits (on the device) for the check. Ends as the decode window
        does."""
        win = Window("prefill", trace)
        win.t0 = time.perf_counter()
        i = 0
        while True:
            phase = win.phase(i)
            ids = self.prompt(i)
            with _span("prefill", phase == "host"):
                s0 = time.perf_counter()
                tokens = torch.as_tensor(ids, dtype=torch.int32).to(
                    self.device)
                logits, cache, sets = P.prefill(self.mc, self.params,
                                                tokens[None], self.dtype)
                last = logits[-1]
                s1 = time.perf_counter()
                first = last.argmax()
                if request_hook is not None:
                    first = request_hook(i, last, first)
                tok = int(first.cpu())
                s2 = time.perf_counter()
            item = {"start": s0, "issued": s1, "done": s2,
                    "tokens": len(ids), "rows": 1, "served": tok,
                    "phase": phase}
            if i in self.sampled:
                item["logits"] = logits[-self.checks["logit_positions"]:]\
                    .clone()
                item["sets"] = sets
                item["kv"] = {w: P.layer_kv(cache, w)[:, 0]
                              for w in ("k", "v")}
            del logits, last, cache, sets
            win.items.append(item)
            i += 1
            if s2 - win.t0 >= seconds or i == limit:
                break
        win.finish(win.items[-1]["done"])
        return win

    def free(self):
        self.params = None


KINDS = {"decode": Decode, "prefill": Prefill}
