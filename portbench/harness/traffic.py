"""The one generator of the benchmark's traffic: it reads a traffic mix's
parameters (``portbench/traffic/<name>.json``) and the run's seed, and
gives the requests. The seed orders the requests and draws their token
ids; the set of sizes is the mix's own, the same for every seed.

Kinds:
- ``decode``: ``sessions`` rows in one batch, each with a ``history`` of
  K/V already in a cache of ``slots`` slots, one token a row a step;
  ``first_tokens`` gives each row's first input token.
- ``prefill``: prompts of ``sizes`` lengths at the quantiles of a
  log-uniform law on [``min_tokens``, ``max_tokens``] (both ends
  included); every block of ``sizes`` requests holds each length once, in
  an order drawn from the seed; ids uniform over the vocabulary.
"""
from __future__ import annotations

from typing import List

import numpy as np

KINDS = ("decode", "prefill")


def rng(seed: int, *names) -> np.random.Generator:
    """A numpy generator for one purpose of a run: names are strings or
    whole numbers."""
    s = int(seed)
    words = [abs(s) & 0xFFFFFFFF, (abs(s) >> 32) & 0xFFFFFFFF, abs(s) >> 64,
             int(s < 0)]
    for n in names:
        words.extend(n.encode() if isinstance(n, str) else [int(n)])
    return np.random.default_rng(np.random.SeedSequence(words))


def first_tokens(traffic: dict, vocab: int, seed: int) -> np.ndarray:
    """A decode mix's first input token of each session, int64
    (sessions,)."""
    return rng(seed, "first").integers(0, vocab, traffic["sessions"])


def prompt_lengths(traffic: dict) -> List[int]:
    """The mix's prompt lengths, shortest first."""
    lo, hi, n = traffic["min_tokens"], traffic["max_tokens"], traffic["sizes"]
    if n == 1:
        return [lo]
    return [int(round(lo * (hi / lo) ** (j / (n - 1)))) for j in range(n)]


def prompt_length(traffic: dict, seed: int, i: int) -> int:
    """The length of request ``i`` (0, 1, ...)."""
    sizes = prompt_lengths(traffic)
    block, at = divmod(i, len(sizes))
    return sizes[rng(seed, "order", block).permutation(len(sizes))[at]]


def prompt(traffic: dict, vocab: int, seed: int, i: int) -> np.ndarray:
    """Request ``i``'s token ids, int64 (length,)."""
    n = prompt_length(traffic, seed, i)
    return rng(seed, "prompt", i).integers(0, vocab, n)
