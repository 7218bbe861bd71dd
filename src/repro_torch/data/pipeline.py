"""Token data pipeline — the port's own copy of ``repro/data/pipeline.py``
(numpy only; the port imports nothing of the JAX package): the same seed
gives the same bytes.

Two sources:
  * ``SyntheticCorpus`` — a deterministic, structured token stream (Zipfian
    unigrams + short-range bigram structure) so language-model losses
    actually *decrease* during the example training runs and perplexity
    comparisons (Tab. 14 proxy) are meaningful.
  * ``FileCorpus`` — memory-mapped ``.npy`` token file for real data.

Both yield dict batches matching the model's ``lm_loss`` contract, including
multimodal prefix stubs for vlm/audio archs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.unigram = (ranks ** -self.zipf_a)
        self.unigram /= self.unigram.sum()
        # sparse bigram successor table: each token has 4 likely successors
        self.successors = rng.integers(0, V, size=(V, 4))

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        V = self.vocab_size
        out = np.empty(length, np.int32)
        out[0] = rng.choice(V, p=self.unigram)
        for i in range(1, length):
            if rng.random() < 0.7:          # structured transition
                out[i] = self.successors[out[i - 1], rng.integers(0, 4)]
            else:
                out[i] = rng.choice(V, p=self.unigram)
        return out


class FileCorpus:
    def __init__(self, path: str):
        self.tokens = np.load(path, mmap_mode="r")

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        start = rng.integers(0, len(self.tokens) - length)
        return np.asarray(self.tokens[start:start + length], np.int32)


def batches(cfg, *, batch_size: int, seq_len: int, seed: int = 0,
            corpus=None, num_batches: Optional[int] = None) -> Iterator[dict]:
    """Yield model-ready batches for the given architecture config."""
    corpus = corpus or SyntheticCorpus(cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    n_prefix = min(cfg.num_prefix_embeddings, max(seq_len // 4, 1)) \
        if cfg.num_prefix_embeddings else 0
    text_len = seq_len - n_prefix
    i = 0
    while num_batches is None or i < num_batches:
        if cfg.family == "audio":
            toks = np.stack([
                np.stack([corpus.sample(rng, text_len)
                          for _ in range(cfg.num_codebooks)])
                for _ in range(batch_size)])
        else:
            toks = np.stack([corpus.sample(rng, text_len)
                             for _ in range(batch_size)])
        batch = {"tokens": toks}
        if n_prefix:
            batch["prefix"] = rng.standard_normal(
                (batch_size, n_prefix, cfg.d_model)).astype(np.float32) * 0.02
        yield batch
        i += 1
