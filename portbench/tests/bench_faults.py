"""Faults planted in the timed path underneath a run, for the tests that
see ``correct`` come out false (and for ``calibrate.py --fault``, which
reads them on the card): each is a context manager that patches the
port's code or gives the loop's hook. A one-chip cell has no exchange
between chips, so that fault has no form here."""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

from portbench.harness import program as P


@contextlib.contextmanager
def state_unchanged(traffic):
    """Each decode step leaves the cache as it found it: the slot it wrote
    put back, the position not moved."""
    real = P.decode_step

    def step(mc, params, cache, tokens):
        pos = cache["pos"]
        saved = {w: P.layer_kv(cache, w)[:, :, pos].clone()
                 for w in ("k", "v")}
        out = real(mc, params, cache, tokens)
        for w, t in saved.items():
            P.layer_kv(cache, w)[:, :, pos] = t
        cache["pos"] = pos
        return out
    with mock.patch.object(P, "decode_step", step):
        yield {}


@contextlib.contextmanager
def half_batch(traffic):
    """The FFN's shared active set from half of the rows (or a prompt's
    positions), the mean of their scores taken over that half."""
    from repro_torch.core import mp_ffn
    from repro_torch.core.predictor import top_k

    def shared(scores, k):
        flat = scores.reshape(-1, scores.shape[-1])
        half = flat[:max(1, flat.shape[0] // 2)].mean(dim=0)
        return top_k(half.float(), k)[1]
    with mock.patch.object(mp_ffn, "shared_topk_indices", shared):
        yield {}


@contextlib.contextmanager
def segment_skipped(traffic):
    """A decode step's attention skips the slots that the segment's earlier
    steps wrote: it reads the history and its own slot only."""
    from repro_torch.models import transformer as T
    real = T.decode_slots
    history = traffic["history"]

    def slots(pos0, sbuf, ring=False):
        held, lengths = real(pos0, sbuf, ring)
        at = torch.arange(sbuf, device=held.device)[None]
        keep = (at < history) | (at == lengths[:, None])
        return torch.where(keep, held, -1).to(held.dtype), lengths
    with mock.patch.object(T, "decode_slots", slots):
        yield {}


@contextlib.contextmanager
def token_altered(traffic):
    """The served token is the next id after the one the logits pick."""
    def alter(i, logits, tok):
        return torch.remainder(tok + 1, logits.shape[-1])
    yield {"step": alter, "request": alter}


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "segment_skipped": segment_skipped, "token_altered": token_altered}
#: the faults each kind of cell can have
OF_KIND = {"decode": ("state_unchanged", "half_batch", "segment_skipped",
                      "token_altered"),
           "prefill": ("half_batch", "token_altered")}
