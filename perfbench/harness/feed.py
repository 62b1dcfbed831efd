"""The token feed of a training cell: a frozen copy of the numpy generator of
``repro_torch.data.pipeline.SyntheticLM.batch`` (text modality only), kept here so
that a change to the program cannot change the benchmark's inputs.

Every batch is a pure function of (seed, step).  Each row is the walk
``(start + a * t) % vocab`` with its own ``start`` and stride ``a`` in 1..4, with 2 %
of the positions replaced by uniform noise; ``labels`` are the tokens shifted by
one.  The Trainer calls :meth:`Feed.batch` at the start of every
step, so the harness stamps each call with its own host clock: the difference
between two stamps is one step's wall time, taken by the benchmark and not read
from the program.
"""

from __future__ import annotations

import time

import numpy as np


def synthetic_batch(seed: int, step: int, batch: int, seq: int, vocab: int
                    ) -> dict[str, np.ndarray]:
    """``{"tokens": (batch, seq) int32, "labels": (batch, seq) int32}``."""
    rng = np.random.default_rng((seed, step))
    a = rng.integers(1, 5, size=(batch, 1))
    start = rng.integers(0, vocab, size=(batch, 1))
    idx = np.arange(seq + 1)[None, :]
    toks = (start + a * idx) % vocab
    noise = rng.integers(0, vocab, size=(batch, seq + 1))
    keep = rng.random((batch, seq + 1)) < 0.98
    toks = np.where(keep, toks, noise).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Feed:
    """What the Trainer's ``data`` attribute is set to: ``batch(step)`` as
    ``SyntheticLM`` gives it, with the host clock of every call kept in
    ``stamps`` (step -> ``time.perf_counter()``)."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int):
        self.seed, self.rows, self.seq, self.vocab = seed, batch, seq, vocab
        self.stamps: dict[int, float] = {}

    def batch(self, step: int) -> dict[str, np.ndarray]:
        self.stamps[step] = time.perf_counter()
        return synthetic_batch(self.seed, step, self.rows, self.seq, self.vocab)
