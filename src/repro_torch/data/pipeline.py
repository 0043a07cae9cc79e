"""Deterministic synthetic LM data pipeline, host-shard-aware, with a
double-buffered background prefetcher.

Determinism contract: batch contents are a pure function of
``(seed, step, host_shard)`` via a counter-based PRNG, so restarts resume
bit-identically from a checkpointed step, any host can regenerate any shard
(elastic re-sharding after failures), and two runs of the same config are
reproducible — the property the fault-tolerance layer leans on.

The synthetic stream is a Zipfian token mix with short-range structure
(Markov back-off), enough for losses to be meaningfully > uniform and for
overfitting tests to show learning.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class SyntheticLM:
    """Deterministic synthetic token batches.

    Produces ``tokens`` of shape (per_host_batch, seq_len + 1) — the +1
    column provides next-token labels by shifting.
    """

    def __init__(
        self,
        *,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        num_hosts: int = 1,
        host_index: int = 0,
        zipf_a: float = 1.2,
    ):
        assert global_batch % num_hosts == 0, (global_batch, num_hosts)
        self.vocab = vocab_size
        self.seq = seq_len
        self.per_host = global_batch // num_hosts
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_index = host_index
        # Zipf over an effective vocab (cap for tractable CDF)
        eff = min(vocab_size, 50_000)
        ranks = np.arange(1, eff + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.cdf = np.cumsum(p / p.sum())
        self.eff = eff

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        # counter-based PRNG: a unique, seekable stream per (step, host)
        gen = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, step,
                                                     self.host_index]))
        u = gen.random((self.per_host, self.seq + 1))
        toks = np.searchsorted(self.cdf, u).astype(np.int32)
        # short-range structure: with p=0.25 copy previous token (bigram-ish)
        copy = gen.random((self.per_host, self.seq)) < 0.25
        toks[:, 1:] = np.where(copy, toks[:, :-1], toks[:, 1:])
        return {"tokens": toks % self.vocab}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch thread over any batch source."""

    _DONE = object()

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 max_steps: Optional[int] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                if max_steps is not None and step >= max_steps:
                    self._q.put(self._DONE)
                    return
                self._q.put(source.batch(step))
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
