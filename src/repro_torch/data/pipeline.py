"""Deterministic synthetic data: a Zipfian order-1 Markov corpus.

Every token has a small successor set with Zipf-distributed transition
probabilities. Batches are a pure function of (seed, batch_index,
shard), drawn with numpy, so the port and the JAX package see the same
tokens for the same seed. :class:`Prefetcher` draws them on a background
thread while the card trains.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticCorpus:
    def __init__(self, vocab: int, seed: int = 0, branching: int = 20,
                 zipf_a: float = 1.2):
        self.vocab = vocab
        self.branching = branching
        rng = np.random.default_rng(seed)
        self.successors = rng.integers(0, vocab, size=(vocab, branching),
                                       dtype=np.int32)
        w = 1.0 / np.arange(1, branching + 1) ** zipf_a
        self.probs = (w / w.sum()).astype(np.float64)
        # Zipfian start distribution
        sw = 1.0 / np.arange(1, vocab + 1) ** 1.1
        self.start_probs = sw / sw.sum()
        self.seed = seed

    def batch(self, index: int, batch_size: int, seq_len: int,
              shard: int = 0, n_shards: int = 1) -> np.ndarray:
        """(batch_size, seq_len + 1) int32 tokens; deterministic."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + index) * 97 + shard * n_shards)
        out = np.empty((batch_size, seq_len + 1), np.int32)
        out[:, 0] = rng.choice(self.vocab, size=batch_size, p=self.start_probs)
        choices = rng.choice(self.branching, size=(batch_size, seq_len),
                             p=self.probs)
        for t in range(seq_len):
            out[:, t + 1] = self.successors[out[:, t], choices[:, t]]
        return out

    def batches(self, batch_size: int, seq_len: int, start: int = 0,
                n: Optional[int] = None) -> Iterator[tuple]:
        """Yields (tokens, labels) pairs."""
        i = start
        while n is None or i < start + n:
            full = self.batch(i, batch_size, seq_len)
            yield full[:, :-1], full[:, 1:]
            i += 1

    def calibration_batches(self, n_samples: int, batch_size: int,
                            seq_len: int, seed_offset: int = 10_000) -> list:
        """The paper's 128-sample x 2048-token calibration set analogue."""
        out = []
        for i in range(0, n_samples, batch_size):
            bs = min(batch_size, n_samples - i)
            out.append(self.batch(seed_offset + i, bs, seq_len)[:, :-1])
        return out


class Prefetcher:
    """Background-thread prefetch with a bounded queue: the host draws
    the next batches while the card runs the current step."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
