"""Deterministic synthetic LM data pipeline: the port's copy of
`repro.data.pipeline` (numpy, the same `default_rng((seed, index))` stream,
so its batches equal the reference's bit for bit).

  * **Deterministic + seekable**: batch `i` is a pure function of (seed, i);
    a restart from a checkpoint at step N reproduces the batches N+1...
    without replaying the stream.
  * **Host-parallel sharding**: each host materializes only its slice of the
    global batch (``host_slice``).
  * **Prefetch depth**: a background thread keeps `depth` batches ready.

The synthetic corpus is a mixture of Zipf unigrams and a Markov bigram chain
(fixed per seed), so models have learnable structure.  Batches are numpy
arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["TokenPipeline", "make_batch_iterator"]


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    markov_order: float = 0.7  # prob of following the bigram chain

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_alpha)
        self._unigram = p / p.sum()
        # Sparse deterministic bigram successor table: tok -> fixed successor
        self._succ = rng.permutation(v).astype(np.int64)

    def batch(self, index: int, host_slice: slice | None = None) -> dict[str, np.ndarray]:
        """The `index`-th global batch; optionally just this host's rows.
        The full batch is always generated from the same stream so every host
        sees identical global data regardless of its slice."""
        rng = np.random.default_rng((self.seed, index))
        B, S = self.global_batch, self.seq_len
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.choice(self.vocab, size=B, p=self._unigram)
        follow = rng.random((B, S)) < self.markov_order
        draws = rng.choice(self.vocab, size=(B, S), p=self._unigram)
        for t in range(S):
            toks[:, t + 1] = np.where(follow[:, t], self._succ[toks[:, t]], draws[:, t])
        if host_slice is not None:
            toks = toks[host_slice]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


def make_batch_iterator(
    pipe: TokenPipeline,
    start_index: int = 0,
    depth: int = 2,
    host_slice: slice | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Prefetching iterator: a daemon thread keeps `depth` batches queued."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        i = start_index
        while not stop.is_set():
            q.put(pipe.batch(i, host_slice))
            i += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()
            try:  # unblock the producer if it is waiting on a full queue
                q.get_nowait()
            except queue.Empty:
                pass

    return _Iter()
