"""Deterministic synthetic token pipeline.

A copy of ``repro/data/pipeline.py`` (numpy and the standard library only).


Statelessness is the fault-tolerance property: batch(step) is a pure
function of (seed, step, dp_rank), so any restart — including an *elastic*
restart onto a different number of data-parallel ranks — resumes exactly,
with no data-loader checkpoints to persist (the paper's NFS-outlives-pods
principle applied to data).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.dp_size == 0
        return self.global_batch // self.dp_size

    def batch(self, step: int) -> dict:
        """Markov-ish token stream: cheap, deterministic, non-degenerate."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.dp_rank]))
        b, s = self.local_batch, self.seq_len
        base = rng.integers(0, self.vocab, size=(b, 1), dtype=np.int32)
        steps = rng.integers(-16, 17, size=(b, s), dtype=np.int32)
        toks = (base + np.cumsum(steps, axis=1)) % self.vocab
        return {"tokens": toks.astype(np.int32)}

    def rescale(self, dp_rank: int, dp_size: int) -> "SyntheticTokens":
        """Elastic re-shard: same stream, new rank layout."""
        return SyntheticTokens(self.vocab, self.seq_len, self.global_batch,
                               self.seed, dp_rank, dp_size)


def make_batch_iterator(source: SyntheticTokens, start_step: int = 0,
                        prefetch: int = 2):
    """Background-thread prefetching iterator (host-side pipelining)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, source.batch(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _It:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _It()
