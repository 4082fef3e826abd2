"""Data pipeline (port of ``repro.data.pipeline``; numpy only, the port's
own copy): deterministic-seek token streams + host sharding.

Restart discipline (fault tolerance): every batch is a pure function of
(seed, step) -- ``batch_at(step)`` -- so a job restarted from a checkpoint
at step N replays the identical remaining stream with zero coordination.
Host sharding takes the data-axis slice of the global batch, matching the
``batch -> (pod, data)`` sharding rule.  Batches are numpy arrays,
bit-identical to the reference's for the same arguments; the train loop
places them on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Seeded synthetic next-token stream (Zipfian tokens with local
    structure so the loss visibly decreases)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S = self.global_batch, self.seq_len
        # Zipf-ish marginal + repeated bigram structure (learnable signal).
        base = rng.zipf(1.3, size=(B, S + 1)) % self.vocab
        rep = rng.integers(0, self.vocab, (B, 1))
        mask = rng.random((B, S + 1)) < 0.3
        toks = np.where(mask, rep, base).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class TextLM:
    """Byte-level LM over an in-memory corpus with deterministic seek."""

    corpus: bytes
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S = self.global_batch, self.seq_len
        n = len(self.corpus) - S - 1
        starts = rng.integers(0, max(n, 1), B)
        toks = np.stack([np.frombuffer(
            self.corpus[s:s + S + 1], np.uint8).astype(np.int32)
            for s in starts])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def host_shard(batch: Dict[str, np.ndarray], host_index: int,
               n_hosts: int) -> Dict[str, np.ndarray]:
    """This host's slice of the global batch (data-axis sharding)."""
    def sl(x):
        b = x.shape[0]
        per = b // n_hosts
        return x[host_index * per:(host_index + 1) * per]
    return {k: sl(v) for k, v in batch.items()}
