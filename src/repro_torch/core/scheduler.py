"""Pattern-to-row scheduling: Naive vs Oracular (paper Sec. 5).

Port of ``repro.core.scheduler`` (NumPy only, copied).

* **Naive** -- one pattern at a time is broadcast to *every* row of *every*
  array; the whole substrate performs one pattern's alignment per pass.
* **Oracular** -- a scheduler between the pattern pool and the substrate
  routes each pattern only to rows whose reference fragment is a plausible
  home (the paper implements this with "hash-based filtering", citing
  GRIM-filter).  We implement a real, runnable k-mer seed index (not an
  oracle stub): a pattern is a candidate for a row iff the row's fragment
  contains at least one of the pattern's k-mers.

The schedule quality determines the number of *passes* (lock-step array
executions) needed to process a pattern pool; the cost model turns passes
into time/energy.  For problem sizes that fit in this container the index is
built exactly; for paper-scale problems (3G-char reference) the expected
candidate count is computed analytically from k-mer statistics -- both paths
are exposed and cross-validated in tests.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-mers of a code string as packed integers (2 bits/char)."""
    codes = np.asarray(codes, np.uint64)
    if len(codes) < k:
        return np.zeros((0,), np.uint64)
    weights = (np.uint64(4) ** np.arange(k, dtype=np.uint64))
    windows = np.lib.stride_tricks.sliding_window_view(codes, k)
    return (windows * weights).sum(-1).astype(np.uint64)


class KmerIndex:
    """fragment-row inverted index over k-mers (the 'hash-based filter')."""

    def __init__(self, fragments: np.ndarray, k: int = 8):
        self.k = k
        self.n_rows = fragments.shape[0]
        self.index: Dict[int, List[int]] = defaultdict(list)
        for r in range(self.n_rows):
            for km in np.unique(kmer_codes(fragments[r], k)):
                self.index[int(km)].append(r)

    def candidate_rows(self, pattern: np.ndarray) -> np.ndarray:
        rows: set[int] = set()
        for km in np.unique(kmer_codes(pattern, self.k)):
            rows.update(self.index.get(int(km), ()))
        return np.fromiter(rows, np.int64) if rows else np.zeros(0, np.int64)


@dataclasses.dataclass
class Schedule:
    """Result of scheduling a pattern pool onto the substrate.

    ``passes[p]`` maps row -> pattern index for pass p (rows not present are
    idle but still burn compute, as the array is lock-step).
    """

    n_rows: int
    passes: List[Dict[int, int]]
    candidate_counts: np.ndarray

    @property
    def n_passes(self) -> int:
        return len(self.passes)

    @property
    def replication(self) -> float:
        """Average rows evaluated per pattern."""
        total = sum(len(p) for p in self.passes)
        n_pat = len(self.candidate_counts)
        return total / max(n_pat, 1)


def schedule_naive(n_rows: int, n_patterns: int) -> Schedule:
    passes = [{r: p for r in range(n_rows)} for p in range(n_patterns)]
    return Schedule(n_rows, passes, np.full(n_patterns, n_rows))


def schedule_oracular(fragments: np.ndarray, patterns: np.ndarray,
                      k: int = 8) -> Schedule:
    """Greedy list scheduling of (pattern, candidate-row) pairs into passes.

    Each pass may use a row at most once; the number of passes is therefore
    max over rows of the per-row queue depth (load balancing is implicit in
    how fragments partition the reference).
    """
    index = KmerIndex(fragments, k)
    n_rows = fragments.shape[0]
    row_queues: List[List[int]] = [[] for _ in range(n_rows)]
    counts = np.zeros(len(patterns), np.int64)
    for p, pat in enumerate(patterns):
        cand = index.candidate_rows(pat)
        counts[p] = len(cand)
        for r in cand:
            row_queues[r].append(p)
    n_passes = max((len(q) for q in row_queues), default=0)
    passes: List[Dict[int, int]] = []
    for i in range(n_passes):
        assignment = {r: q[i] for r, q in enumerate(row_queues) if i < len(q)}
        passes.append(assignment)
    return Schedule(n_rows, passes, counts)


# Fixed per-pattern seed sampling budget: practical seed-and-extend filters
# (GRIM-filter class, the paper's [30]) sample a bounded number of seeds per
# pattern rather than all P-k+1, so the candidate-row count -- and hence the
# Oracular pass count -- is roughly *independent of pattern length*.  This
# is what makes the paper's Fig. 7 throughput stay close to baseline while
# compute-per-alignment grows.  86 = the P=100, k=15 seed count.
SEED_BUDGET = 86


def expected_candidates(ref_len: int, pattern_len: int, k: int,
                        packing_overhead: float = 1.25,
                        seed_budget: int = SEED_BUDGET) -> float:
    """Analytic expected candidate-row count per pattern (paper scale).

    Each sampled k-mer matches ~ref_len / 4^k random reference locations;
    distinct locations land in distinct rows at the paper's fragment sizes.
    ``packing_overhead`` covers dedup slack and imperfect pass packing
    (calibrated once; see costmodel).  A floor of 1 row per pattern applies
    (Oracular never drops patterns, Sec. 5).
    """
    n_kmers = min(max(pattern_len - k + 1, 1), seed_budget)
    hits = n_kmers * ref_len / float(4 ** k)
    return max(hits * packing_overhead, 1.0)


def oracular_passes_analytic(n_patterns: int, total_rows: int, ref_len: int,
                             pattern_len: int, k: int | None = None,
                             packing_overhead: float = 1.25) -> float:
    """Expected number of substrate passes for an Oracular schedule."""
    if k is None:
        k = 15
    cand = expected_candidates(ref_len, pattern_len, k, packing_overhead)
    return max(n_patterns * cand / total_rows, 1.0)
