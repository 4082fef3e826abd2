"""Near-duplicate filtering on the match engine (port of
``repro.data.dedup``; paper technique as a first-class data-pipeline
feature, DESIGN.md Sec. 4).

Documents are fingerprinted as 2-bit character streams (each byte ->
4 crumbs) and stored one-per-row exactly like the paper's folded reference
(Fig. 3).  The store is a ``repro_torch.match.MatchEngine`` over a **growable**
``PackedCorpus`` (DESIGN.md Sec. 3f): adding a document is one in-place
``append_rows`` -- the CRAM row-write analogue -- which packs only the new
row and splices it into the device-resident forms.  Capacity doubles on
demand *inside the corpus* (a device-side zero-extension), so the engine,
its compile cache, and the resident packed rows all survive growth: the
store never repacks a resident row and never rebuilds its engine, the
keep-data-next-to-compute discipline doing production data-plane work
while ingesting.  The store lives on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Union

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.match import MatchEngine, MatchQuery, PackedCorpus

_INITIAL_CAPACITY = 64

Doc = Union[bytes, np.ndarray]


def fingerprint(doc: bytes, length: int = 128) -> np.ndarray:
    """First `length` 2-bit crumbs of the document (byte -> 4 crumbs).

    Documents longer than ``length`` crumbs are truncated by design --
    the fingerprint is a fixed-width prefix signature.  Callers holding a
    precomputed fingerprint array should pass it straight to
    ``CRAMDedup.add`` / ``is_duplicate``, which reject (rather than
    silently truncate) arrays wider than the store's ``fp_len``.
    """
    raw = np.frombuffer(doc[: (length + 3) // 4], np.uint8)
    crumbs = np.stack([(raw >> (2 * i)) & 3 for i in range(4)], 1).reshape(-1)
    out = np.zeros(length, np.uint8)
    out[:min(len(crumbs), length)] = crumbs[:length]
    return out


class CRAMDedup:
    """Row-parallel near-dup store on one lifetime match engine.

    The store is the 'reference' (one fingerprint per row, all rows matched
    in lock step); the candidate is the 'pattern'.  A pattern shorter than
    the fragment slides, so prefix-shifted duplicates are caught too.
    ``backend=None`` lets the planner pick the kernel per query size
    (``method=`` is its deprecated spelling).

    Documents may be raw ``bytes`` (fingerprinted here) or precomputed
    uint8 fingerprint arrays (values 0..3); an array wider than ``fp_len``
    is an error -- silently truncating it would quietly conflate distinct
    documents.  ``device=None`` means the CUDA device.
    """

    def __init__(self, fp_len: int = 128, pattern_len: int = 96,
                 threshold: float = 0.9, backend: Optional[str] = None,
                 method: Optional[str] = None, *,
                 device: DeviceLike = None):
        if method is not None:
            warnings.warn("CRAMDedup(method=...) is deprecated; pass "
                          "backend=...", DeprecationWarning, stacklevel=2)
        if pattern_len > fp_len:
            raise ValueError(f"pattern_len ({pattern_len}) cannot exceed "
                             f"fp_len ({fp_len})")
        self.fp_len = fp_len
        self.pattern_len = pattern_len
        self.threshold = threshold
        self.backend = backend if backend is not None else method
        # One corpus and one engine for the store's whole lifetime: growth
        # happens *inside* the corpus (append_rows + capacity doubling),
        # never by rebuilding the engine -- the resident packed rows and
        # the engine's compile cache survive every add.
        self._engine = MatchEngine(PackedCorpus(
            np.zeros((0, fp_len), np.uint8), capacity=_INITIAL_CAPACITY,
            device=device))

    def __len__(self) -> int:
        return self._engine.corpus.n_rows

    @property
    def engine(self) -> MatchEngine:
        return self._engine

    @property
    def capacity(self) -> int:
        return self._engine.corpus.capacity

    @property
    def total_host_packs(self) -> int:
        """Full host packing events over the store's lifetime (<= 1/form)."""
        return self._engine.corpus.host_pack_count

    @property
    def total_row_writes(self) -> int:
        """Incremental packed-row writes over the store's lifetime."""
        return self._engine.corpus.row_update_count

    def _fingerprint(self, doc: Doc) -> np.ndarray:
        if isinstance(doc, np.ndarray):
            fp = np.asarray(doc, np.uint8).reshape(-1)
            if fp.size > self.fp_len:
                raise ValueError(
                    f"fingerprint has {fp.size} crumbs but this store was "
                    f"built with fp_len={self.fp_len}; truncating would "
                    "conflate distinct documents -- pass at most fp_len "
                    "crumbs or rebuild the store with a larger fp_len")
            out = np.zeros(self.fp_len, np.uint8)
            out[:fp.size] = fp
            return out
        return fingerprint(doc, self.fp_len)

    def _similarity(self, doc: Doc) -> float:
        if len(self) == 0:
            return 0.0
        pat = self._fingerprint(doc)[: self.pattern_len]
        query = MatchQuery.exact(pat, reduction="best",
                                 backend=self.backend)
        # The engine scans live rows only; a compiled query is reused
        # across adds (geometry revalidates as the store grows).
        res = self._engine.match(query)
        return float(res.best_scores.max()) / self.pattern_len

    def is_duplicate(self, doc: Doc) -> bool:
        return self._similarity(doc) >= self.threshold

    def add(self, doc: Doc) -> None:
        """Append one document's fingerprint: an in-place packed row write."""
        self._engine.corpus.append_rows(self._fingerprint(doc))

    def filter(self, docs: List[Doc]) -> List[Doc]:
        """Greedy near-dup filter: keep a doc iff not similar to any kept."""
        kept = []
        for d in docs:
            if not self.is_duplicate(d):
                kept.append(d)
                self.add(d)
        return kept
