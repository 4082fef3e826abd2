"""Device-resident q-gram filter index (port of ``repro.match.index``).

* ``CorpusIndex`` keeps, per corpus row, a **B-bit q-gram occurrence
  signature**: every q-gram (q consecutive 2-bit characters) of the row
  is hashed to one of B bits and OR'd in.  Signatures are packed as
  uint32 words (carried in int32) and kept on the device beside the
  corpus's SWAR and one-hot forms, under the same protocol: packed once,
  lazily (``sig_pack_count`` <= 1), row splices re-derive only the
  touched rows, capacity growth zero-extends, ``invalidate`` drops the
  form.  The index stores no content of its own: it derives from the
  corpus buffer it observes.
* ``build_query_filter`` lowers a query to the signature of the q-grams
  it *requires* (q-grams spanning a non-exact position are dropped), and
  ``slack = floor(P - t) * q``: an alignment scoring >= t has at most
  ``floor(P - t)`` mismatches, each destroys at most q required q-grams,
  and each required bit absent from a row witnesses one destroyed
  q-gram.  Zero false negatives by construction; hash collisions only
  add candidates.
* Selectivity feedback: measured density and an EWMA of measured /
  predicted survivor fractions calibrate the planner's two-stage cost
  model (``Planner.plan`` with a ``FilterContext``).

The signature form is built **on the device** from the corpus's uint8
codes (``signature_words``), block by block: at a human chromosome the
host path of the JAX package (an (n, B) occupancy matrix per 64K rows)
would take seconds.  The words are identical to ``row_signatures``,
the numpy copy of the JAX function kept here for query-side operands.

On a sharded corpus the signature form mirrors the corpus's cyclic row
layout: a tensor a shard on the shard's device, shard ``s`` holding the
logical rows ``s::S``, each shard's slot count padded to
``FILTER_ROW_TILE`` on its own (``shard_stride``).  Per-row bit counts
then stay on the shards' devices too, and ``density`` is a cross-shard
sum over the live slots, joined on the first device and cached per
corpus generation (the host mean of one shard, bit for bit).  On a mesh
that spans processes each process builds, splices and sums only its own
shards (``None`` stands for the others, as in the corpus); one
``all_reduce`` of the int64 sum then gives every process the same
density, so every process plans alike (the JAX index's per-host build).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import first_local
from repro_torch.kernels import filter_qgram as _fq
from repro_torch.match.feedback import EwmaRatio

# Rows hashed per step on the device (bounds the (n, F) int64 q-gram
# values and the (n, B) occupancy temporaries).
_BUILD_CHUNK_ROWS = 1 << 16

# Fibonacci-multiplicative hash constant (Knuth); the top log2(B) bits of
# the wrapped product spread consecutive q-gram values well.
_HASH_MUL = np.uint32(2654435761)

DEFAULT_Q = 4
DEFAULT_BITS = 256
# One-hot accept mask -> character code (0 for non-one-hot entries; callers
# select with the one-hot test first).
_ONEHOT_CODE = np.zeros(256, np.uint8)
for _c in range(4):
    _ONEHOT_CODE[1 << _c] = _c


def qgram_values(codes: np.ndarray, q: int) -> np.ndarray:
    """(..., n) uint8 codes -> (..., n-q+1) uint32 base-4 q-gram values."""
    codes = np.asarray(codes, np.uint8)
    n = codes.shape[-1]
    if n < q:
        return np.zeros(codes.shape[:-1] + (0,), np.uint32)
    vals = np.zeros(codes.shape[:-1] + (n - q + 1,), np.uint32)
    for j in range(q):
        vals |= codes[..., j:n - q + 1 + j].astype(np.uint32) << \
            np.uint32(2 * j)
    return vals


def _hash_shift(n_bits: int) -> int:
    return 32 - int(n_bits).bit_length() + 1


def hash_bits(vals: np.ndarray, n_bits: int) -> np.ndarray:
    """q-gram values -> signature bit indices in [0, n_bits)."""
    shift = np.uint32(_hash_shift(n_bits))
    return ((np.asarray(vals, np.uint32) * _HASH_MUL) >> shift).astype(
        np.int64)


def pack_bit_rows(bit_idx_rows: Sequence[np.ndarray], n_bits: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row bit indices -> ((n, Wb) uint32 words, (n,) distinct counts).

    Bit ``b`` of a signature lives at bit ``b % 32`` of word ``b // 32``.
    ``bit_idx_rows`` is a (n, G) array or a ragged sequence of 1-D index
    arrays; duplicates are free (OR is idempotent).
    """
    n = len(bit_idx_rows)
    wb = n_bits // 32
    if n == 0:
        return np.zeros((0, wb), np.uint32), np.zeros(0, np.int32)
    if isinstance(bit_idx_rows, np.ndarray) and bit_idx_rows.ndim == 2:
        row_ids = np.repeat(np.arange(n), bit_idx_rows.shape[1])
        flat_bits = bit_idx_rows.reshape(-1)
    else:
        lens = np.fromiter((len(b) for b in bit_idx_rows), np.int64, n)
        row_ids = np.repeat(np.arange(n), lens)
        flat_bits = (np.concatenate([np.asarray(b, np.int64)
                                     for b in bit_idx_rows])
                     if lens.sum() else np.zeros(0, np.int64))
    occupancy = np.zeros((n, n_bits), np.uint32)
    occupancy[row_ids, flat_bits] = 1
    lanes = occupancy.reshape(n, wb, 32)
    shifts = np.arange(32, dtype=np.uint32)
    words = (lanes << shifts).sum(-1, dtype=np.uint64).astype(np.uint32)
    counts = occupancy.sum(1).astype(np.int32)
    return words, counts


def row_signatures(rows: np.ndarray, q: int, n_bits: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(n, F) uint8 code rows -> packed signatures + per-row bit counts
    (numpy; ``signature_words`` computes the same words on a device)."""
    rows = np.asarray(rows, np.uint8)
    bits = hash_bits(qgram_values(rows, q), n_bits)
    return pack_bit_rows(bits, n_bits)


def signature_words(codes: torch.Tensor, q: int, n_bits: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, F) uint8 codes -> ((n, Wb) int32 words, (n,) int32 bit counts).

    ``row_signatures`` on the codes' device, word for word.  The hash is
    taken mod 2**32 in int64 in two 16-bit halves, so no product
    overflows.
    """
    n, F = codes.shape
    dev = codes.device
    wb = n_bits // 32
    occ = torch.zeros((n, n_bits), dtype=torch.bool, device=dev)
    g = F - q + 1
    if n and g > 0:
        c = codes.to(torch.int64)
        vals = torch.zeros((n, g), dtype=torch.int64, device=dev)
        for j in range(q):
            vals |= c[:, j:j + g] << (2 * j)
        mul = int(_HASH_MUL)
        lo = (vals & 0xFFFF) * mul
        hi = (((vals >> 16) * mul) & 0xFFFF) << 16
        bits = ((lo + hi) & 0xFFFFFFFF) >> _hash_shift(n_bits)
        occ.scatter_(1, bits, True)
    lanes = occ.view(n, wb, 32).to(torch.int64)
    words = (lanes << torch.arange(32, device=dev)).sum(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32), occ.sum(1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class FilterOperands:
    """Per-query filter-stage operands, row-count independent.

    Derived from (query content, index q, index B) only, so -- like the
    packed pattern operands -- they survive every corpus generation and
    every growth step unchanged.
    """

    qsig_words: np.ndarray        # (Q, Wb) uint32 required-bit signatures
    slacks: Tuple[int, ...]       # per-query e*q (negative: unsatisfiable)
    n_bits: Tuple[int, ...]       # per-query distinct required bits


def build_query_filter(masks2d: np.ndarray,
                       thresholds: Sequence[float], q: int,
                       n_bits: int) -> FilterOperands:
    """Lower query accept-masks + thresholds to filter operands.

    ``masks2d`` is (Q, P) uint8 accept masks; a pattern position is
    *exact* iff its mask is one-hot.  Q-grams spanning any non-exact
    position are dropped (conservative).  ``slack = floor(P - t) * q``.
    """
    masks2d = np.asarray(masks2d, np.uint8)
    Q, P = masks2d.shape
    onehot = (masks2d & (masks2d - 1)) == 0          # mask 0 never occurs
    codes = _ONEHOT_CODE[masks2d]
    sig_rows = []
    for i in range(Q):
        if P < q:
            sig_rows.append(np.zeros(0, np.int64))
            continue
        vals = qgram_values(codes[i], q)
        usable = np.ones(P - q + 1, bool)
        for j in range(q):
            usable &= onehot[i, j:P - q + 1 + j]
        sig_rows.append(hash_bits(vals[usable], n_bits))
    words, counts = pack_bit_rows(sig_rows, n_bits)
    slacks = tuple(
        (math.floor(P - float(t)) * q) if float(t) <= P else -1
        for t in thresholds)
    return FilterOperands(qsig_words=words, slacks=slacks,
                          n_bits=tuple(int(c) for c in counts))


def binom_cdf(k: int, n: int, p: float) -> float:
    """P(Binomial(n, p) <= k), direct log-space sum (no scipy dep)."""
    if k < 0:
        return 0.0
    if k >= n or p <= 0.0:
        return 1.0
    if p >= 1.0:
        return 0.0
    lg = math.lgamma
    total = 0.0
    for a in range(k + 1):
        total += math.exp(lg(n + 1) - lg(a + 1) - lg(n - a + 1)
                          + a * math.log(p) + (n - a) * math.log1p(-p))
    return min(1.0, total)


def expected_density(n_chars: int, q: int, n_bits: int) -> float:
    """Analytic prior for hashed q-gram signature occupancy: a row of
    ``n_chars`` throws ``n_chars - q + 1`` q-grams into ``n_bits`` bins."""
    g = int(n_chars) - int(q) + 1
    return 1.0 - (1.0 - 1.0 / int(n_bits)) ** max(g, 0)


def pass_probability(n_query_bits: int, slack: int, density: float) -> float:
    """Probability one random row admits one query under the filter.

    Required bits are modeled as independently present at ``density``;
    the query passes iff at most ``slack`` of its ``n_query_bits``
    required bits are absent.  Negative slack prunes everything.
    """
    if slack < 0:
        return 0.0
    return binom_cdf(int(slack), int(n_query_bits), 1.0 - float(density))


class CorpusIndex:
    """Per-row q-gram signatures, device-resident and grown in place.

    Attaches to a ``PackedCorpus`` as an observer: every row splice
    (``append_rows`` / ``set_rows`` / ``compact``) re-derives signatures
    for exactly the touched rows on the device and writes them into the
    cached form in place, capacity growth zero-extends on the device,
    and ``invalidate`` drops the form.
    """

    def __init__(self, corpus, *, q: int = DEFAULT_Q,
                 n_bits: int = DEFAULT_BITS):
        q = int(q)
        n_bits = int(n_bits)
        if q < 1 or q > 16:
            raise ValueError(f"q must be in [1, 16], got {q}")
        if n_bits < 32 or n_bits & (n_bits - 1):
            raise ValueError(
                f"n_bits must be a power of two >= 32, got {n_bits}")
        if corpus.fragment_chars < q:
            raise ValueError(
                f"fragment_chars={corpus.fragment_chars} shorter than "
                f"q={q}: no q-grams to index")
        self.corpus = corpus
        self.q = q
        self.n_bits = n_bits
        self.sig_words = n_bits // 32
        # A (Jf, Wb) int32 signature form a shard (lazy).
        self._sigs: Optional[List[torch.Tensor]] = None
        # Per-row bit counts: on the host for one shard, a (Jf,) int32
        # tensor a shard on its device for several (``_bits_dev``).
        self._row_bits = np.zeros(corpus.capacity, np.int32)
        self._bits_dev: Optional[List[torch.Tensor]] = None
        self._dcache: Optional[tuple] = None
        self.sig_pack_count = 0
        self.row_update_count = 0
        # Selectivity feedback: EWMA of measured/predicted survivor
        # fractions from executed filtered queries, one-decade clamp (see
        # record_selectivity).
        self._selectivity = EwmaRatio(decay=0.3, clamp=(0.1, 10.0))
        self.n_filter_runs = 0
        self.last_survivor_frac: Optional[float] = None
        corpus.attach_index(self)

    # -- geometry --------------------------------------------------------------
    @property
    def _rows_padded(self) -> int:
        """Device-form row count: each shard's slots padded to the filter
        row tile (its stride ``Jf`` may exceed the corpus forms' ``J``)."""
        return self.corpus.n_shards * self.shard_stride

    @property
    def shard_stride(self) -> int:
        """Slots of a shard's signature form, Jf."""
        tile = _fq.FILTER_ROW_TILE
        return -(-self.corpus.shard_stride // tile) * tile

    # -- residency -------------------------------------------------------------
    def signatures(self) -> torch.Tensor:
        """(R_pad, Wb) int32 row signatures of an unsharded corpus
        (``signature_shards`` for a sharded one)."""
        return self.corpus._one_form(self.signature_shards(), "signature")

    def signature_shards(self) -> List[torch.Tensor]:
        """A (Jf, Wb) int32 signature form a shard, device-resident.

        The first call hashes the live rows on each shard's device (one
        event; reserved and padding rows are all-zero); later calls reuse
        the cached forms, which row splices keep up to date.
        """
        if self._sigs is None:
            tr = self.corpus.obs.tracer
            with tr.span("pack",
                         {"form": "qgram_sigs", "rows": self._rows_padded}
                         if tr.enabled else None):
                c = self.corpus
                S, n = c.n_shards, c.n_rows
                sigs, bits = [], []
                for s in range(S):
                    if c.devices[s] is None:
                        sigs.append(None)
                        bits.append(None)
                        continue
                    live = c._shard_live(s)
                    form = torch.zeros((self.shard_stride, self.sig_words),
                                       dtype=torch.int32,
                                       device=c.devices[s])
                    counts = torch.zeros(self.shard_stride,
                                         dtype=torch.int32,
                                         device=c.devices[s])
                    for j0 in range(0, live, _BUILD_CHUNK_ROWS):
                        j1 = min(j0 + _BUILD_CHUNK_ROWS, live)
                        form[j0:j1], counts[j0:j1] = signature_words(
                            c._shard_codes(s, j0, j1), self.q, self.n_bits)
                    if S == 1:
                        self._row_bits[:n] = counts[:n].cpu().numpy()
                    sigs.append(form)
                    bits.append(counts)
                self._sigs = sigs
                self._bits_dev = bits if S > 1 else None
                self._dcache = None
            self.sig_pack_count += 1
            self.corpus.obs.metrics.counter("corpus.packs").inc()
        return self._sigs

    # -- corpus observer hooks -------------------------------------------------
    def _on_rows_written(self, start: int, rows: np.ndarray) -> None:
        """Touched-rows-only splice, mirroring ``PackedCorpus._splice_device``:
        each row's signature lands at its shard and slot."""
        n = rows.shape[0]
        if self._sigs is not None:
            c = self.corpus
            S = c.n_shards
            for s, i0, j0, m in c.shard_slices(start, n):
                codes = torch.from_numpy(np.ascontiguousarray(
                    rows[i0::S], np.uint8)).to(c.devices[s])
                words, counts = signature_words(codes, self.q, self.n_bits)
                self._sigs[s][j0:j0 + m] = words
                if self._bits_dev is not None:
                    self._bits_dev[s][j0:j0 + m] = counts
                else:
                    self._row_bits[start:start + n] = counts.cpu().numpy()
            self._dcache = None
            self.row_update_count += n

    def _on_capacity(self) -> None:
        """Capacity growth: zero-extend on the device, extend host counts."""
        cap = self.corpus.capacity
        if cap > self._row_bits.shape[0]:
            self._row_bits = np.concatenate(
                [self._row_bits,
                 np.zeros(cap - self._row_bits.shape[0], np.int32)])
        jf = self.shard_stride
        if self._sigs is not None and first_local(self._sigs).shape[0] < jf:
            # Per-shard zero-extension: rows keep their shard and slot.
            self._sigs = [None if f is None else torch.cat([f, f.new_zeros(
                (jf - f.shape[0], self.sig_words))], 0) for f in self._sigs]
            if self._bits_dev is not None:
                self._bits_dev = [None if b is None else torch.cat([
                    b, b.new_zeros(jf - b.shape[0])])
                    for b in self._bits_dev]

    def _on_invalidate(self) -> None:
        self._sigs = None
        self._bits_dev = None
        self._dcache = None

    # -- selectivity model -----------------------------------------------------
    def density(self) -> float:
        """Mean fraction of signature bits set per live row.

        Measured once the index is built; before that, the analytic prior
        for hashed q-gram occupancy -- so the planner can price the
        filter before paying the first pack.
        """
        n = self.corpus.n_rows
        if self._sigs is not None and n:
            if self._bits_dev is not None:
                return self._density_device(n)
            return float(self._row_bits[:n].mean()) / self.n_bits
        return expected_density(self.corpus.fragment_chars, self.q,
                                self.n_bits)

    def _density_device(self, n: int) -> float:
        """Live-row mean bit count from the shards' device counts.

        Each shard sums its live slots on its device; the sums join on
        the first device (across processes, one ``all_reduce`` over the
        mesh's group: a collective every process reaches at the same
        plan) and one scalar crosses to the host.  ``float(total) / n``
        reproduces the host ``np.mean`` (an exact integer sum, one
        float64 divide) bit for bit.  Cached per (generation, n): density
        is read on every plan, the corpus mutates far less often.
        """
        key = (self.corpus.generation, n)
        if self._dcache is not None and self._dcache[0] == key:
            return self._dcache[1]
        dev0 = first_local(self.corpus.devices)
        total = torch.stack([
            b[:self.corpus._shard_live(s)].sum(dtype=torch.int64).to(dev0)
            for s, b in enumerate(self._bits_dev) if b is not None]).sum()
        mesh = self.corpus._mesh
        if mesh is not None and mesh.multiprocess:
            total = mesh.all_reduce_sum(total)
        total = int(total)
        val = float(total) / n / self.n_bits
        self._dcache = (key, val)
        return val

    def estimate_survivor_frac(self, n_query_bits: Sequence[int],
                               slacks: Sequence[int], *,
                               calibrated: bool = True) -> float:
        """Estimated fraction of rows surviving the (union) filter.

        Per query: P(#absent required bits <= slack) with bits modeled as
        independently present at the measured density; union-bounded over
        queries.  ``calibrated=True`` (the planner's spelling) scales by
        the measured-selectivity EWMA; ``calibrated=False`` is the raw
        model prediction, which measurements are recorded against.
        """
        d = self.density()
        total = 0.0
        for bq, slack in zip(n_query_bits, slacks):
            if slack < 0:
                continue                 # unsatisfiable: prunes every row
            total += pass_probability(bq, slack, d)
        if calibrated and self._calibration is not None:
            total *= self._calibration
        return float(min(1.0, total))

    @property
    def _calibration(self) -> Optional[float]:
        """Measured-selectivity EWMA value (None until the first run)."""
        return self._selectivity.value

    def record_selectivity(self, predicted: float, measured: float) -> None:
        """Fold one filtered run's outcome into the calibration EWMA.

        ``predicted`` must be the **uncalibrated** model estimate
        (``estimate_survivor_frac(..., calibrated=False)``).  The
        per-update ratio clamp is one decade: only filtered runs record,
        so one wild outlier must not flip every later query to "scan",
        where it could never be contradicted.
        """
        self._selectivity.update(measured / max(predicted, 1e-9))
        self.n_filter_runs += 1
        self.last_survivor_frac = measured

    def stats(self) -> dict:
        return {
            "q": self.q,
            "n_bits": self.n_bits,
            "sig_pack_count": self.sig_pack_count,
            "row_update_count": self.row_update_count,
            "density": round(self.density(), 4),
            "n_filter_runs": self.n_filter_runs,
            "last_survivor_frac": self.last_survivor_frac,
            "calibration": (None if self._calibration is None
                            else round(self._calibration, 4)),
        }
