"""Declarative MatchQuery IR (DESIGN.md Sec. 3e).

The paper's substrate is *reconfigurable*: one resident array serves many
match flavors by reprogramming the in-memory logic, never by re-shipping
data (Sec. 1, 3).  The accelerator analogue is a small, frozen, hashable
query IR that is *compiled once* against the engine
(``MatchEngine.compile`` -> ``CompiledMatch``) and then reused: planning,
pattern packing and kernel selection happen at compile time, not per call.

This is the PyTorch port's copy of ``repro.match.query``; ``digest`` is
byte-identical to the JAX package's for the same query.

A ``MatchQuery`` bundles

* **patterns as a predicate** -- the canonical pattern form is a
  per-position *accept mask*: uint8 with bit ``c`` set iff DNA code ``c``
  (A=0 C=1 G=2 T=3) is accepted at that position.  Exact characters are
  one-hot masks; IUPAC ambiguity codes (``N`` = 0b1111, ``R`` = A|G, ...)
  and arbitrary character classes are just wider masks.  Two spellings of
  the same query (codes vs. one-hot masks) canonicalize to the same IR and
  therefore the same digest.
* **a reduction spec** -- ``best | topk | threshold | full`` with
  per-query ``k`` / ``threshold`` for batched queries.
* **a row subset** and **backend hints** (kernel override, chunk size).

Everything is stored as hashable primitives (bytes + tuples), so a query
is a dict key: the engine's compile cache and the service's result cache
key on the query object itself (content equality -- collision-free).
``digest`` is the equivalent *stable content hash* for use outside the
process (distributed caches, logs, telemetry).
"""

from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import encoding

REDUCTIONS = ("best", "topk", "threshold", "full")
BACKENDS = ("swar", "mxu", "ref")
MODES = ("shared", "per_row", "batched")

_DEFAULT_K = 10


def _mask_array(masks) -> np.ndarray:
    masks = np.asarray(masks, np.uint8)
    if masks.ndim not in (1, 2):
        raise ValueError("patterns must be 1-D (shared) or 2-D")
    if masks.shape[-1] < 1:
        raise ValueError("pattern must have at least one character")
    if masks.size and ((masks < 1) | (masks > 15)).any():
        raise ValueError(
            "accept masks must be in [1, 15]: bit c accepts code c; 0 "
            "accepts nothing and bits >= 4 name no DNA code")
    return masks


@dataclasses.dataclass(frozen=True)
class MatchQuery:
    """Frozen declarative match query; construct via the classmethods.

    Fields are canonical hashable primitives -- use ``exact`` /
    ``from_masks`` / ``iupac`` rather than the raw constructor, and the
    ``masks`` / ``codes`` / ``rows`` properties rather than the ``*_b``
    bytes.  ``mode`` is ``None`` for shared (1-D) queries and for 2-D
    queries left to engine inference.
    """

    masks_b: bytes                          # uint8 accept masks, flattened
    shape: Tuple[int, ...]                  # (P,) or (Q, P)
    mode: Optional[str] = None              # None | "per_row" | "batched"
    reduction: str = "best"
    k: Tuple[int, ...] = ()                 # non-empty only for topk
    threshold: Optional[Tuple[float, ...]] = None
    rows_b: Optional[bytes] = None          # int64 row ids, flattened
    backend: Optional[str] = None           # kernel override
    chunk_rows: Optional[int] = None        # streaming chunk override
    # Q-gram filter hint (threshold queries, DESIGN.md Sec. 3g): None lets
    # the planner's two-stage cost model decide, False opts out, True
    # forces the filtered strategy whenever it is legal (the query has
    # prunable signature bits) -- the pricing is skipped, never the
    # conservativeness requirement.
    filter: Optional[bool] = None

    # -- constructors ---------------------------------------------------------
    @classmethod
    def exact(cls, patterns, **spec) -> "MatchQuery":
        """Query from uint8 character codes (values 0..3).

        Out-of-range codes are rejected here -- at the API boundary --
        instead of surfacing as garbage SWAR scores or an index error deep
        inside the MXU host packing.
        """
        patterns = np.asarray(patterns, np.uint8)
        if patterns.ndim not in (1, 2):
            raise ValueError("patterns must be 1-D (shared) or 2-D")
        if patterns.size and patterns.max() > 3:
            raise ValueError(
                f"pattern codes must be < 4 (A=0 C=1 G=2 T=3); got max "
                f"{int(patterns.max())}. Encode ambiguity codes with "
                "encoding.encode_iupac and MatchQuery.iupac/from_masks")
        return cls.from_masks(
            (np.uint8(1) << patterns).astype(np.uint8), **spec)

    @classmethod
    def from_masks(cls, masks, *, mode: Optional[str] = None,
                   reduction: str = "best", k=_DEFAULT_K, threshold=None,
                   rows=None, backend: Optional[str] = None,
                   chunk_rows: Optional[int] = None,
                   filter: Optional[bool] = None) -> "MatchQuery":
        """Query from per-position accept masks (uint8, bit c = code c)."""
        masks = _mask_array(masks)
        if mode == "shared" and masks.ndim == 1:
            mode = None                     # canonical: shared is default
        if masks.ndim == 1 and mode is not None:
            raise ValueError(f"1-D patterns are 'shared', got mode={mode!r}")
        if masks.ndim == 2 and mode is not None and mode not in (
                "per_row", "batched"):
            raise ValueError(f"2-D patterns need mode 'per_row' or "
                             f"'batched', got {mode!r}")
        if reduction not in REDUCTIONS:
            raise ValueError(f"unknown reduction {reduction!r}")
        if reduction == "threshold" and threshold is None:
            raise ValueError("reduction='threshold' requires a threshold")
        if backend is not None and backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        q = masks.shape[0] if masks.ndim == 2 else 1
        batched_ok = masks.ndim == 2 and mode != "per_row"
        k_norm: Tuple[int, ...] = ()
        if reduction == "topk":
            k_norm = tuple(int(x) for x in np.atleast_1d(np.asarray(k)))
            if len(k_norm) != 1 and not (batched_ok and len(k_norm) == q):
                raise ValueError("per-query k needs a batched query with "
                                 "one entry per pattern")
        thr_norm: Optional[Tuple[float, ...]] = None
        if reduction == "threshold":
            thr_norm = tuple(float(x) for x in
                             np.atleast_1d(np.asarray(threshold, np.float64)))
            if len(thr_norm) != 1:
                if not batched_ok:
                    raise ValueError("per-query thresholds need a batched "
                                     "query")
                if len(thr_norm) != q:
                    raise ValueError("per-query thresholds need one entry "
                                     "per pattern")
        rows_b = None
        if rows is not None:
            rows_b = np.asarray(rows, np.int64).reshape(-1).tobytes()
        if chunk_rows is not None and int(chunk_rows) < 1:
            raise ValueError("chunk_rows must be >= 1")
        if filter is not None and not isinstance(filter, bool):
            raise ValueError("filter must be None, True or False")
        if filter and reduction != "threshold":
            raise ValueError(
                "filter=True needs reduction='threshold': only a row-"
                "sparse reduction can skip pruned rows exactly (best/topk/"
                "full report every row)")
        return cls(masks_b=masks.tobytes(), shape=tuple(masks.shape),
                   mode=mode, reduction=reduction, k=k_norm,
                   threshold=thr_norm, rows_b=rows_b, backend=backend,
                   chunk_rows=None if chunk_rows is None
                   else int(chunk_rows), filter=filter)

    @classmethod
    def iupac(cls, pattern: Union[str, Sequence[str]],
              **spec) -> "MatchQuery":
        """Query from IUPAC string(s): ACGT + ambiguity codes + N wildcard."""
        if isinstance(pattern, str):
            masks = encoding.encode_iupac(pattern)
        else:
            masks = np.stack([encoding.encode_iupac(p) for p in pattern])
        return cls.from_masks(masks, **spec)

    # -- views ----------------------------------------------------------------
    @cached_property
    def masks(self) -> np.ndarray:
        """Accept masks, shape ``self.shape`` (read-only view)."""
        m = np.frombuffer(self.masks_b, np.uint8).reshape(self.shape)
        m.flags.writeable = False
        return m

    @cached_property
    def is_exact(self) -> bool:
        """True iff every position accepts exactly one character."""
        m = self.masks
        return bool(((m & (m - 1)) == 0).all())

    @cached_property
    def codes(self) -> np.ndarray:
        """uint8 character codes; only defined for exact queries."""
        if not self.is_exact:
            raise ValueError("codes are only defined for exact queries; "
                             "use .masks")
        c = np.zeros(self.shape, np.uint8)
        for b in range(4):
            c[self.masks == (1 << b)] = b
        c.flags.writeable = False
        return c

    @property
    def predicate(self) -> str:
        """Planner-facing predicate kind: "exact" or "accept"."""
        return "exact" if self.is_exact else "accept"

    @cached_property
    def rows(self) -> Optional[np.ndarray]:
        if self.rows_b is None:
            return None
        r = np.frombuffer(self.rows_b, np.int64)
        r.flags.writeable = False
        return r

    @property
    def pattern_chars(self) -> int:
        return self.shape[-1]

    @property
    def n_patterns(self) -> int:
        return self.shape[0] if len(self.shape) == 2 else 1

    @cached_property
    def digest(self) -> str:
        """Stable content hash (blake2b-128) over the canonical fields.

        Two queries are equal iff their digests agree; in-process caches
        key on the query object itself, this is the external spelling
        (distributed cache keys, logs, telemetry).
        """
        h = hashlib.blake2b(digest_size=16)
        h.update(self.masks_b)
        for part in (self.shape, self.mode, self.reduction, self.k,
                     self.threshold, self.backend, self.chunk_rows,
                     self.filter):
            h.update(repr(part).encode())
        h.update(self.rows_b if self.rows_b is not None else b"\xff")
        return h.hexdigest()


def as_masks(pattern) -> np.ndarray:
    """Normalize one pattern spelling to a 1-D uint8 accept-mask array.

    Accepts the three spellings the query constructors accept -- a 1-D
    ``MatchQuery`` (its masks are taken verbatim; reduction/rows baggage
    is ignored), an IUPAC string, or a raw array (uint8 character codes
    0..3, lifted to one-hot masks like ``MatchQuery.exact``).  The
    PatternBank registers through this so every spelling freezes to the
    same canonical form.
    """
    if isinstance(pattern, MatchQuery):
        if len(pattern.shape) != 1:
            raise ValueError("standing patterns are single patterns; got a "
                             f"{pattern.shape} query")
        return np.array(pattern.masks)
    if isinstance(pattern, str):
        return _mask_array(encoding.encode_iupac(pattern))
    codes = np.asarray(pattern, np.uint8)
    if codes.ndim != 1:
        raise ValueError("pattern arrays must be 1-D uint8 codes")
    if codes.size and codes.max() > 3:
        raise ValueError(
            f"pattern codes must be < 4 (A=0 C=1 G=2 T=3); got max "
            f"{int(codes.max())}. Spell ambiguity as an IUPAC string or "
            "a 1-D MatchQuery")
    return _mask_array((np.uint8(1) << codes).astype(np.uint8))


_SHIM_DEFAULTS = dict(reduction="best", k=_DEFAULT_K, threshold=None,
                      rows=None, backend=None, mode=None, chunk_rows=None,
                      filter=None)
# Unset marker, distinct from every real default, so an *explicitly passed*
# default value (match(query, reduction="best")) still counts as a clash.
_UNSET = object()


def as_query(patterns, **kw) -> MatchQuery:
    """Kwarg-shim normalizer: codes array + legacy kwargs -> MatchQuery.

    Passing an existing ``MatchQuery`` forwards it unchanged; combining it
    with any keyword is rejected (the query is the single source of
    truth).  Shim callers (``MatchEngine.match`` & co.) forward only the
    kwargs their caller actually supplied, leaving the rest ``_UNSET``.
    """
    if isinstance(patterns, MatchQuery):
        clash = [name for name in _SHIM_DEFAULTS
                 if kw.get(name, _UNSET) is not _UNSET]
        if clash:
            raise ValueError(
                f"got a MatchQuery plus keyword overrides {clash}; build "
                "the overrides into the query (dataclasses.replace)")
        return patterns
    merged = dict(_SHIM_DEFAULTS)
    merged.update({k_: v for k_, v in kw.items() if v is not _UNSET})
    mode = merged.pop("mode")
    return MatchQuery.exact(patterns, mode=mode, **{
        name: merged[name] for name in
        ("reduction", "k", "threshold", "rows", "backend", "chunk_rows",
         "filter")})
