"""Runtime feedback for the cost model (DESIGN.md Sec. 3i).

Even a calibrated cost model drifts: corpora change shape, the host gets
contended, a backend upgrade moves kernel constants.  The serving half of
the calibration discipline is therefore *online*: every executed launch
records its observed wall time against the estimate the planner priced it
at, bucketed by (kernel, shape octave), and once a bucket's measured /
estimated ratio drifts past a bound the planner re-prices that bucket by
the measured ratio -- so a mispredicted mxu-vs-swar or scan-vs-filter
decision heals within a few launches instead of never.

This generalizes the measured-selectivity EWMA that ``CorpusIndex``
pioneered for the filter stage (``record_selectivity``) into one shared
idiom -- ``EwmaRatio`` -- used by both: a clamped exponentially-weighted
average of measured/predicted ratios, always taken against the *raw*
(un-fed-back) prediction so the loop converges to the truth rather than
the geometric mean of model and truth.

Keys are coarse by design: shapes bucket by octave (``floor(log2)``), so
one bucket aggregates the launches that share a cost regime and a handful
of observations is enough to re-price it.  The first observation per
bucket is discarded as warmup (it pays jit tracing/compilation, which is
not a marginal-launch cost).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

# Shared EWMA defaults (the CorpusIndex selectivity values, kept).
DEFAULT_DECAY = 0.3
# Runtime ratios span decades on a mispriced substrate (static datasheet
# constants vs. an interpret-mode CPU); the clamp only guards single-shot
# garbage (timer glitches), not honest large ratios.
RUNTIME_RATIO_CLAMP = (1e-4, 1e4)


class EwmaRatio:
    """Clamped EWMA of measured/predicted ratios.

    ``update`` folds one observation in and returns the new value; the
    value is ``None`` until the first update (callers treat that as
    "no evidence: use the raw model").  The per-update clamp bounds the
    influence of any single wild observation -- walking the estimate a
    long way requires *consistent* evidence.
    """

    __slots__ = ("decay", "clamp", "value", "n")

    def __init__(self, decay: float = DEFAULT_DECAY,
                 clamp: Tuple[float, float] = (0.1, 10.0)):
        self.decay = float(decay)
        self.clamp = (float(clamp[0]), float(clamp[1]))
        self.value: Optional[float] = None
        self.n = 0

    def update(self, ratio: float) -> float:
        ratio = min(max(float(ratio), self.clamp[0]), self.clamp[1])
        prev = 1.0 if self.value is None else self.value
        self.value = (1.0 - self.decay) * prev + self.decay * ratio
        self.n += 1
        return self.value


def octave(v: float) -> int:
    """Shape-bucket coordinate: floor(log2(v)), 0 for v < 1."""
    v = int(v)
    return v.bit_length() - 1 if v > 0 else 0


def kernel_key(kernel: str, R: int, x: int, Q: int) -> Tuple:
    """Feedback bucket for one kernel dispatch.

    ``x`` is the kernel's second extent: pattern chars for the match
    kernels, signature words for the filter kernel.  Octave bucketing
    groups launches that share a cost regime; estimates within a bucket
    differ by at most ~2x from the bucket's edges, well inside the drift
    bound that gates re-pricing.
    """
    return (kernel, octave(R), octave(x), octave(Q))


class _Cell:
    __slots__ = ("ewma", "n", "warmed", "published")

    def __init__(self, decay: float):
        self.ewma = EwmaRatio(decay=decay, clamp=RUNTIME_RATIO_CLAMP)
        self.n = 0              # post-warmup observations
        self.warmed = False     # first (compile-paying) observation seen
        self.published = 1.0    # factor exposed to the planner


class FeedbackStore:
    """Per-(kernel, shape-bucket) observed/estimated runtime feedback.

    * ``observe(key, est, observed)`` -- fold one executed launch in.
      ``est`` must be the feedback-*free* estimate (the planner divides
      its published factor back out before recording), so the EWMA
      converges to truth/model, not a fixed point between them.
    * ``factor(key)`` -- multiplier the planner applies to that bucket's
      price: 1.0 until the bucket has ``min_samples`` post-warmup
      observations AND its EWMA sits outside ``[1/drift_bound,
      drift_bound]``; the EWMA ratio from then on (a re-priced bucket
      keeps tracking, it never snaps back to 1).
    * ``version`` -- bumped whenever some bucket's published factor moves
      materially (> ``publish_tol``); compiled plans watch it and
      re-price lazily on their next run.
    """

    def __init__(self, *, drift_bound: float = 2.0, min_samples: int = 3,
                 decay: float = 0.5, publish_tol: float = 1.2):
        if drift_bound <= 1.0:
            raise ValueError("drift_bound must be > 1")
        self.drift_bound = float(drift_bound)
        self.min_samples = int(min_samples)
        self.decay = float(decay)
        self.publish_tol = float(publish_tol)
        self._cells: Dict[Tuple, _Cell] = {}
        self.version = 0
        self.n_observations = 0       # post-warmup observations folded in
        self.n_mispredictions = 0     # ... whose ratio fell outside bound

    # -- recording ------------------------------------------------------------
    def observe(self, key: Tuple, est_s: float, observed_s: float) -> None:
        if est_s <= 0.0 or observed_s <= 0.0:
            return
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _Cell(self.decay)
        if not cell.warmed:
            # First execution in this bucket pays jit tracing/compilation;
            # that is not a marginal-launch cost, so it must not seed the
            # EWMA (one 100x outlier would re-price the bucket for good).
            cell.warmed = True
            return
        ratio = observed_s / est_s
        cell.ewma.update(ratio)
        cell.n += 1
        self.n_observations += 1
        if not (1.0 / self.drift_bound <= ratio <= self.drift_bound):
            self.n_mispredictions += 1
        self._publish(cell)

    def _publish(self, cell: _Cell) -> None:
        new = self._factor_of(cell)
        moved = max(new, cell.published) / max(
            min(new, cell.published), 1e-12)
        if moved > self.publish_tol:
            cell.published = new
            self.version += 1

    # -- pricing --------------------------------------------------------------
    def _factor_of(self, cell: _Cell) -> float:
        if cell.n < self.min_samples or cell.ewma.value is None:
            return 1.0
        v = cell.ewma.value
        if 1.0 / self.drift_bound <= v <= self.drift_bound:
            # Within the bound the model is "right enough": leave the
            # price alone so near-tie decisions stay deterministic.
            return 1.0 if cell.published == 1.0 else v
        return v

    def factor(self, key: Tuple) -> float:
        cell = self._cells.get(key)
        return 1.0 if cell is None else cell.published

    # -- introspection --------------------------------------------------------
    @property
    def misprediction_rate(self) -> float:
        return (self.n_mispredictions / self.n_observations
                if self.n_observations else 0.0)

    def repriced(self) -> Dict[Tuple, float]:
        """Buckets currently priced away from the model, with factors."""
        return {k: c.published for k, c in self._cells.items()
                if not math.isclose(c.published, 1.0)}

    def keys(self) -> Tuple[Tuple, ...]:
        """Every (kernel, shape-bucket) key seen so far (warmup included).

        The same tuples the obs-layer plan-vs-actual registry keys on
        (both receive the identical ``kernel_key`` from the engine), so
        joining the two accountings is a dict lookup.
        """
        return tuple(self._cells.keys())

    def cell_stats(self, key: Tuple) -> Optional[Dict]:
        """One bucket's state: post-warmup count, EWMA ratio, factor."""
        cell = self._cells.get(key)
        if cell is None:
            return None
        return {"n": cell.n, "warmed": cell.warmed,
                "ewma_ratio": cell.ewma.value,
                "published_factor": cell.published}

    def snapshot(self) -> Dict:
        return {
            "n_observations": self.n_observations,
            "n_mispredictions": self.n_mispredictions,
            "misprediction_rate": round(self.misprediction_rate, 4),
            "n_buckets": len(self._cells),
            "n_repriced": len(self.repriced()),
            # JSON-safe per-bucket factors for the re-priced set: the
            # drift a ServiceStats snapshot should make visible, not
            # just count.
            "repriced_factors": {
                "/".join(str(p) for p in k): round(v, 4)
                for k, v in sorted(self.repriced().items(),
                                   key=lambda kv: str(kv[0]))},
            "version": self.version,
        }
