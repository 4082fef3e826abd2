"""Counters, gauges, log-bucketed histograms, plan-vs-actual series.

The registry is the queryable side of the observability layer
(DESIGN.md Sec. 3l): spans answer "where did *this request* go",
metrics answer "what does the fleet look like over the whole run".
Zero dependencies -- stdlib only -- so every subsystem can record into
it unconditionally.

``LogHistogram`` gives p50/p95/p99 without storing samples: values land
in geometric buckets of width ``2**0.25`` (quarter-octave, the same
quantization the calibration table uses), so any reported quantile is
within one bucket -- a factor of at most ``2**0.25 ~ 1.19`` -- of the
exact sample quantile, with O(#occupied buckets) memory over an
unbounded run.  This replaces the old ``ServiceStats`` running-sum
latency accounting, which could report an average but no percentile at
all without a sample list.

``record_plan_actual`` is the widened feedback loop: every executed
launch reports ``(est_seconds, observed_seconds)`` under its
``(kernel, shape-bucket)`` key -- the *same* key and the *same* floats
handed to ``FeedbackStore.observe`` -- whether or not runtime feedback
is enabled.  Feedback mutates plans (and so stays off by default
multi-process, where per-process clocks would diverge SPMD plans);
the registry only *observes*, so it is always on and mispredict rate
per bucket is queryable from any run.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

# Quarter-octave buckets: matches calibrate.py's quantization so a
# histogram bucket and a feedback shape-bucket mean the same thing.
DEFAULT_BASE = 2.0 ** 0.25
# Plans whose observed/estimated ratio leaves [1/b, b] count as
# mispredicted -- same bound FeedbackStore uses to re-price a bucket.
DEFAULT_DRIFT_BOUND = 2.0


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (queue depth, hit rate)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class LogHistogram:
    """Log-bucketed histogram: quantiles without sample storage.

    Positive values land in bucket ``round(log(v)/log(base))``; a
    bucket's representative value is ``base**k`` (geometric center), so
    ``quantile`` is exact to within half a bucket plus rank rounding --
    bounded by one bucket width total (asserted against numpy in
    tests).  Zero/negative values are legal (timer underflow) and land
    in a dedicated underflow bucket reported as 0.0.
    """

    __slots__ = ("base", "_log_base", "buckets", "n_under", "count",
                 "sum", "min", "max")

    def __init__(self, base: float = DEFAULT_BASE) -> None:
        if base <= 1.0:
            raise ValueError(f"base must be > 1, got {base}")
        self.base = float(base)
        self._log_base = math.log(self.base)
        self.buckets: Dict[int, int] = {}
        self.n_under = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.n_under += 1
            return
        k = int(round(math.log(v) / self._log_base))
        self.buckets[k] = self.buckets.get(k, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Value at rank ``q`` in [0, 1]; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        # Rank among recorded values, nearest-rank definition; the
        # underflow bucket sorts first.
        target = q * (self.count - 1)
        seen = self.n_under
        if target < seen:
            return 0.0
        rep = 0.0
        for k in sorted(self.buckets):
            seen += self.buckets[k]
            if target < seen:
                rep = self.base ** k
                break
        else:
            rep = self.base ** max(self.buckets) if self.buckets else 0.0
        # Clamp to the observed extremes: the top/bottom bucket centers
        # can overshoot the true min/max by half a bucket.
        if self.max > -math.inf:
            rep = min(rep, self.max)
        if self.min > 0.0:
            rep = max(rep, self.min)
        return rep

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "count": self.count,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }
        out.update(self.percentiles())
        return out


class PlanActual:
    """One (kernel, shape-bucket)'s est-vs-observed series.

    Keeps aggregate counts plus a log-histogram of observed/estimated
    ratios -- drift direction and spread per bucket, no sample storage.
    """

    __slots__ = ("n", "n_mispredict", "ratio_hist", "last_est",
                 "last_obs", "drift_bound")

    def __init__(self, drift_bound: float = DEFAULT_DRIFT_BOUND) -> None:
        self.n = 0
        self.n_mispredict = 0
        self.ratio_hist = LogHistogram()
        self.last_est = 0.0
        self.last_obs = 0.0
        self.drift_bound = float(drift_bound)

    def record(self, est_s: float, observed_s: float) -> None:
        self.n += 1
        self.last_est = float(est_s)
        self.last_obs = float(observed_s)
        if est_s > 0.0 and observed_s > 0.0:
            ratio = observed_s / est_s
            self.ratio_hist.record(ratio)
            if ratio > self.drift_bound or ratio < 1.0 / self.drift_bound:
                self.n_mispredict += 1
        else:
            # Degenerate estimate or clock underflow: mispredicted by
            # definition, but no meaningful ratio to bucket.
            self.n_mispredict += 1

    @property
    def mispredict_rate(self) -> float:
        return self.n_mispredict / self.n if self.n else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {
            "n": self.n,
            "mispredict_rate": self.mispredict_rate,
            "ratio_p50": self.ratio_hist.quantile(0.50),
            "ratio_p95": self.ratio_hist.quantile(0.95),
            "last_est_s": self.last_est,
            "last_obs_s": self.last_obs,
        }


def plan_key_str(key: Tuple) -> str:
    """JSON-safe form of a feedback ``kernel_key`` tuple."""
    return "/".join(str(p) for p in key)


class MetricsRegistry:
    """Named counters/gauges/histograms plus plan-vs-actual series.

    Instruments are created on first use and live for the registry's
    lifetime.  ``keep_records`` bounds an optional raw record list used
    by tests to check bit-for-bit agreement with ``FeedbackStore``;
    aggregates are unaffected when it saturates.
    """

    def __init__(self, *, keep_records: int = 4096,
                 drift_bound: float = DEFAULT_DRIFT_BOUND) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, LogHistogram] = {}
        self.plan_actual: Dict[Tuple, PlanActual] = {}
        self.plan_actual_records: List[Tuple[Tuple, float, float]] = []
        self.keep_records = int(keep_records)
        self.drift_bound = float(drift_bound)

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  base: float = DEFAULT_BASE) -> LogHistogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = LogHistogram(base)
        return h

    # -- plan-vs-actual --------------------------------------------------------
    def record_plan_actual(self, key: Tuple, est_s: float,
                           observed_s: float) -> None:
        """One executed launch: estimate vs what the clock said.

        ``key`` is the exact ``feedback.kernel_key`` tuple and the
        floats are the exact values passed to ``FeedbackStore.observe``
        when runtime feedback is on -- callers compute them once and
        hand them to both sinks, so the two accountings agree
        bit-for-bit (tested).
        """
        cell = self.plan_actual.get(key)
        if cell is None:
            cell = self.plan_actual[key] = PlanActual(self.drift_bound)
        cell.record(est_s, observed_s)
        if len(self.plan_actual_records) < self.keep_records:
            self.plan_actual_records.append(
                (key, float(est_s), float(observed_s)))

    def mispredict_rate(self, kernel: Optional[str] = None) -> float:
        """Aggregate mispredict rate, optionally for one kernel."""
        n = bad = 0
        for key, cell in self.plan_actual.items():
            if kernel is not None and key and key[0] != kernel:
                continue
            n += cell.n
            bad += cell.n_mispredict
        return bad / n if n else 0.0

    def plan_actual_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-bucket series keyed by ``kernel/oR/ox/oQ`` strings."""
        return {plan_key_str(k): cell.snapshot()
                for k, cell in sorted(self.plan_actual.items(),
                                      key=lambda kv: plan_key_str(kv[0]))}

    # -- export ----------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Everything, JSON-safe."""
        return {
            "counters": {k: c.value
                         for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self.histograms.items())},
            "plan_actual": self.plan_actual_summary(),
            "plan_mispredict_rate": self.mispredict_rate(),
        }
