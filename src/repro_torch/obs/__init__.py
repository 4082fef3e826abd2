"""Observability for the match stack: spans + metrics + plan-vs-actual.

One ``Observability`` object is threaded through a ``MatchEngine`` and
everything it owns (corpus, index, merger, service, bank).  Spans are
off by default and free when off; the metrics registry is always on
(it is pure accounting and never influences plans, so -- unlike
``record_runtimes`` -- it is safe multi-process).

Typical use::

    obs = Observability(spans=True)
    eng = MatchEngine(fragments, obs=obs)
    eng.match("pattern")
    obs.tracer.write_chrome("trace.json")   # open in ui.perfetto.dev
    obs.metrics.plan_actual_summary()        # est-vs-observed per bucket

This is the PyTorch port's copy of ``repro.obs``; the only difference is
the profiler hook (``torch.profiler.record_function``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.obs.metrics import (Counter, Gauge, LogHistogram,
                               MetricsRegistry, PlanActual,
                               DEFAULT_BASE, DEFAULT_DRIFT_BOUND,
                               plan_key_str)
from repro_torch.obs.trace import (NOOP_SPAN, PORT_SPANS, STAGES, Span,
                                   Tracer)

__all__ = [
    "Counter", "Gauge", "LogHistogram", "MetricsRegistry",
    "NULL_OBS", "NOOP_SPAN", "Observability", "PlanActual", "PORT_SPANS",
    "Span", "STAGES", "Tracer", "plan_key_str",
    "DEFAULT_BASE", "DEFAULT_DRIFT_BOUND",
]


class Observability:
    """Tracer + metrics registry, one handle for the whole stack."""

    def __init__(self, *, spans: bool = False, profiler: bool = False,
                 max_spans: int = 100_000, keep_records: int = 4096):
        self.tracer = Tracer(enabled=spans, profiler=profiler,
                             max_spans=max_spans)
        self.metrics = MetricsRegistry(keep_records=keep_records)

    @property
    def enabled(self) -> bool:
        """True when spans are being recorded."""
        return self.tracer.enabled

    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        """Shorthand for ``self.tracer.span`` (no-op when disabled)."""
        return self.tracer.span(name, attrs)

    def record_plan_actual(self, key: Tuple, est_s: float,
                           observed_s: float) -> None:
        self.metrics.record_plan_actual(key, est_s, observed_s)


# Shared default for components constructed without an engine (e.g. a
# bare PackedCorpus or a PatternBank's passthrough merger): spans off,
# metrics recorded but typically never read.  Engines replace it with
# their own instance.
NULL_OBS = Observability()
