"""Match-engine subsystem of the PyTorch port (counterpart of ``repro.match``).

* ``PackedCorpus`` -- fragments packed once into device-resident SWAR and
  one-hot forms, growable in place.
* ``MatchQuery`` -- frozen, hashable, declarative query IR (exact / IUPAC
  / N-wildcard predicates, reduction spec, row subset, backend hints).
* ``Planner`` / ``Plan`` -- roofline kernel selection (swar / mxu / ref)
  priced against the H100, plus all tile/pad geometry for one query.
* ``MatchEngine`` / ``CompiledMatch`` / ``MatchResult`` -- query compiler
  over a streaming executor with fused best / top-k / threshold
  reductions per row chunk, and filter-then-verify for selective
  threshold queries.
* ``CorpusIndex`` -- device-resident q-gram row signatures (the filter
  stage's operand), attached to an engine by default.
* ``PatternBank`` / ``HitTicket`` / ``StandingPattern`` -- standing
  queries: thousands of resident patterns scanned against each document
  batch in one verify launch, behind a pattern-side prefilter.
* ``MatchService`` / ``MatchTicket`` / ``IngestTicket`` / ``ServiceStats``
  -- the multi-tenant front end: coalesced ticks priced by
  ``Planner.plan_batch`` (``BatchPlan``), a generation-keyed result
  cache, and ingest scanned against a standing bank before it splices
  into a sliding-window corpus.

Calibration (``CalibrationTable``, ``autotune``, ``load_cost_source``)
is not ported yet.
"""

from repro_torch.obs import MetricsRegistry, Observability, Tracer

from .corpus import PackedCorpus
from .engine import CompiledMatch, MatchEngine, MatchResult
from .feedback import EwmaRatio, FeedbackStore, kernel_key
from .index import CorpusIndex, FilterOperands, build_query_filter
from .planner import BankPlan, BatchPlan, FilterContext, Plan, Planner
from .query import MatchQuery, as_masks, as_query
from .service import IngestTicket, MatchService, MatchTicket, ServiceStats
from .standing import HitTicket, PatternBank, StandingPattern

__all__ = ["PackedCorpus", "Planner", "Plan", "BatchPlan", "FilterContext",
           "BankPlan", "MatchQuery", "as_query", "as_masks", "CompiledMatch",
           "MatchEngine", "MatchResult", "MatchService", "MatchTicket",
           "IngestTicket", "ServiceStats", "CorpusIndex", "FilterOperands",
           "build_query_filter", "PatternBank", "HitTicket",
           "StandingPattern", "EwmaRatio", "FeedbackStore", "kernel_key",
           "Observability", "Tracer", "MetricsRegistry"]
