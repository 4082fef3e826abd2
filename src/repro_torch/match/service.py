"""Multi-tenant match query service (port of ``repro.match.service``).

``MatchService`` fronts a shared ``MatchEngine`` for many concurrent
callers.  Each caller's query is tiny; what kills throughput at scale is
that every one of them pays a full kernel launch -- exactly the
launch-overhead regime the planner's roofline flags as worst.  The paper's
substrate amortizes this by searching many patterns against the resident
reference in lock step (Sec. 3.4); the service is the GPU analogue:

* **Queue + tick.**  ``submit`` enqueues a request and returns a
  ``MatchTicket``; ``tick`` drains the queue once.  The service is
  cooperative (no threads): callers drive it via ``tick`` / ``flush`` /
  ``MatchTicket.wait``.
* **Declarative requests.**  Every submission is normalized to a frozen
  ``MatchQuery`` at the door (legacy kwargs ride the ``as_query`` shim),
  so validation happens at submit time and both the result cache and the
  coalescing groups key off the query IR itself.
* **Coalescing.**  Pending shared-mode queries that are compatible -- same
  pattern length, predicate kind, reduction, row subset (by content),
  backend override, chunking and filter hint -- are grouped, priced by
  ``Planner.plan_batch`` (one fused ``mode="batched"`` launch vs. Q
  sequential launches), and executed the cheaper way.  Per-request
  results are scattered back from the batched arrays, bit-identical to
  what Q separate ``MatchEngine.match`` calls would return.
* **Result cache.**  An LRU keyed by the query, dropped whenever
  ``PackedCorpus.generation`` changes, so a row write or an ingested
  document never serves stale scores.
* **Online ingestion.**  ``ingest`` enqueues new corpus rows; each tick
  applies all pending ingests as **one** batched in-place ``append_rows``,
  then serves the tick's queries against the grown corpus.  The corpus
  never repacks its resident rows and the engine survives growth.
* **Standing queries.**  With a ``PatternBank`` attached, every tick's
  fused ingest batch is scanned against the whole bank in **one**
  roles-swapped launch *before* it splices into the corpus (TTL-expired
  patterns are retired first).  ``window_rows`` turns the corpus into a
  sliding window: after each append the oldest live rows beyond the
  window are tombstoned and the corpus compacts once the dead fraction
  crosses ``compact_dead_frac``.
* **Stats.**  Per-request latency (a log-bucketed histogram, so the
  snapshot reports p50/p95/p99) plus launch, coalescing, cache, ingest,
  filter-routing and bank counters; ``ServiceStats.snapshot()`` is what
  the launcher reports.

Every call runs where the engine's corpus lives: on the card, a kernel
that fails to build or launch raises inside its group and fails that
group's tickets (tenant isolation), never the rest of the tick.  One
device: the shard fields take their single-device values.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import LogHistogram

from .engine import MatchEngine, MatchResult, result_nbytes
from .planner import BatchPlan
from .query import _UNSET, MatchQuery, as_query


@dataclasses.dataclass
class ServiceStats:
    """Counters + latency record for one service instance."""

    n_submitted: int = 0
    n_completed: int = 0
    n_cache_hits: int = 0
    n_launches: int = 0               # engine.match calls issued
    n_coalesced_launches: int = 0     # launches that fused >= 2 queries
    n_coalesced_queries: int = 0      # queries served by fused launches
    n_sequential_fallback: int = 0    # grouped queries the pricing split up
    n_failed: int = 0                 # requests completed with an error
    n_ingested_rows: int = 0          # corpus rows appended via ingest
    n_ingest_batches: int = 0         # append_rows calls (one per tick max)
    n_ticks: int = 0                  # tick() calls
    launches_last_tick: int = 0       # engine launches in the latest tick
    n_filtered_launches: int = 0      # launches that ran filter-then-verify
    sum_survivor_frac: float = 0.0    # running sum over filtered launches
    # Per-request latency distribution: a log-bucketed histogram (exact
    # bucket counts over the whole run, O(#occupied buckets) state)
    # replaces the old running-sum-only accounting, so the snapshot can
    # report p50/p95/p99 -- which a long-tail launch distribution needs;
    # the mean alone buried the tail.  ``total_latency_s`` and
    # ``avg_latency_s`` remain below as thin views over it.
    latency_hist: LogHistogram = dataclasses.field(
        default_factory=LogHistogram, repr=False)
    n_shards: int = 1                 # engine row shards (mesh-resident)
    shard_rows: Optional[List[int]] = None   # live rows per shard
    # Cross-shard merge accounting (DESIGN.md Sec. 3k): which path the
    # engine's reductions combine on ("device" = collectives under
    # shard_map, "host" = single-shard pulls) and the cumulative
    # estimated collective bytes those merges moved -- the measured
    # counterpart of Plan.est_collective_bytes, so mispriced merges are
    # visible in the same snapshot the feedback loop reads.
    merge_path: str = "host"
    collective_bytes: int = 0
    # Cost-model provenance (DESIGN.md Sec. 3i): which source prices the
    # planner's decisions ("static" | "calibrated:<digest8>") and the
    # runtime-feedback state (observation/misprediction counters, number
    # of re-priced shape buckets) -- refreshed per tick from the planner.
    cost_source: str = "static"
    feedback: Optional[Dict] = None
    # Standing-query / windowed-corpus counters (DESIGN.md Sec. 3j):
    # bank launch counts mirror the attached PatternBank per tick, so
    # "one ingest batch = one fused bank launch" is auditable here.
    n_bank_launches: int = 0          # fused bank verify dispatches
    n_bank_prefilter_launches: int = 0
    n_bank_hits: int = 0              # standing hits delivered via ingest
    n_evicted_rows: int = 0           # rows tombstoned by the window
    n_compactions: int = 0            # corpus compactions triggered
    bank: Optional[Dict] = None       # PatternBank.stats() snapshot
    # Obs-layer views (DESIGN.md Sec. 3l), refreshed per tick: per-stage
    # wall seconds summed over the latest tick's launches (from the
    # ``MatchResult.timings`` span breakdowns) and the registry's
    # plan-vs-actual accounting, so "where did the tick go" and "how
    # wrong were the estimates" read out of the same snapshot the
    # benchmarks and the launcher already grep.
    timings_last_tick: Optional[Dict] = None
    plan_actual: Optional[Dict] = None
    plan_mispredict_rate: float = 0.0
    _t_first_submit: Optional[float] = None
    _t_last_complete: Optional[float] = None

    @property
    def total_latency_s(self) -> float:
        """Deprecated running-sum view; kept for callers of the old
        field.  The histogram is the source of truth now -- prefer
        ``latency_hist`` / the snapshot percentiles."""
        return self.latency_hist.sum

    @property
    def avg_latency_s(self) -> float:
        return (self.total_latency_s / self.n_completed
                if self.n_completed else 0.0)

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of completed requests served from the result cache."""
        return (self.n_cache_hits / self.n_completed
                if self.n_completed else 0.0)

    @property
    def avg_launches_per_tick(self) -> float:
        return self.n_launches / self.n_ticks if self.n_ticks else 0.0

    @property
    def filter_hit_rate(self) -> float:
        """Fraction of engine launches routed through the q-gram filter."""
        return (self.n_filtered_launches / self.n_launches
                if self.n_launches else 0.0)

    @property
    def avg_survivor_frac(self) -> float:
        """Mean measured post-filter row fraction over filtered launches."""
        return (self.sum_survivor_frac / self.n_filtered_launches
                if self.n_filtered_launches else 0.0)

    @property
    def shard_balance(self) -> float:
        """Max/min live-row ratio across shards (1.0 = perfectly even).

        Cyclic row placement keeps this <= (j+1)/j for per-shard count j,
        so it converges to 1.0 as the corpus grows; the shard benchmark
        asserts <= 1.1 after ingest.
        """
        if not self.shard_rows or len(self.shard_rows) < 2:
            return 1.0
        lo = min(self.shard_rows)
        return float(max(self.shard_rows)) / lo if lo else float("inf")

    @property
    def qps(self) -> float:
        """Completed queries per second of wall time, submit to done."""
        if (self._t_first_submit is None or self._t_last_complete is None
                or self._t_last_complete <= self._t_first_submit):
            return 0.0
        return self.n_completed / (self._t_last_complete
                                   - self._t_first_submit)

    def snapshot(self) -> Dict[str, float]:
        return {
            "n_submitted": self.n_submitted,
            "n_completed": self.n_completed,
            "n_cache_hits": self.n_cache_hits,
            "n_launches": self.n_launches,
            "n_coalesced_launches": self.n_coalesced_launches,
            "n_coalesced_queries": self.n_coalesced_queries,
            "n_sequential_fallback": self.n_sequential_fallback,
            "n_failed": self.n_failed,
            "n_ingested_rows": self.n_ingested_rows,
            "n_ingest_batches": self.n_ingest_batches,
            "n_ticks": self.n_ticks,
            "launches_last_tick": self.launches_last_tick,
            "avg_launches_per_tick": round(self.avg_launches_per_tick, 2),
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "n_filtered_launches": self.n_filtered_launches,
            "filter_hit_rate": round(self.filter_hit_rate, 4),
            "avg_survivor_frac": round(self.avg_survivor_frac, 4),
            "avg_latency_s": round(self.avg_latency_s, 6),
            "latency_p50_s": round(self.latency_hist.quantile(0.50), 6),
            "latency_p95_s": round(self.latency_hist.quantile(0.95), 6),
            "latency_p99_s": round(self.latency_hist.quantile(0.99), 6),
            "qps": round(self.qps, 1),
            "n_shards": self.n_shards,
            "shard_rows": list(self.shard_rows or []),
            "shard_balance": (round(self.shard_balance, 4)
                              if self.shard_rows else 1.0),
            "merge_path": self.merge_path,
            "collective_bytes": self.collective_bytes,
            "cost_source": self.cost_source,
            "misprediction_rate": (self.feedback or {}).get(
                "misprediction_rate", 0.0),
            "feedback": dict(self.feedback or {}),
            "n_bank_launches": self.n_bank_launches,
            "n_bank_prefilter_launches": self.n_bank_prefilter_launches,
            "n_bank_hits": self.n_bank_hits,
            "n_evicted_rows": self.n_evicted_rows,
            "n_compactions": self.n_compactions,
            "bank": dict(self.bank) if self.bank is not None else None,
            "timings": dict(self.timings_last_tick or {}),
            "plan_actual": dict(self.plan_actual or {}),
            "plan_mispredict_rate": round(self.plan_mispredict_rate, 4),
        }


def _query_columns(res: MatchResult, q: int, k_q: int
                   ) -> Dict[str, np.ndarray]:
    """Column ``q`` of each per-row and top-k array of a fused batched
    result (views, by ``MatchResult`` field; top-k cut to ``k_q``)."""
    cols = {"best_locs": res.best_locs[:, q],
            "best_scores": res.best_scores[:, q]}
    if res.scores is not None:
        cols["scores"] = res.scores[:, :, q]
    if res.topk_rows is not None:
        kk = min(k_q, res.topk_rows.shape[0])
        cols["topk_rows"] = res.topk_rows[:kk, q]
        cols["topk_scores"] = res.topk_scores[:kk, q]
    return cols


def _drive_until_done(ticket, max_ticks: int, what: str) -> None:
    """Tick the ticket's service until it completes (shared wait loop)."""
    ticks = 0
    while not ticket.done:
        if ticks >= max_ticks:
            raise RuntimeError(f"{what} did not complete "
                               f"within {max_ticks} ticks")
        ticket._service.tick()
        ticks += 1


class MatchTicket:
    """Handle for one submitted query; fill by driving ``service.tick``.

    A request that fails at execution time (e.g. a pattern longer than the
    fragment) completes with ``error`` set instead of poisoning the tick
    for unrelated tenants; ``wait`` re-raises it for this caller only.
    """

    __slots__ = ("_service", "done", "result", "cached", "latency_s",
                 "error")

    def __init__(self, service: "MatchService"):
        self._service = service
        self.done = False
        self.result: Optional[MatchResult] = None
        self.cached = False
        self.latency_s: Optional[float] = None
        self.error: Optional[Exception] = None

    def wait(self, max_ticks: int = 1024) -> MatchResult:
        """Drive the service until this ticket completes."""
        _drive_until_done(self, max_ticks, "ticket")
        if self.error is not None:
            raise self.error
        return self.result


class IngestTicket:
    """Handle for one ``ingest`` submission; fills on the next tick.

    ``start`` / ``n`` give the corpus row range the submission landed in
    once ``done``; rows from all same-tick submissions are appended in
    submission order by one batched ``append_rows``.  With a standing
    ``PatternBank`` attached, ``bank_ticket`` carries the tick's shared
    ``HitTicket`` (one fused scan covers every same-tick submission;
    filter its ``corpus_rows`` by ``[start, start + n)`` for this
    submission's hits).
    """

    __slots__ = ("_service", "done", "start", "n", "bank_ticket")

    def __init__(self, service: "MatchService", n: int):
        self._service = service
        self.done = False
        self.start: Optional[int] = None
        self.n = n
        self.bank_ticket = None

    def wait(self, max_ticks: int = 1024) -> int:
        """Drive the service until the rows are appended; returns start."""
        _drive_until_done(self, max_ticks, "ingest")
        return self.start


@dataclasses.dataclass
class _Pending:
    ticket: MatchTicket
    query: MatchQuery
    t_submit: float
    group_key: Optional[Tuple]         # None -> not coalescible


class MatchService:
    """Micro-batched multi-tenant front end over one shared ``MatchEngine``.

    Single-threaded by design: ``submit`` never blocks, ``tick`` does all
    the work.  Results handed out (and cached) are shared arrays -- treat
    them as read-only.
    """

    def __init__(self, engine: MatchEngine, *, cache_size: int = 256,
                 bank=None, window_rows: Optional[int] = None,
                 compact_dead_frac: float = 0.5):
        """``bank`` attaches a ``PatternBank`` scanned at every ingest;
        ``window_rows`` bounds the corpus to a sliding window (oldest live
        rows are tombstoned past it, and the corpus compacts once
        ``n_dead / n_rows`` reaches ``compact_dead_frac``)."""
        self.engine = engine
        # One observability surface per stack: the service records into
        # the engine's tracer/registry, never a second one.
        self.obs = engine.obs
        self.cache_size = int(cache_size)
        if bank is not None and (bank.fragment_chars
                                 != engine.corpus.fragment_chars):
            raise ValueError(
                f"bank fragment_chars={bank.fragment_chars} != corpus "
                f"fragment_chars={engine.corpus.fragment_chars}")
        self.bank = bank
        if bank is not None:
            # One transfer ledger per service: bank pulls count alongside
            # the engine's cross-shard merges (DESIGN.md Sec. 3k) -- and
            # one obs surface, so bank scan spans nest in the same trace.
            bank.merger = engine.merger
            bank.obs = engine.obs
        if window_rows is not None and int(window_rows) < 1:
            raise ValueError("window_rows must be >= 1")
        self.window_rows = None if window_rows is None else int(window_rows)
        if not (0.0 < float(compact_dead_frac) <= 1.0):
            raise ValueError("compact_dead_frac must be in (0, 1]")
        self.compact_dead_frac = float(compact_dead_frac)
        self.stats = ServiceStats()
        self._tick_timings: Dict[str, float] = {}
        self._queue: List[_Pending] = []
        self._ingest_queue: List[Tuple[IngestTicket, np.ndarray]] = []
        self._cache: "OrderedDict[MatchQuery, MatchResult]" = OrderedDict()
        self._cache_generation = engine.corpus.generation
        self._note_shards()
        self._note_calibration()

    # -- submission -----------------------------------------------------------
    def submit(self, patterns, *, reduction=_UNSET, k=_UNSET,
               threshold=_UNSET, rows=_UNSET, backend=_UNSET,
               mode=_UNSET, filter=_UNSET) -> MatchTicket:
        """Enqueue one query; returns a ticket (drive ``tick`` to fill it).

        ``patterns`` is a ``MatchQuery`` (any explicit kwarg alongside it
        is rejected) or a uint8 code array with the legacy kwargs
        (defaults: reduction="best", k=10; normalized through
        ``as_query``, so malformed queries -- unknown reduction,
        out-of-range codes -- fail *here*, at submit).  Only shared-mode
        (1-D pattern) queries coalesce; 2-D (per-row / batched) queries
        pass through as singleton launches.
        """
        tr = self.obs.tracer
        with tr.span("service.enqueue"):
            query = as_query(patterns, reduction=reduction, k=k,
                             threshold=threshold, rows=rows,
                             backend=backend, mode=mode, filter=filter)
            # Coalescing key straight off the IR: 1-D queries whose fused
            # batched execution is well-defined group by everything that
            # must agree for one launch to serve them all.  Predicate kind
            # is part of the key so exact groups keep riding the exact
            # kernels; the filter hint is part of it so the fused query
            # inherits one unambiguous routing decision (the engine
            # filters fused batched threshold queries with a survivor
            # union, so coalesced groups still ride the index
            # transparently).
            coalescible = len(query.shape) == 1
            group_key = ((query.pattern_chars, query.reduction,
                          query.rows_b, query.backend, query.chunk_rows,
                          query.is_exact, query.filter)
                         if coalescible else None)
            ticket = MatchTicket(self)
            now = time.perf_counter()
            self._queue.append(_Pending(ticket=ticket, query=query,
                                        t_submit=now, group_key=group_key))
            self.stats.n_submitted += 1
            if self.stats._t_first_submit is None:
                self.stats._t_first_submit = now
        return ticket

    def ingest(self, rows) -> IngestTicket:
        """Enqueue corpus rows for online, in-place appending.

        ``rows`` is a (n, F) or (F,) uint8 code array.  Appends are
        batched per tick: ``tick`` concatenates every pending submission
        and applies them with **one** ``PackedCorpus.append_rows`` call
        before running that tick's queries, so queries submitted in the
        same tick see the grown corpus and the result cache invalidates
        exactly once (generation-keyed).  Width is validated here, at the
        door, like query validation in ``submit``.
        """
        rows = np.asarray(rows, np.uint8)
        if rows.ndim == 1:
            rows = rows[None, :]
        F = self.engine.corpus.fragment_chars
        if rows.ndim != 2 or rows.shape[1] != F:
            raise ValueError(f"ingested rows must be (n, {F}); got shape "
                             f"{rows.shape}")
        ticket = IngestTicket(self, rows.shape[0])
        if rows.shape[0] == 0:
            # Empty batch: a complete no-op.  Queueing it would charge an
            # ingest batch, a zero-row append launch, a generation bump
            # and therefore a spurious result-cache drop at the next tick.
            ticket.start = self.engine.corpus.n_rows
            ticket.done = True
            return ticket
        # Copy: the append happens at tick time and the caller's buffer
        # must not mutate underneath the queue.
        self._ingest_queue.append((ticket, np.array(rows)))
        return ticket

    def match(self, patterns, **kw) -> MatchResult:
        """Blocking convenience: submit + tick until done."""
        return self.submit(patterns, **kw).wait()

    def flush(self, max_ticks: int = 1024) -> None:
        """Tick until the query and ingest queues drain."""
        ticks = 0
        while self._queue or self._ingest_queue:
            if ticks >= max_ticks:
                raise RuntimeError("queue did not drain")
            self.tick()
            ticks += 1

    # -- cache ----------------------------------------------------------------
    def _cache_get(self, key: MatchQuery) -> Optional[MatchResult]:
        res = self._cache.get(key)
        if res is not None:
            self._cache.move_to_end(key)
        return res

    def _cache_put(self, key: MatchQuery, res: MatchResult) -> None:
        self._cache[key] = res
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    # -- completion -----------------------------------------------------------
    def _complete(self, pend: _Pending, res: Optional[MatchResult],
                  cached: bool, error: Optional[Exception] = None) -> None:
        t = pend.ticket
        t.result = res
        t.cached = cached
        t.error = error
        t.done = True
        now = time.perf_counter()
        t.latency_s = now - pend.t_submit
        self.stats.latency_hist.record(t.latency_s)
        self.stats.n_completed += 1
        self.stats.n_cache_hits += int(cached)
        self.stats.n_failed += int(error is not None)
        self.stats._t_last_complete = now

    # -- execution ------------------------------------------------------------
    def _note_filter(self, res: MatchResult) -> None:
        """Fold one completed launch's routing into the filter counters.

        ``n_launches`` itself counts *attempted* launches and increments
        before the engine call (a failing tenant still paid a launch);
        only the filter-routing counters need the result.
        """
        if res.survivor_frac is not None:
            self.stats.n_filtered_launches += 1
            self.stats.sum_survivor_frac += res.survivor_frac

    def _note_merge(self, res: MatchResult) -> None:
        """Fold one launch's cross-shard merge accounting into the stats."""
        self.stats.merge_path = res.merge_path
        self.stats.collective_bytes += int(res.collective_bytes)

    def _note_timings(self, res: MatchResult) -> None:
        """Fold one launch's per-stage span breakdown into the tick's.

        Only present when the tracer is enabled (``MatchResult.timings``
        is ``None`` otherwise); accumulated once per *launch*, so a
        coalesced group charges its stages once, not per scattered view.
        """
        if res.timings is None:
            return
        acc = self._tick_timings
        for stage, secs in res.timings.items():
            acc[stage] = acc.get(stage, 0.0) + secs

    def _run_single(self, pend: _Pending) -> MatchResult:
        self.stats.n_launches += 1
        res = self.engine.match(pend.query)
        self._note_filter(res)
        self._note_merge(res)
        self._note_timings(res)
        return res

    def _scatter(self, res: MatchResult, q: int, n_q: int,
                 k_q: int) -> MatchResult:
        """Per-query result of one fused batched result (column ``q``).

        Bit-identical to the single shared-mode query: the batched kernels
        score each pattern column independently, so slicing column ``q``
        out of the (R, ..., Q) tensors reproduces the solo run exactly.
        The engine assembles a batched best pair query-major (F-contiguous
        (R, Q)), so its columns copy as contiguous memory; every array
        returned is an owning copy, so a held result does not keep the
        whole fused batch alive.
        """
        out = MatchResult(plan=res.plan,
                          n_chunks=res.n_chunks,
                          survivor_rows=res.survivor_rows,
                          survivor_frac=res.survivor_frac,
                          n_shards=res.n_shards,
                          merge_path=res.merge_path,
                          collective_bytes=res.collective_bytes,
                          **{f: c.copy() for f, c in
                             _query_columns(res, q, k_q).items()})
        # Scattered results share the fused launch's stage breakdown: the
        # stages ran once for the whole group.
        out.timings = res.timings
        if res.hits is not None:
            mine = res.hits[res.hits[:, 2] == q]
            out.hits = np.take(mine, [0, 1, 3], axis=1)
        return out

    def _fuse_queries(self, members: List[List[_Pending]]) -> MatchQuery:
        """Stack one group's shared-mode queries into one batched query.

        Pure IR-to-IR lowering: stacked accept masks + per-query k /
        threshold vectors; everything else (rows, backend, chunking) is
        identical across the group by construction of the group key.
        """
        first = members[0][0].query
        stacked = np.stack([m[0].query.masks for m in members])
        kw = dict(mode="batched", reduction=first.reduction,
                  rows=first.rows, backend=first.backend,
                  chunk_rows=first.chunk_rows, filter=first.filter)
        if first.reduction == "topk":
            kw["k"] = [m[0].query.k[0] for m in members]
        if first.reduction == "threshold":
            kw["threshold"] = [m[0].query.threshold[0] for m in members]
        return MatchQuery.from_masks(stacked, **kw)

    def _run_group(self, grp: List[_Pending]) -> None:
        """Execute one compatible group: coalesced or sequential.

        Within the group, requests with identical queries share one
        executed column (same-tick dedup).
        """
        uniq: "OrderedDict[MatchQuery, List[_Pending]]" = OrderedDict()
        for p in grp:
            uniq.setdefault(p.query, []).append(p)
        members = list(uniq.values())
        n_q = len(members)
        first = members[0][0].query
        n_rows = (len(first.rows) if first.rows is not None
                  else self.engine.corpus.n_rows)
        tr = self.obs.tracer
        bp: Optional[BatchPlan] = None
        if n_q > 1 and n_rows > 0:
            # Empty subsets skip pricing: the engine answers them without
            # a launch, and the planner (rightly) rejects 0-row workloads.
            with tr.span("service.plan") as sp:
                bp = self.engine.planner.plan_batch(
                    n_rows=n_rows,
                    fragment_chars=self.engine.corpus.fragment_chars,
                    pattern_chars=first.pattern_chars, n_queries=n_q,
                    backend=first.backend, chunk_rows=first.chunk_rows,
                    predicate=first.predicate,
                    n_shards=self.engine.n_shards,
                    one_card=self.engine.one_card)
                if tr.enabled:
                    sp.set("n_queries", bp.n_queries)
                    sp.set("coalesced", bp.coalesced)
                    sp.set("est_coalesced_s", bp.est_coalesced_s)
                    sp.set("est_sequential_s", bp.est_sequential_s)
                    sp.set("reason", bp.reason)
        if bp is not None and bp.coalesced:
            with tr.span("service.coalesce",
                         {"n_queries": len(grp), "n_uniq": n_q}
                         if tr.enabled else None):
                fused = self._fuse_queries(members)
                self.stats.n_launches += 1
                self.stats.n_coalesced_launches += 1
                self.stats.n_coalesced_queries += len(grp)
                batched = self.engine.match(fused)
                self._note_filter(batched)
                self._note_merge(batched)
                self._note_timings(batched)
                with tr.span("service.scatter") as sp:
                    n_bytes = n_strided = 0
                    for q, mem in enumerate(members):
                        k_q = mem[0].query.k[0] if mem[0].query.k else 0
                        res = self._scatter(batched, q, n_q, k_q)
                        if tr.enabled:
                            n_bytes += result_nbytes(res)
                            n_strided += sum(
                                not c.flags.c_contiguous for c in
                                _query_columns(batched, q, k_q).values())
                        self._cache_put(mem[0].query, res)
                        for p in mem:
                            self._complete(p, res, cached=False)
                    if tr.enabled:
                        sp.set("n_queries", n_q)
                        sp.set("n_requests", len(grp))
                        sp.set("bytes", n_bytes)
                        sp.set("n_strided", n_strided)
        else:
            if n_q > 1:
                self.stats.n_sequential_fallback += len(grp)
            for mem in members:
                res = self._run_single(mem[0])
                self._cache_put(mem[0].query, res)
                for p in mem:
                    self._complete(p, res, cached=False)

    def _note_shards(self) -> None:
        """Refresh per-shard placement stats from the engine.

        Cyclic placement (DESIGN.md Sec. 3h) appends row n to shard
        n % S -- always the shard with the fewest live rows -- so ingest
        is balanced by construction; the snapshot makes that auditable.
        """
        self.stats.n_shards = self.engine.n_shards
        self.stats.shard_rows = [
            int(x) for x in self.engine.shard_live_rows()]

    def _note_calibration(self) -> None:
        """Refresh cost-model provenance + feedback state from the planner.

        Taken per tick (like the shard stats) so a feedback re-pricing
        that lands mid-session shows up in the next snapshot, not only at
        construction time.
        """
        planner = self.engine.planner
        self.stats.cost_source = planner.cost_source.tag
        self.stats.feedback = planner.feedback.snapshot()

    def _apply_ingests(self) -> None:
        """Append all pending ingest rows as one batched in-place write.

        With a bank attached, the fused batch is scanned against every
        live standing pattern first -- one roles-swapped launch covering
        all same-tick submissions -- so alerts fire before the rows even
        splice in (and regardless of any later window eviction).
        """
        batch, self._ingest_queue = self._ingest_queue, []
        if not batch:
            return
        rows = (batch[0][1] if len(batch) == 1
                else np.concatenate([r for _, r in batch], 0))
        scan = None
        if self.bank is not None:
            scan = self.bank.scan(rows, base_row=self.engine.corpus.n_rows)
            self.stats.n_bank_hits += scan.hits.shape[0]
        start = self.engine.corpus.append_rows(rows)
        self.stats.n_ingest_batches += 1
        self.stats.n_ingested_rows += rows.shape[0]
        for ticket, r in batch:
            ticket.start = start
            ticket.done = True
            ticket.bank_ticket = scan
            start += r.shape[0]
        self._evict()

    def _evict(self) -> None:
        """Enforce the sliding window: tombstone past it, compact lazily.

        Tombstoned rows stay physically resident (reductions mask them;
        no repack, no splice); compaction -- which does pay one
        touched-rows splice -- runs only when the dead fraction crosses
        the configured threshold, amortizing it over many evictions.
        """
        if self.window_rows is None:
            return
        corpus = self.engine.corpus
        excess = corpus.n_live - self.window_rows
        if excess > 0:
            corpus.tombstone(corpus.live_row_ids()[:excess])
            self.stats.n_evicted_rows += excess
        if (corpus.n_dead
                and corpus.n_dead / corpus.n_rows >= self.compact_dead_frac):
            corpus.compact()

    def _note_bank(self) -> None:
        """Mirror bank + window counters into the stats snapshot."""
        self.stats.n_compactions = self.engine.corpus.n_compactions
        if self.bank is not None:
            self.stats.n_bank_launches = self.bank.n_bank_launches
            self.stats.n_bank_prefilter_launches = \
                self.bank.n_prefilter_launches
            self.stats.bank = self.bank.stats()

    def _note_obs(self) -> None:
        """Mirror per-tick service health into the metrics registry.

        The queue-depth gauge carries what no span or stats field shows
        (``launch.serve --metrics-every`` reads it); the stats snapshot
        pulls the registry's plan-vs-actual accounting back so estimate
        drift per (kernel, shape-bucket) reads out of
        ``ServiceStats.snapshot()``.
        """
        m = self.obs.metrics
        s = self.stats
        m.gauge("service.queue_depth").set(len(self._queue))
        s.timings_last_tick = (dict(self._tick_timings)
                               if self._tick_timings else None)
        s.plan_actual = m.plan_actual_summary() or None
        s.plan_mispredict_rate = m.mispredict_rate()

    def tick(self) -> int:
        """Drain the queues once: ingests, cache hits, grouped launches.

        Ingests apply first (one batched append), so this tick's queries
        run against the grown corpus and the generation-keyed cache drop
        below covers the append.  Returns the number of requests completed
        this tick.
        """
        tr = self.obs.tracer
        if not tr.enabled:
            return self._tick()
        with tr.span("service.tick", {"tick": self.stats.n_ticks}) as sp:
            n = self._tick()
            sp.set("n_completed", n)
            return n

    def _tick(self) -> int:
        """The tick body behind ``tick()`` (span-instrumented)."""
        if self.bank is not None:
            # Retire TTL-expired standing patterns before this tick's
            # ingest scan: a pattern past its deadline must not fire.
            self.bank.expire()
        self._apply_ingests()
        self._note_shards()
        self._note_calibration()
        self._note_bank()
        gen = self.engine.corpus.generation
        if gen != self._cache_generation:
            self._cache.clear()
            self._cache_generation = gen
        self.stats.n_ticks += 1
        launches_before = self.stats.n_launches
        self._tick_timings = {}
        pending, self._queue = self._queue, []
        if not pending:
            self.stats.launches_last_tick = 0
            self._note_obs()
            return 0
        before = self.stats.n_completed
        groups: "OrderedDict[Tuple, List[_Pending]]" = OrderedDict()
        for p in pending:
            hit = self._cache_get(p.query)
            if hit is not None:
                self._complete(p, hit, cached=True)
                continue
            # Non-coalescible (2-D / batched) queries group by query
            # content, not ticket identity: same-tick duplicates share one
            # launch (the `uniq` dedup in _run_group) instead of paying a
            # full launch each.
            key = p.group_key if p.group_key is not None else (
                "solo", p.query)
            groups.setdefault(key, []).append(p)
        for grp in groups.values():
            try:
                self._run_group(grp)
            except Exception as e:      # noqa: BLE001 -- tenant isolation
                # One tenant's bad query (pattern longer than the
                # fragment, rows out of range, ...) must not poison the
                # tick for everyone else: fail this group's tickets,
                # keep serving the rest.
                for p in grp:
                    if not p.ticket.done:
                        self._complete(p, None, cached=False, error=e)
        self.stats.launches_last_tick = (self.stats.n_launches
                                         - launches_before)
        self._note_obs()
        return self.stats.n_completed - before
