"""Query planner: workload shape -> kernel + geometry (port of
``repro.match.planner``).

Kernel selection by roofline arithmetic: estimate each kernel's compute
and memory terms, take ``max`` per kernel, pick the minimum.  Structural
constraints come first (the tensor-core formulation has no per-row
pattern path; a batched query on the SWAR kernel re-reads the corpus per
pattern, where the one-hot contraction amortizes the reference read
across patterns), and an explicit ``backend=`` override always wins.

The analytic layer prices against a ``GPURoofline`` (``H100`` by
default): the SWAR kernels are priced on the card's INT32 issue rate
(the role ``VPU_SLOWDOWN`` plays against the bf16 peak in the JAX
planner), the ``mxu`` backend on the tensor cores' bf16 rate.  Backend
*choices* may therefore differ from the JAX planner's; the geometry
(``_swar_geometry``, ``_mxu_geometry``, padding, chunking) is identical,
so a forced backend yields the same ``Plan`` geometry fields.

Two-stage pricing: for an eligible threshold query the engine hands
``plan`` a ``FilterContext`` and the planner weighs the q-gram filter
plus an estimated-survivor verify against the full scan
(``Plan.strategy``); ``plan_bank`` makes the same call for a standing
pattern bank against one document batch.  Both filter kernels are
priced on this card's roofline (``FILTER_OPS_PER_WORD``), not on the
TPU's vector-unit count.

Batch pricing: ``plan_batch`` weighs Q compatible shared-mode queries
fused into one ``mode="batched"`` launch against Q single launches (the
``MatchService`` coalescing verdict).

Not in this slice: shard-aware pricing (multi-GPU slice).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.tech import (H100, CostSource, GPURoofline,
                                   StaticCostSource)
from repro_torch.kernels import match_mxu as _mxu
from repro_torch.kernels import match_swar as _swar
from repro_torch.match.feedback import FeedbackStore, kernel_key

BACKENDS = ("swar", "mxu", "ref")

# Below this many (row, loc, patchar, query) ops the kernel launch
# dominates and the plain torch reference is fastest (the static model's
# launch-overhead belief, as in the JAX planner).
TINY_OPS = 4096
# SWAR integer ops per (row, loc, word): funnel shift, xor, or/shift/and
# fold, popcount, accumulate.
SWAR_OPS_PER_WORD = 12
# Accept-set SWAR variant: four lane-equality tests + plane ANDs replace
# the single XOR (see match_swar_masks) -- ~2.5x the integer work.
SWAR_OPS_PER_WORD_MASKS = 30
# Plain torch reference throughput: only has to rank the ref backend
# sanely against the kernels.
REF_OPS_PER_S = 1e9
# INT32 issue slots per signature word in the filter kernels
# (csrc/filter_qgram.cu): one and-not (LOP3), one popcount at a quarter of
# the INT32 rate (4 slots), one add.  On that basis the corpus filter is
# bound by bytes: a row of 8 words is 36 B (10.7 ps at 3.35 TB/s) against
# 48 slots (2.9 ps at the INT32 rate); the bank prefilter, which reads
# each signature once and tests every (pattern, doc) pair, is bound by
# these operations.
FILTER_OPS_PER_WORD = 6


def kernel_name(backend: str, predicate: str = "exact") -> str:
    """Cost-model kernel identifier for a (backend, predicate) pair."""
    if backend == "swar" and predicate == "accept":
        return "swar_masks"
    return backend


# -- analytic layer: shape -> roofline seconds, no overheads ------------------

def analytic_swar_seconds(roofline: GPURoofline, R: int, L: int, P: int,
                          Q: int = 1, predicate: str = "exact") -> float:
    """Roofline seconds for one fused SWAR dispatch over Q pattern sets."""
    wp, need = _swar_geometry(P, L)
    if predicate == "accept":
        ops_per_word, pat_words = SWAR_OPS_PER_WORD_MASKS, 4 * wp
    else:
        ops_per_word, pat_words = SWAR_OPS_PER_WORD, wp
    ops = Q * R * L * wp * ops_per_word
    bytes_hbm = Q * (R * need * 4 + R * pat_words * 4 + R * L * 4)
    t_compute = ops / roofline.peak_int32_ops
    t_mem = bytes_hbm / roofline.hbm_bw
    return max(t_compute, t_mem)


def analytic_mxu_seconds(roofline: GPURoofline, R: int, L: int, P: int,
                         Q: int = 1) -> float:
    """Roofline seconds for one batched tensor-core pass over all Q."""
    l_pad, p_chars, q_pad, f_chars = _mxu_geometry(P, L, Q)
    n_chunks = p_chars // _mxu.CHARS_PER_CHUNK
    flops = R * l_pad * (n_chunks * _mxu.K_CHUNK) * 2 * q_pad
    bytes_hbm = (R * f_chars * 4 * 2 + p_chars * 4 * q_pad * 2
                 + R * l_pad * q_pad * 4)
    t_compute = flops / roofline.peak_bf16_flops
    t_mem = bytes_hbm / roofline.hbm_bw
    return max(t_compute, t_mem)


def analytic_ref_seconds(roofline: GPURoofline, R: int, L: int, P: int,
                         Q: int = 1) -> float:
    """Plain torch reference compute for Q passes (overhead per call)."""
    del roofline
    return Q * R * L * P / REF_OPS_PER_S


def analytic_filter_seconds(roofline: GPURoofline, R: int, sig_words: int,
                            n_queries: int = 1) -> float:
    """Roofline seconds for Q ``filter_qgram`` launches over R signatures:
    each reads every row's words and writes one int32 flag per row."""
    ops = n_queries * R * sig_words * FILTER_OPS_PER_WORD
    bytes_hbm = n_queries * (R * sig_words * 4 + R * 4)
    return max(ops / roofline.peak_int32_ops, bytes_hbm / roofline.hbm_bw)


def analytic_bank_prefilter_seconds(roofline: GPURoofline, Q: int,
                                    sig_words: int, D: int) -> float:
    """Roofline seconds for one ``bank_prefilter`` launch: Q pattern and D
    doc signatures read once, Q slacks read and Q flags written, every
    (pattern, doc) pair tested (no early exit assumed)."""
    ops = Q * D * sig_words * FILTER_OPS_PER_WORD
    bytes_hbm = (Q + D) * sig_words * 4 + Q * 8
    return max(ops / roofline.peak_int32_ops, bytes_hbm / roofline.hbm_bw)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Everything the executor needs to run one query (same fields as the
    JAX package's ``Plan``, so results compare field for field)."""

    backend: str                # "swar" | "mxu" | "ref"
    mode: str                   # "shared" | "per_row" | "batched"
    n_rows: int                 # R (unpadded)
    fragment_chars: int         # F
    pattern_chars: int          # P
    n_patterns: int             # Q (1 unless batched)
    n_locs: int                 # L = F - P + 1
    # SWAR geometry.
    wp: int = 0                 # pattern words
    need_words: int = 0         # min corpus word width incl. look-ahead pad
    # Tensor-core geometry.
    l_pad: int = 0              # alignment rows produced (mult of L_TILE)
    p_chars_pad: int = 0        # pattern chars padded to CHARS_PER_CHUNK
    q_pad: int = 0              # patterns padded to 128
    f_chars: int = 0            # one-hot reference chars needed
    # Streaming.
    chunk_rows: int = 0         # rows per executor chunk (mult of row tile)
    est_seconds: float = 0.0    # roofline estimate for the whole query
    reason: str = ""            # human-readable selection rationale
    predicate: str = "exact"    # "exact" | "accept" (accept-set masks)
    # Two-stage execution: "scan" | "filter" (filter-then-verify).
    strategy: str = "scan"
    filter_words: int = 0       # signature words per row (filter plans)
    est_survivor_frac: float = 1.0  # estimated post-filter row fraction
    n_shards: int = 1
    est_collective_bytes: float = 0.0
    cost_source: str = "static"
    est_base_seconds: float = 0.0
    est_filter_seconds: float = 0.0
    est_filter_base_seconds: float = 0.0


def _swar_geometry(P: int, L: int) -> tuple[int, int]:
    wp = -(-P // 16)
    need = (L - 1) // 16 + wp + 1
    return wp, need


def _mxu_geometry(P: int, L: int, Q: int) -> tuple[int, int, int, int]:
    n_chunks = -(-P // _mxu.CHARS_PER_CHUNK)
    p_chars = n_chunks * _mxu.CHARS_PER_CHUNK
    l_pad = max(-(-L // _mxu.L_TILE) * _mxu.L_TILE, _mxu.L_TILE)
    q_pad = -(-Q // 128) * 128
    return l_pad, p_chars, q_pad, l_pad + p_chars


@dataclasses.dataclass(frozen=True)
class FilterContext:
    """Filter-stage pricing inputs for one eligible threshold query.

    Built by the engine (``MatchEngine._filter_context``) from the query
    content and the corpus index configuration; the planner prices the
    two-stage pipeline (filter + estimated-survivor verify) against the
    full scan and records the verdict in ``Plan.strategy``.
    """

    sig_words: int              # uint32 signature words per row
    n_queries: int              # filter-kernel launches (1 per pattern)
    prunable: bool              # every query can exclude rows
    survivor_frac: float        # estimated post-filter row fraction
    force: bool = False         # query hint filter=True: skip the pricing


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Pricing verdict for Q compatible shared-mode queries (one tick).

    ``coalesced`` means one fused ``mode="batched"`` launch beats Q
    sequential single-query launches; ``plan`` is the plan to execute
    (batched geometry when coalesced, single-query geometry otherwise).
    """

    coalesced: bool
    plan: Plan
    n_queries: int
    est_coalesced_s: float
    est_sequential_s: float
    reason: str


@dataclasses.dataclass(frozen=True)
class BankPlan:
    """Pricing verdict for one document batch against a standing bank.

    ``strategy == "scan"`` verifies every live pattern against the batch
    in one fused accept-set SWAR launch; ``"filter"`` first runs one
    ``bank_prefilter`` launch and verifies only the surviving patterns.
    Either way the batch costs exactly one verify launch.
    """

    strategy: str               # "scan" | "filter"
    n_docs: int                 # arriving batch size D
    n_patterns: int             # live bank slots Qp
    est_seconds: float          # chosen-path estimate
    est_scan_seconds: float     # full bank scan estimate
    est_filter_seconds: float   # prefilter stage share (0 for scan)
    est_survivor_frac: float    # estimated surviving-pattern fraction
    est_verify_patterns: int    # pattern axis priced into the verify
    reason: str
    cost_source: str = "static"


class Planner:
    """Kernel selection: analytic roofline x cost source x runtime feedback."""

    def __init__(self, roofline: GPURoofline = H100,
                 memory_budget_bytes: float = 256 * 2**20,
                 cost_source: Optional[CostSource] = None,
                 feedback: Optional[FeedbackStore] = None):
        self.roofline = roofline
        self.memory_budget_bytes = memory_budget_bytes
        self.cost_source = cost_source or StaticCostSource()
        self.feedback = feedback if feedback is not None else FeedbackStore()

    # -- cost terms -----------------------------------------------------------
    def _price(self, kernel: str, analytic_s: float, n_dispatch: int,
               R: int, x: int, Q: int, base: bool) -> float:
        """Analytic seconds -> wall seconds via source, then feedback
        (skipped for ``base=True``, the estimate runtimes are recorded
        against)."""
        priced = self.cost_source.price(kernel, analytic_s, n_dispatch)
        if base:
            return priced
        return priced * self.feedback.factor(kernel_key(kernel, R, x, Q))

    def swar_seconds(self, R: int, L: int, P: int, Q: int = 1,
                     predicate: str = "exact", *, base: bool = False) -> float:
        """One fused SWAR dispatch over Q pattern sets (batched queries
        tile the corpus chunk Q times, so work scales with Q)."""
        analytic = analytic_swar_seconds(self.roofline, R, L, P, Q, predicate)
        return self._price(kernel_name("swar", predicate), analytic, 1,
                           R, P, Q, base)

    def ref_seconds(self, R: int, L: int, P: int, Q: int = 1,
                    *, base: bool = False) -> float:
        """Q plain-torch reference passes (batched ref still loops Q)."""
        analytic = analytic_ref_seconds(self.roofline, R, L, P, Q)
        return self._price("ref", analytic, Q, R, P, Q, base)

    def filter_seconds(self, R: int, sig_words: int, n_queries: int = 1,
                       *, base: bool = False) -> float:
        """Q filter-kernel launches over R row signatures."""
        analytic = analytic_filter_seconds(self.roofline, R, sig_words,
                                           n_queries)
        return self._price("filter", analytic, n_queries,
                           R, sig_words, n_queries, base)

    def mxu_seconds(self, R: int, L: int, P: int, Q: int = 1,
                    *, base: bool = False) -> float:
        """One batched tensor-core pass over all Q patterns (identical for
        exact and accept-set predicates: a wildcard is a multi-hot
        column)."""
        analytic = analytic_mxu_seconds(self.roofline, R, L, P, Q)
        return self._price("mxu", analytic, 1, R, P, Q, base)

    def backend_seconds(self, backend: str, R: int, L: int, P: int,
                        Q: int = 1, predicate: str = "exact",
                        *, base: bool = False) -> float:
        """Price any scan backend by name."""
        if backend == "swar":
            return self.swar_seconds(R, L, P, Q, predicate, base=base)
        if backend == "mxu":
            return self.mxu_seconds(R, L, P, Q, base=base)
        return self.ref_seconds(R, L, P, Q, base=base)

    # -- chunking -------------------------------------------------------------
    def _chunk_rows(self, R_pad: int, plan_bytes_per_row: int,
                    row_tile: int, override: Optional[int]) -> int:
        """Rows per streaming chunk (a multiple of the row tile)."""
        if override is not None:
            chunk = -(-override // row_tile) * row_tile
        else:
            rows = int(self.memory_budget_bytes
                       // max(plan_bytes_per_row, 1))
            chunk = max(row_tile, (rows // row_tile) * row_tile)
        return min(chunk, R_pad)

    # -- the planner ----------------------------------------------------------
    def plan(self, *, n_rows: int, fragment_chars: int, pattern_chars: int,
             n_patterns: Optional[int] = None, per_row: bool = False,
             backend: Optional[str] = None,
             chunk_rows: Optional[int] = None,
             predicate: str = "exact",
             filter_ctx: Optional[FilterContext] = None) -> Plan:
        R, F, P = n_rows, fragment_chars, pattern_chars
        if R < 1:
            raise ValueError("corpus has no rows")
        if P < 1:
            raise ValueError("pattern must have at least one character")
        L = F - P + 1
        if L <= 0:
            raise ValueError("pattern longer than fragment")
        if per_row and n_patterns is not None:
            raise ValueError("per_row and batched are mutually exclusive")
        if predicate not in ("exact", "accept"):
            raise ValueError(f"unknown predicate {predicate!r}")
        Q = 1 if n_patterns is None else int(n_patterns)
        mode = "per_row" if per_row else ("batched" if n_patterns is not None
                                          else "shared")
        if backend is not None and backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "mxu" and per_row:
            raise ValueError("mxu kernel has no per-row-pattern formulation")

        t_swar = self.swar_seconds(R, L, P, Q, predicate)
        t_mxu = self.mxu_seconds(R, L, P, Q)

        if backend is not None:
            chosen, reason = backend, "explicit override"
        elif per_row:
            chosen, reason = "swar", "per-row patterns: SWAR only"
        elif (self.cost_source.name == "static"
              and R * L * P * Q <= TINY_OPS):
            chosen, reason = "ref", "tiny workload: launch overhead dominates"
        elif t_mxu < t_swar:
            chosen = "mxu"
            reason = f"roofline: mxu {t_mxu:.3g}s < swar {t_swar:.3g}s (Q={Q})"
        else:
            chosen = "swar"
            reason = f"roofline: swar {t_swar:.3g}s <= mxu {t_mxu:.3g}s (Q={Q})"

        wp, need = _swar_geometry(P, L)
        l_pad, p_chars, q_pad, f_chars = _mxu_geometry(P, L, Q)
        row_pad = _swar.ROW_TILE
        R_pad = -(-R // row_pad) * row_pad

        if chosen == "swar":
            # Batched swar tiles each chunk Q times (one fused launch), so
            # a chunk's footprint scales with Q; accept-set planes are 4
            # words per pattern word.
            pat_words = 4 * wp if predicate == "accept" else wp
            bytes_per_row = (need * 4 + pat_words * 4 + L * 4) * Q
            row_tile = _swar.ROW_TILE
            est = t_swar
            est_base = self.swar_seconds(R, L, P, Q, predicate, base=True)
        elif chosen == "mxu":
            bytes_per_row = f_chars * 4 * 2 + l_pad * q_pad * 4
            row_tile = 1
            est = t_mxu
            est_base = self.mxu_seconds(R, L, P, Q, base=True)
        else:
            bytes_per_row = F + L * 4 * Q
            row_tile = 1
            est = self.ref_seconds(R, L, P, Q)
            est_base = self.ref_seconds(R, L, P, Q, base=True)
        chunk = self._chunk_rows(R_pad, bytes_per_row, row_tile, chunk_rows)

        # Two-stage pricing: for an eligible threshold query, compare
        # filter + estimated-survivor verify against the full scan just
        # chosen.  The verify stage keeps the scan's kernel; the survivor
        # estimate carries the index's measured-selectivity calibration.
        # A query-level filter=True hint skips the pricing (never the
        # prunability requirement).
        strategy, filter_words, surv = "scan", 0, 1.0
        est_fil = est_fil_base = 0.0
        if filter_ctx is not None and filter_ctx.prunable:
            frac = filter_ctx.survivor_frac
            r_surv = max(1, math.ceil(frac * R))
            t_fil = self.filter_seconds(R, filter_ctx.sig_words,
                                        filter_ctx.n_queries)
            t_ver = self.backend_seconds(chosen, r_surv, L, P, Q, predicate)
            if filter_ctx.force or t_fil + t_ver < est:
                strategy = "filter"
                filter_words = filter_ctx.sig_words
                surv = frac
                reason += (f"; filter+verify {t_fil + t_ver:.3g}s "
                           f"{'forced' if filter_ctx.force else '<'} scan "
                           f"{est:.3g}s (est survivors {frac:.3g})")
                est = t_fil + t_ver
                est_fil = t_fil
                est_fil_base = self.filter_seconds(
                    R, filter_ctx.sig_words, filter_ctx.n_queries, base=True)
                est_base = self.backend_seconds(chosen, r_surv, L, P, Q,
                                                predicate, base=True)

        reason += f" [cost={self.cost_source.tag}]"
        return Plan(backend=chosen, mode=mode, n_rows=R, fragment_chars=F,
                    pattern_chars=P, n_patterns=Q, n_locs=L, wp=wp,
                    need_words=need, l_pad=l_pad, p_chars_pad=p_chars,
                    q_pad=q_pad, f_chars=f_chars, chunk_rows=chunk,
                    est_seconds=est, reason=reason, predicate=predicate,
                    strategy=strategy, filter_words=filter_words,
                    est_survivor_frac=surv,
                    cost_source=self.cost_source.tag,
                    est_base_seconds=est_base,
                    est_filter_seconds=est_fil,
                    est_filter_base_seconds=est_fil_base)

    # -- standing-bank pricing ------------------------------------------------
    def plan_bank(self, *, n_docs: int, fragment_chars: int,
                  pattern_chars: int, n_patterns: int, sig_words: int,
                  survivor_frac: float, prunable: bool = True,
                  force: Optional[bool] = None) -> BankPlan:
        """Price one document batch against the bank: prefilter or scan.

        The roles are swapped relative to ``plan``: the batch's docs ride
        the row axis, the bank's live slots the pattern axis, and the
        backend is always the accept-set SWAR kernel (the bank's resident
        operands are bit planes).  ``force=True`` pins the filtered
        strategy whenever the bank is prunable; ``force=False`` pins the
        full scan.
        """
        D, F, P, Qp = int(n_docs), int(fragment_chars), int(pattern_chars), \
            int(n_patterns)
        if D < 1:
            raise ValueError("batch has no documents")
        if Qp < 1:
            raise ValueError("bank has no live patterns")
        L = F - P + 1
        if L <= 0:
            raise ValueError("pattern longer than fragment")
        t_scan = self.swar_seconds(D, L, P, Qp, "accept")
        strategy, est, t_fil, q_surv = "scan", t_scan, 0.0, Qp
        frac = min(1.0, max(float(survivor_frac), 0.0))
        if prunable and force is not False:
            q_surv_est = max(1, math.ceil(frac * Qp))
            analytic = analytic_bank_prefilter_seconds(self.roofline, Qp,
                                                       sig_words, D)
            t_fil = self._price("bank_prefilter", analytic, 1, Qp,
                                sig_words, D, False)
            t_ver = self.swar_seconds(D, L, P, q_surv_est, "accept")
            if force or t_fil + t_ver < t_scan:
                strategy = "filter"
                est = t_fil + t_ver
                q_surv = q_surv_est
                reason = (f"bank prefilter+verify {est:.3g}s "
                          f"{'forced' if force else '<'} scan "
                          f"{t_scan:.3g}s (est survivors {frac:.3g} of "
                          f"{Qp})")
            else:
                reason = (f"bank scan {t_scan:.3g}s <= prefilter+verify "
                          f"{t_fil + t_ver:.3g}s")
                t_fil = 0.0
        elif force is False:
            reason = f"bank scan forced ({Qp} patterns x {D} docs)"
        else:
            reason = f"bank scan: no prunable patterns ({Qp} x {D} docs)"
        reason += f" [cost={self.cost_source.tag}]"
        return BankPlan(strategy=strategy, n_docs=D, n_patterns=Qp,
                        est_seconds=est, est_scan_seconds=t_scan,
                        est_filter_seconds=t_fil,
                        est_survivor_frac=frac if strategy == "filter"
                        else 1.0,
                        est_verify_patterns=q_surv, reason=reason,
                        cost_source=self.cost_source.tag)

    # -- batch pricing --------------------------------------------------------
    def plan_batch(self, *, n_rows: int, fragment_chars: int,
                   pattern_chars: int, n_queries: int,
                   backend: Optional[str] = None,
                   chunk_rows: Optional[int] = None,
                   predicate: str = "exact",
                   n_shards: int = 1) -> BatchPlan:
        """Price Q compatible shared-mode queries: coalesced vs. sequential.

        Sequential is Q independent single-pattern launches (each paying
        its own dispatch); coalesced is one ``mode="batched"`` plan over
        all Q patterns (a single fused launch on every backend).  Ties go
        to coalesced: beyond the kernel cost, one launch amortizes
        planning, host packing and result assembly, which the roofline
        does not model.  ``n_shards`` must be 1 until the multi-GPU slice.
        """
        if n_queries < 1:
            raise ValueError("n_queries must be >= 1")
        if n_shards != 1:
            raise ValueError("the port prices one row shard; got "
                             f"n_shards={n_shards}")
        kw = dict(n_rows=n_rows, fragment_chars=fragment_chars,
                  pattern_chars=pattern_chars, backend=backend,
                  chunk_rows=chunk_rows, predicate=predicate)
        single = self.plan(**kw)
        if n_queries == 1:
            return BatchPlan(coalesced=False, plan=single, n_queries=1,
                             est_coalesced_s=single.est_seconds,
                             est_sequential_s=single.est_seconds,
                             reason="single query: nothing to coalesce "
                                    f"[cost={self.cost_source.tag}]")
        batched = self.plan(n_patterns=n_queries, **kw)
        est_seq = n_queries * single.est_seconds
        est_co = batched.est_seconds
        coalesced = est_co <= est_seq
        if coalesced:
            reason = (f"coalesce {n_queries} queries: {batched.backend} "
                      f"{est_co:.3g}s <= {n_queries}x {single.backend} "
                      f"{est_seq:.3g}s")
        else:
            reason = (f"sequential: {n_queries}x {single.backend} "
                      f"{est_seq:.3g}s < {batched.backend} {est_co:.3g}s")
        reason += f" [cost={self.cost_source.tag}]"
        return BatchPlan(coalesced=coalesced,
                         plan=batched if coalesced else single,
                         n_queries=n_queries, est_coalesced_s=est_co,
                         est_sequential_s=est_seq, reason=reason)
