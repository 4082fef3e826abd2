"""Streaming match executor + query compiler (port of ``repro.match.engine``).

Single entry point for string matching: owns a
``PackedCorpus`` (device-resident, packed once), lowers declarative
``MatchQuery`` objects through the ``Planner`` into ``CompiledMatch``
programs (kernel choice + geometry + packed pattern operands, computed
once and LRU-cached by query content), then streams corpus row chunks
through the chosen kernel with a fused per-chunk reduction, so the full
(R, L, Q) score tensor is never materialized unless asked for.

Reductions (fused per chunk):
  best      -- per-row argmax over alignments: (R,[Q]) locs + scores.
  topk      -- global top-k rows by best score (running merge across
               chunks).
  threshold -- all (row, loc[, q]) hits with score >= threshold.
  full      -- materialized score tensor (small problems / compat path).

Predicates: exact queries ride the XOR SWAR kernel or the one-hot
tensor-core kernel; accept-set queries (IUPAC, N wildcards, character
classes) ride the bit-plane SWAR kernel or a multi-hot pattern matrix --
the same resident corpus forms either way.

Filter-then-verify: an engine attaches a q-gram ``CorpusIndex`` by
default (``index=True``, as the JAX engine does).  A selective
``threshold`` query can then run two-stage: ``filter_qgram`` scans the
device-resident row signatures (one launch per pattern, the flags OR-ed
on the device, one pull), and only the surviving rows verify through the
row-gather path that serves ``rows=`` subsets -- ``hits`` are
bit-identical to a full scan because the filter is conservative.

Row shards: an engine built on a row mesh
(``repro_torch.launch.mesh.make_row_mesh``) splits the corpus rows over
the mesh's devices in the cyclic layout (logical row ``r`` on shard
``r % S``, slot ``r // S``).  A chunk of logical rows ``[c0, c1)`` is slots
``[c0/S, c1/S)`` of every shard, one contiguous slice each, so it runs one
kernel launch a shard; the ``ShardMerger`` reduces each shard's output
where it lies and joins the reduced state on the mesh's first device
before its one pull.  Row subsets and filter survivors run on the shard
that holds each row and come back in query order.  Results are bit for
bit the one-shard engine's.

One process a card: on a mesh that spans the ranks of a
``torch.distributed`` group (``launch.cluster``) each rank launches the
kernels on its own shards only and the merger's joins become
collectives over the group, so every rank returns the same
``MatchResult``.  Every decision taken before a collective -- the plan,
chunk bounds, hot rows, survivors, filter-or-scan -- comes from host
state every rank holds alike or from values already joined, and runtime
feedback is off by default there (wall clocks differ between ranks;
plans that diverged would issue different collectives and hang).
Per-row and batched SWAR queries are refused there, as the reference
refuses them.

Results keep the JAX package's layout: ``MatchResult`` fields are numpy
arrays of the same dtypes, so the two packages compare like with like.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.tech import CostSource
from repro_torch.device import DeviceLike, canonical_device, resolve_device
from repro_torch.distributed import sharding as _sharding
from repro_torch.distributed.sharding import first_local
from repro_torch.kernels import filter_qgram as _fq
from repro_torch.kernels import match_mxu as _mxu
from repro_torch.kernels import match_swar as _swar
from repro_torch.kernels import ref as _kref
from repro_torch.launch import cluster as _cluster
from repro_torch.obs import Observability

from . import index as _ix
from .corpus import PackedCorpus
from .feedback import kernel_key
from .index import CorpusIndex, FilterOperands, build_query_filter
from .merge import ShardMerger
from .planner import FilterContext, Plan, Planner, kernel_name
from .query import _UNSET, MatchQuery, as_query


@dataclasses.dataclass
class MatchResult:
    """Outcome of one engine query (reduced unless ``scores`` requested)."""

    plan: Plan
    best_locs: np.ndarray                 # (R,) or (R, Q) int
    best_scores: np.ndarray               # (R,) or (R, Q) int32
    scores: Optional[np.ndarray] = None   # (R, L[, Q]) when reduction="full"
    topk_rows: Optional[np.ndarray] = None     # (k,[Q]) best-matching rows
    topk_scores: Optional[np.ndarray] = None
    hits: Optional[np.ndarray] = None     # (n, 3|4): row, loc[, q], score
    n_chunks: int = 0
    # Filtered execution (plan.strategy == "filter"): the verify stage ran
    # on these corpus rows only; per-row arrays (best_locs/best_scores)
    # cover survivors in ascending corpus-row order, while ``hits`` stays
    # bit-identical to a full scan.
    survivor_rows: Optional[np.ndarray] = None  # (n_surv,) corpus row ids
    survivor_frac: Optional[float] = None       # n_surv / live rows
    n_shards: int = 1
    merge_path: str = "host"
    collective_bytes: int = 0
    # Per-stage wall-second breakdown from the span tree (tracer on only).
    timings: Optional[dict] = dataclasses.field(default=None, repr=False)


def _valid_mask(P: int, wp: int) -> np.ndarray:
    """(1, Wp) low-bit-of-lane mask of the P valid pattern positions."""
    mask_codes = np.zeros(wp * 16, np.uint32)
    mask_codes[:P] = 1
    return encoding.pack_codes_u32(mask_codes[None, :])


def _pack_patterns_swar(codes: np.ndarray, wp: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-pack (tiny) exact pattern words + valid mask (SWAR kernel)."""
    return encoding.pack_codes_u32(codes), _valid_mask(codes.shape[-1], wp)


def _pack_mask_planes(masks: np.ndarray, wp: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-pack accept masks into (Q, 4*Wp) uint32 bit-planes + valid mask.

    Plane c has the low bit of lane i set iff code c is accepted at
    pattern position i (``match_swar_masks`` layout).
    """
    planes = [encoding.pack_codes_u32(((masks >> c) & 1).astype(np.uint32))
              for c in range(4)]
    return (np.concatenate(planes, axis=-1),
            _valid_mask(masks.shape[-1], wp))


def _pack_patterns_mxu(masks: np.ndarray, p_chars: int, q_pad: int
                       ) -> np.ndarray:
    """Host-pack (tiny) multi-hot pattern matrix (p_chars*4, q_pad).

    Column q gets a 1 at (position i, channel c) iff code c is accepted at
    position i of pattern q -- one-hot for exact queries, multi-hot for
    accept-set predicates.
    """
    Q, P = masks.shape
    pat_mat = np.zeros((p_chars, 4, q_pad), np.float32)
    bits = (masks[:, :, None] >> np.arange(4, dtype=np.uint8)) & 1
    pat_mat[:P, :, :Q] = bits.astype(np.float32).transpose(1, 2, 0)
    return pat_mat.reshape(p_chars * 4, q_pad)


def _words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 host words -> int32 device tensor carrying the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)


class _Launch(NamedTuple):
    """One kernel launch of a chunk: shard ``shard``'s form rows ``rows``
    (a slice of slots, or a device tensor of slots or row ids) for the
    chunk positions ``pos`` (host, chunk-relative; ``None``: the chunk's
    rows in order, or a resident shard's slots, positions
    ``slot * S + shard``)."""

    shard: int
    rows: Union[slice, torch.Tensor]
    pos: Optional[np.ndarray] = None


class CompiledMatch:
    """One ``MatchQuery`` lowered against one engine: reusable, growth-safe.

    Construction does all per-query host work once -- mode resolution
    (pinned at compile time), planning, pattern packing, row-subset
    validation and padding.  ``run()`` then streams the engine's
    *current* resident corpus through the lowered program.  Plan
    geometry is revalidated per run when the live row count moved; the
    packed pattern operands are row-count independent and survive, unless
    growth flips the kernel choice, in which case only they are re-packed.
    A pinned ``per_row`` query refuses to run after growth.
    """

    __slots__ = ("engine", "query", "plan", "_packed", "_packed_sh",
                 "_pats2d", "_sel",
                 "_idx", "_pad_idx", "_k_eff", "_k_vec", "_thr_vec",
                 "_empty", "_mode", "_lowered", "_filter_ops",
                 "_filter_dev", "_fb_version", "_sel_max")

    def __init__(self, engine: "MatchEngine", query: MatchQuery):
        self.engine = engine
        self.query = query
        corpus = engine.corpus

        sel = query.rows
        self._sel = None if sel is None else np.asarray(sel, np.int64)
        self._empty = self._sel is not None and self._sel.size == 0
        self._packed = self._pats2d = self._idx = self._pad_idx = None
        self._packed_sh: list = []
        self._sel_max = -1
        self._k_eff, self._k_vec, self._thr_vec = 0, None, None
        self._filter_ops: Optional[FilterOperands] = None
        self._filter_dev: Optional[torch.Tensor] = None
        self._lowered = False
        self._fb_version = engine.planner.feedback.version
        if self._empty:
            self.plan = engine._empty_plan(query)
            self._mode = self.plan.mode
            return

        if self._sel is not None:
            if self._sel.min() < 0 or self._sel.max() >= corpus.n_rows:
                raise IndexError(
                    f"rows must be in [0, {corpus.n_rows}), got "
                    f"[{self._sel.min()}, {self._sel.max()}]")
            self._sel_max = int(self._sel.max())
            R = len(self._sel)
            R_pad = -(-R // corpus.row_pad) * corpus.row_pad
            pad_idx = np.zeros(R_pad, np.int64)
            pad_idx[:R] = self._sel
            self._pad_idx = pad_idx
            self._idx = torch.from_numpy(pad_idx).to(engine.device)

        n_rows = len(self._sel) if self._sel is not None else corpus.n_rows
        # Mode pinned at compile time, before any growth can happen.
        self._mode = engine._infer_mode(query, n_rows)
        if n_rows == 0:
            # Reserved-but-empty corpus: geometry validated now, lowering
            # deferred to the first run that sees live rows.
            self.plan = engine._empty_plan(query, mode=self._mode)
            return
        self._lower(n_rows)

    def _lower(self, n_rows: int) -> None:
        """Plan + pack against ``n_rows`` corpus rows (pinned mode)."""
        engine, query = self.engine, self.query
        # Filter operands depend on the query content and the index
        # parameters only: built once, they survive growth and strategy
        # changes; the plan decides whether run() uses them.
        ctx, self._filter_ops = engine._filter_context(
            query, self._mode, ops=self._filter_ops)
        self.plan = engine._plan_query(query, n_rows, mode=self._mode,
                                       filter_ctx=ctx)
        self._fb_version = engine.planner.feedback.version
        plan = self.plan

        # Per-query reduction parameters (batched runs only).
        k_vec = np.asarray(query.k if query.k else (10,), np.int64)
        if k_vec.size != 1 and (plan.mode != "batched"
                                or k_vec.size != plan.n_patterns):
            raise ValueError("per-query k needs a batched query with one "
                             "entry per pattern")
        self._k_vec = k_vec
        self._k_eff = int(k_vec.max())
        thr_vec = None
        if query.reduction == "threshold":
            thr_vec = np.asarray(query.threshold, np.float64)
            if plan.mode == "batched":
                if thr_vec.size == 1:
                    thr_vec = np.full(plan.n_patterns, thr_vec[0])
                elif thr_vec.size != plan.n_patterns:
                    raise ValueError("per-query thresholds need one entry "
                                     "per pattern")
            elif thr_vec.size != 1:
                raise ValueError("per-query thresholds need a batched query")
        self._thr_vec = thr_vec

        # Pattern operands, packed and uploaded once.
        masks2d = query.masks if len(query.shape) == 2 else \
            query.masks[None, :]
        if plan.predicate == "exact":
            codes = query.codes
            self._pats2d = codes if codes.ndim == 2 else codes[None, :]
        else:
            self._pats2d = masks2d
        dev = engine.device
        if plan.backend == "swar":
            if plan.predicate == "accept":
                pat_rows, valid = _pack_mask_planes(masks2d, plan.wp)
            else:
                pat_rows, valid = _pack_patterns_swar(self._pats2d, plan.wp)
            self._packed = (_words(pat_rows, dev), _words(valid, dev))
        elif plan.backend == "mxu":
            mat = _pack_patterns_mxu(masks2d, plan.p_chars_pad, plan.q_pad)
            self._packed = torch.from_numpy(mat).to(dev, torch.bfloat16)
        else:
            self._packed = None
        self._packed_sh = engine._per_shard(self._packed)
        self._lowered = True

    def _revalidate(self, n_rows: int) -> None:
        """Refresh plan geometry for a corpus whose live row count moved.

        The filter strategy is re-decided too (scale and measured
        selectivity move the two-stage trade-off); the cached filter
        operands are passed back so only the survivor estimate refreshes.
        """
        ctx, self._filter_ops = self.engine._filter_context(
            self.query, self._mode, ops=self._filter_ops)
        new_plan = self.engine._plan_query(self.query, n_rows,
                                           mode=self._mode, filter_ctx=ctx)
        self._fb_version = self.engine.planner.feedback.version
        if new_plan.backend != self.plan.backend:
            self._lower(n_rows)
        else:
            self.plan = new_plan

    # -- execution ------------------------------------------------------------
    def run(self) -> MatchResult:
        """Execute against the engine's current corpus contents.

        A ``plan.strategy == "filter"`` query runs two stages: the q-gram
        filter kernel prunes rows that provably cannot reach the
        threshold, then the survivors verify through the row-gather path
        of ``rows=`` subsets.

        With the engine's tracer enabled the whole execution runs under a
        ``match.run`` span (plan / pack / launch / merge / pull children)
        and the result carries the per-stage breakdown in ``timings``.
        """
        tr = self.engine.obs.tracer
        if not tr.enabled:
            return self._run()
        with tr.span("match.run",
                     {"reduction": self.query.reduction}) as root:
            res = self._run()
        res.timings = root.stage_seconds()
        return res

    def _note_plan(self, sp) -> None:
        """Planner-decision attributes onto an open ``plan`` span."""
        p = self.plan
        sp.set("kernel", kernel_name(p.backend, p.predicate))
        sp.set("strategy", p.strategy)
        sp.set("cost_source", p.cost_source)
        sp.set("est_seconds", p.est_seconds)
        sp.set("n_rows", p.n_rows)

    def _run(self) -> MatchResult:
        """The streaming executor behind ``run()`` (span-instrumented)."""
        if self._empty:
            return self.engine._empty_result(self.query, self.plan)
        engine, query = self.engine, self.query
        tr = engine.obs.tracer
        reduction = query.reduction
        sel = self._sel
        survivor_frac = None
        # Tombstone mask: dead rows stay resident so the kernels run
        # unchanged; the reductions below mask them out on the host.
        dead_full = (engine.corpus.dead_mask if engine.corpus.n_dead
                     else None)
        if sel is not None:
            with tr.span("plan") as sp_plan:
                if self._sel_max >= engine.corpus.n_rows:
                    raise IndexError(
                        f"rows subset names row {self._sel_max} but the "
                        f"corpus now holds {engine.corpus.n_rows} live rows "
                        "(did compact() reclaim evicted rows?); recompile "
                        "with current row ids")
                R = len(sel)
                if tr.enabled:
                    self._note_plan(sp_plan)
            idx, idx_log = self._idx, self._pad_idx
            R_pad = idx.shape[0]
        else:
            idx = idx_log = None
            R = engine.corpus.n_rows
            if R == 0:
                return engine._empty_result(query, self.plan)
            R_pad = engine.corpus.n_rows_padded
            with tr.span("plan") as sp_plan:
                if not self._lowered:
                    self._lower(R)
                elif (self.plan.n_rows != R
                      or engine.planner.feedback.version != self._fb_version):
                    self._revalidate(R)
                if tr.enabled:
                    self._note_plan(sp_plan)
            if self.plan.strategy == "filter":
                with tr.span("filter") as sp_fil:
                    t0 = time.perf_counter()
                    flags = engine._run_filter(self, R)
                    t_fil = time.perf_counter() - t0
                    sel = np.flatnonzero(flags).astype(np.int64)
                    if dead_full is not None:
                        # Tombstoned rows can pass the signature test but
                        # must reach neither the verify stage nor the hits.
                        sel = sel[~dead_full[sel]]
                    survivor_frac = len(sel) / R
                    if tr.enabled:
                        sp_fil.set("survivor_frac", survivor_frac)
                ops = self._filter_ops
                engine.index.record_selectivity(
                    engine.index.estimate_survivor_frac(
                        ops.n_bits, ops.slacks, calibrated=False),
                    survivor_frac)
                # Plan-vs-actual: one record per executed filter stage,
                # the same key and floats as the feedback observation.
                p0 = self.plan
                r_sh = -(-p0.n_rows // p0.n_shards)
                f_key = kernel_key("filter", r_sh, p0.filter_words,
                                   ops.qsig_words.shape[0])
                engine.obs.record_plan_actual(
                    f_key, p0.est_filter_base_seconds, t_fil)
                if engine.record_runtimes:
                    engine.planner.feedback.observe(
                        f_key, p0.est_filter_base_seconds, t_fil)
                if len(sel) == 0:
                    res = engine._empty_result(query, self.plan)
                    res.survivor_rows = sel
                    res.survivor_frac = 0.0
                    return res
                R = len(sel)
                R_pad = -(-R // engine.corpus.row_pad) * \
                    engine.corpus.row_pad
                pad_idx = np.zeros(R_pad, np.int64)
                pad_idx[:R] = sel
                idx_log = pad_idx
                idx = torch.from_numpy(pad_idx).to(engine.device)
        plan = self.plan
        step = plan.chunk_rows
        S = engine.n_shards
        merger = engine.merger
        coll0 = merger.collective_bytes
        if S > 1:
            tile = _swar.ROW_TILE * S
            step = max(tile, (step // tile) * tile)
        # Resident sharded chunks come back a tensor a shard, in the
        # cyclic layout; the merger un-permutes as it joins them.  Gather
        # paths (row subsets, filter survivors) come back in query order,
        # and the ref backend reads the logical host buffer.
        shard_phys = S > 1 and idx is None and plan.backend != "ref"

        best_l: List[np.ndarray] = []
        best_s: List[np.ndarray] = []
        full: List[np.ndarray] = []
        hit_rows: List[np.ndarray] = []
        topk_state = None                 # running global top-k (device)
        n_topk_alive = 0
        n_chunks = 0
        thr_vec = self._thr_vec
        thr_int = None
        if thr_vec is not None:
            # Integer-exact device threshold: scores are ints, so
            # s >= t  <=>  s >= ceil(t).  The host recomputes final hits
            # with the float threshold over the gathered block.
            thr_int = np.clip(np.ceil(thr_vec), -(2 ** 31),
                              2 ** 31 - 1).astype(np.int32)

        # best / top-k on the tensor cores or exact SWAR: the reduction
        # runs in the kernel's epilogue, so no (rows, L[, Q]) block is
        # materialized.
        fused_best = reduction in ("best", "topk") and (
            plan.backend == "mxu"
            or (plan.backend == "swar" and plan.predicate == "exact"))
        t_scan0 = time.perf_counter()
        for c0 in range(0, R_pad, step):
            c1 = min(c0 + step, R_pad)
            valid = min(c1, R) - c0       # rows in this chunk that are real
            if valid <= 0:
                break                     # pure-padding tail chunk
            # CUDA launches are asynchronous: the launch span measures
            # dispatch, the device wait lands in the pull spans.
            with tr.span("launch",
                         {"c0": c0, "rows": valid} if tr.enabled else None):
                if fused_best:
                    best = engine._chunk_best(plan, c0, c1, self._packed_sh,
                                              idx, idx_log)
                else:
                    scores = engine._chunk_scores(plan, self._pats2d, c0, c1,
                                                  self._packed_sh, idx,
                                                  idx_log)
            n_chunks += 1
            alive = None
            if dead_full is not None:
                chunk_ids = (np.arange(c0, c0 + valid, dtype=np.int64)
                             if sel is None
                             else np.asarray(sel[c0:c0 + valid]))
                alive = ~dead_full[chunk_ids]
                if alive.all():
                    alive = None
            if reduction == "full":
                sc = merger.pull(scores, unpermute=shard_phys,
                                 kind="block")[:valid]
                if alive is not None:
                    # Dead rows report the -1 sentinel.
                    sc = sc.copy()
                    sc[~alive] = -1
                full.append(sc)
                continue
            if fused_best:
                bl, bs = merger.slice_best(*best, plan.n_patterns,
                                           batched=plan.mode == "batched")
            else:
                bl, bs = merger.chunk_best(scores)
            bl_np = merger.pull(bl, unpermute=shard_phys)[:valid]
            bs_np = merger.pull(bs, unpermute=shard_phys)[:valid]
            if alive is not None:
                bl_np, bs_np = bl_np.copy(), bs_np.copy()
                bl_np[~alive] = 0
                bs_np[~alive] = -1        # dead-row best-score sentinel
            best_l.append(bl_np)
            best_s.append(bs_np)
            if reduction == "threshold":
                # Two-phase sparse pull: a per-row any-hit bitmap, then a
                # device gather of only the hot rows' score vectors.
                hot = merger.hot_mask(scores, thr_int)
                hot_np = merger.pull(hot, unpermute=shard_phys)[:valid]
                if alive is not None:
                    hot_np = hot_np & alive
                hot_rows = np.flatnonzero(hot_np)
                if hot_rows.size == 0:
                    continue
                if shard_phys:
                    # The hot logical rows' places in the chunk's
                    # shard-major order.
                    jc = int(first_local(scores).shape[0])
                    pos = (hot_rows % S) * jc + hot_rows // S
                else:
                    pos = hot_rows
                # Pad the gather to a power of two (the JAX engine does
                # so to avoid recompiles; kept for identical transfers).
                n_hot = pos.size
                pad_n = max(8, 1 << (int(n_hot) - 1).bit_length())
                pos_pad = np.zeros(pad_n, np.int64)
                pos_pad[:n_hot] = pos
                sc = merger.pull(merger.gather_rows(scores, pos_pad),
                                 kind="block")[:n_hot]
                if plan.mode == "batched":
                    local = np.argwhere(sc >= thr_vec[None, None, :])
                else:
                    local = np.argwhere(sc >= float(thr_vec[0]))
                if local.size:
                    vals = sc[tuple(local.T)]
                    rows_chunk = hot_rows[local[:, 0]]
                    local[:, 0] = (sel[rows_chunk + c0] if sel is not None
                                   else rows_chunk + c0)
                    hit_rows.append(np.concatenate(
                        [local, vals[:, None].astype(np.int64)], 1))
            elif reduction == "topk":
                if topk_state is None:
                    topk_state = merger.topk_init(
                        self._k_eff,
                        plan.n_patterns if plan.mode == "batched" else 0,
                        engine.device)
                n_bs = (S * int(first_local(bs).shape[0]) if shard_phys
                        else int(bs.shape[0]))
                alive_chunk = np.zeros(n_bs, bool)
                alive_chunk[:valid] = True if alive is None else alive
                n_topk_alive += valid if alive is None else int(alive.sum())
                if shard_phys:
                    # Shard-local top-k over logical ids c0 + slot*S + s,
                    # then the candidates merge on the join device.
                    topk_state = merger.topk_update(
                        topk_state, bs, alive_chunk=alive_chunk, c0=c0,
                        phys=True)
                else:
                    rows_full = np.zeros(n_bs, np.int64)
                    rows_full[:valid] = (np.arange(c0, c0 + valid)
                                         if sel is None
                                         else sel[c0:c0 + valid])
                    topk_state = merger.topk_update(
                        topk_state, bs, alive_chunk=alive_chunk,
                        rows_np=rows_full)

        if n_chunks:
            # Observed scan wall time vs. the feedback-free estimate: the
            # plan-vs-actual registry always records, the feedback store
            # (which mutates future plans) only when enabled.  The ref
            # backend is priced at total rows, kernels per shard.
            r_price = R if plan.backend == "ref" else -(-R // plan.n_shards)
            base = engine.planner.backend_seconds(
                plan.backend, r_price, plan.n_locs, plan.pattern_chars,
                plan.n_patterns, plan.predicate, base=True)
            s_key = kernel_key(kernel_name(plan.backend, plan.predicate),
                               r_price, plan.pattern_chars, plan.n_patterns)
            t_scan = time.perf_counter() - t_scan0
            engine.obs.record_plan_actual(s_key, base, t_scan)
            if engine.record_runtimes:
                engine.planner.feedback.observe(s_key, base, t_scan)

        if reduction == "full":
            all_scores = np.concatenate(full, 0)
            return MatchResult(plan=plan, best_locs=all_scores.argmax(1),
                               best_scores=all_scores.max(1),
                               scores=all_scores, n_chunks=n_chunks,
                               n_shards=S, merge_path=merger.merge_path,
                               collective_bytes=merger.collective_bytes
                               - coll0)
        res = MatchResult(plan=plan, best_locs=np.concatenate(best_l, 0),
                          best_scores=np.concatenate(best_s, 0),
                          n_chunks=n_chunks, n_shards=S,
                          merge_path=merger.merge_path)
        if survivor_frac is not None:
            res.survivor_rows = sel
            res.survivor_frac = survivor_frac
        if reduction == "threshold":
            width = 3 + (1 if plan.mode == "batched" else 0)
            res.hits = (np.concatenate(hit_rows, 0) if hit_rows
                        else np.zeros((0, width), np.int64))
        elif reduction == "topk":
            if topk_state is None or n_topk_alive == 0:
                # Every scanned row was tombstoned: a well-formed empty
                # top-k.
                shape0 = ((0, plan.n_patterns) if plan.mode == "batched"
                          else (0,))
                res.topk_rows = np.zeros(shape0, np.int64)
                res.topk_scores = np.zeros(shape0, np.int32)
            else:
                res.topk_rows, res.topk_scores = merger.topk_finalize(
                    topk_state, n_topk_alive, self._k_eff)
        res.collective_bytes = merger.collective_bytes - coll0
        return res

    __call__ = run


class MatchEngine:
    """Planner + packed corpus + query compiler + streaming executor.

    ``corpus`` may be a PackedCorpus or a raw (R, F) uint8 fragment
    matrix.  ``device=None`` means the CUDA device (or, for a
    PackedCorpus, the device it was built on; with a mesh, the mesh's
    first device, or this process's first shard's on a mesh across
    processes).  ``mesh`` (a ``RowMesh``) shards corpus rows over the
    mesh axes the ``rows`` logical rule maps to; ``rules`` replaces the
    default rule table.  A row count the mesh does not divide falls back
    to one shard with a ``UserWarning``.  ``index`` attaches the
    q-gram filter index: ``True`` (the default) shares the corpus's
    existing ``CorpusIndex`` or creates one, a ``CorpusIndex`` instance
    overrides its (q, n_bits), ``False`` disables the two-stage strategy.
    ``compile(query)`` is the primary API; ``match`` / ``scores`` are
    kwarg shims that build (and content-cache) the query.
    """

    def __init__(self, corpus: Union[PackedCorpus, np.ndarray], *,
                 planner: Optional[Planner] = None,
                 cost_source: Optional[CostSource] = None,
                 record_runtimes: Optional[bool] = None,
                 compile_cache_size: int = 128,
                 index: Union[bool, CorpusIndex] = True,
                 obs: Optional[Observability] = None,
                 device: DeviceLike = None, mesh=None, rules=None):
        self.obs = obs if obs is not None else Observability()
        if mesh is not None and device is None:
            device = mesh.device
        if isinstance(corpus, PackedCorpus):
            if device is not None and resolve_device(device) != corpus.device:
                raise ValueError(f"corpus lives on {corpus.device}, engine "
                                 f"asked for {device}")
            n_row_slots = corpus.capacity
        else:
            n_row_slots = np.asarray(corpus).shape[0]
        if n_row_slots < 1:
            raise ValueError("MatchEngine needs a non-empty corpus: got 0 "
                             "fragment rows and no reserved capacity "
                             "(PackedCorpus(..., capacity=N) to start "
                             "empty)")
        self.mesh = mesh
        self.rules = rules
        self._row_shards = 1
        self._row_axes: Optional[Tuple[str, ...]] = None
        row_pad = _swar.ROW_TILE
        if mesh is not None:
            # warn=True: an indivisible row count replicating silently is
            # an invisible perf cliff -- the caller asked for a mesh and
            # gets one shard; say so.
            r = _sharding.resolve_axis(
                "rows", -(-n_row_slots // _swar.ROW_TILE) * _swar.ROW_TILE,
                mesh, rules, warn=True)
            if r is not None:
                self._row_axes = r if isinstance(r, tuple) else (r,)
                self._row_shards = int(
                    np.prod([mesh.shape[a] for a in self._row_axes]))
                row_pad = _swar.ROW_TILE * self._row_shards
        if isinstance(corpus, PackedCorpus):
            self.corpus = corpus
        else:
            self.corpus = PackedCorpus(np.asarray(corpus, np.uint8),
                                       row_pad=row_pad, device=device)
        self.device = self.corpus.device
        S = self._row_shards
        if S > 1 and (canonical_device(self.device)
                      != canonical_device(mesh.device)):
            raise ValueError(f"corpus lives on {self.device}, the mesh's "
                             f"first device is {mesh.device}")
        self.corpus.obs = self.obs
        # The cyclic row layout over the mesh's devices (a no-op when the
        # corpus already has this layout).
        self.corpus.shard_rows(
            mesh if S > 1 else None,
            self._row_axes if self._row_axes is None
            or len(self._row_axes) > 1 else self._row_axes[0], S)
        # Every reduction, cross-shard join and host pull routes through
        # the merger.
        self.merger = ShardMerger(mesh if S > 1 else None, self._row_axes,
                                  S, obs=self.obs)
        if planner is None:
            planner = Planner(cost_source=cost_source)
        elif cost_source is not None:
            planner.cost_source = cost_source
        self.planner = planner
        # Runtime feedback: on for calibrated sources, off for the static
        # fallback, whose decisions must not drift while the engine runs.
        # Off past one process: wall clocks differ between ranks, and
        # feedback re-pricing would drift their plans apart (divergent
        # plans issue divergent collectives -- a hang).
        if record_runtimes is None:
            record_runtimes = (self.planner.cost_source.name != "static"
                               and _cluster.process_count() == 1)
        self.record_runtimes = bool(record_runtimes)
        self.compile_cache_size = int(compile_cache_size)
        self._compiled: "OrderedDict[MatchQuery, CompiledMatch]" = \
            OrderedDict()
        # Q-gram filter index: attached up front (the signature pack is
        # lazy, so an engine that never filters pays nothing).  Engines
        # sharing a corpus share its index -- resident signatures and
        # selectivity calibration -- instead of stacking observers.
        if isinstance(index, CorpusIndex):
            if index.corpus is not self.corpus:
                raise ValueError("index is attached to a different corpus")
            self.index: Optional[CorpusIndex] = index
        elif index and self.corpus.fragment_chars >= _ix.DEFAULT_Q:
            self.index = next(
                (ix for ix in self.corpus._indexes
                 if isinstance(ix, CorpusIndex)), None) \
                or CorpusIndex(self.corpus)
        else:
            self.index = None

    def __repr__(self) -> str:
        c = self.corpus
        axes = (None if self._row_axes is None else
                ",".join(self._row_axes))
        return (f"MatchEngine(rows={c.n_rows}, capacity={c.capacity}, "
                f"shards={self._row_shards}"
                + (f" over {axes}" if axes else "")
                + f", device={self.device}, "
                f"cost={self.planner.cost_source.tag})")

    @property
    def n_shards(self) -> int:
        """Resolved mesh row shards (1 when unsharded or replicated)."""
        return self._row_shards

    def shard_live_rows(self) -> np.ndarray:
        """(S,) live rows per shard (cyclic layout: balanced to +-1 row)."""
        return self.corpus.shard_live_rows

    def _per_shard(self, x) -> list:
        """A tensor (or tuple of tensors, or None) on each local shard's
        device: one entry a shard (``None`` for another process's), the
        same object where devices repeat."""
        copies: dict = {None: None}
        for d in self.corpus.devices:
            if d not in copies:
                copies[d] = (None if x is None else
                             tuple(t.to(d) for t in x)
                             if isinstance(x, tuple) else x.to(d))
        return [copies[d] for d in self.corpus.devices]

    # -- compilation ----------------------------------------------------------
    def compile(self, query: MatchQuery, *,
                cached: bool = True) -> CompiledMatch:
        """Lower a query once (plan + pack); LRU-cached by query content."""
        if not isinstance(query, MatchQuery):
            raise TypeError("compile() takes a MatchQuery; use "
                            "MatchQuery.exact/from_masks/iupac or the "
                            "match(patterns, ...) shim")
        if cached:
            hit = self._compiled.get(query)
            if hit is not None:
                self._compiled.move_to_end(query)
                return hit
        cm = CompiledMatch(self, query)
        if cached:
            self._compiled[query] = cm
            while len(self._compiled) > self.compile_cache_size:
                self._compiled.popitem(last=False)
        return cm

    # -- planning -------------------------------------------------------------
    def _infer_mode(self, query: MatchQuery, n_rows: int) -> str:
        if len(query.shape) == 1:
            return "shared"
        mode = query.mode
        if mode is not None:
            if mode == "per_row" and query.shape[0] != n_rows:
                raise ValueError(
                    "per_row patterns must have one row per corpus row: "
                    f"got {query.shape[0]} pattern rows for {n_rows} live "
                    "rows (did the corpus grow since the query was "
                    "compiled?)")
            return mode
        # (Q, P) with Q == n_rows is ambiguous: the mxu kernel is
        # inherently batched, everything else reads a row-count match as
        # per-row.  Pass mode= to be explicit.
        if query.backend == "mxu":
            return "batched"
        return "per_row" if query.shape[0] == n_rows else "batched"

    def _plan_query(self, query: MatchQuery, n_rows: int,
                    mode: Optional[str] = None,
                    filter_ctx: Optional[FilterContext] = None) -> Plan:
        if mode is None:
            mode = self._infer_mode(query, n_rows)
        elif mode == "per_row" and query.shape[0] != n_rows:
            raise ValueError(
                f"per_row query compiled for {query.shape[0]} corpus rows "
                f"cannot run against {n_rows} live rows; per_row queries "
                "are geometry-bound to their compile-time corpus -- "
                "recompile with one pattern per current corpus row")
        topk_k = 0
        if query.reduction == "topk":
            kv = np.asarray(query.k if query.k else (10,), np.int64)
            topk_k = int(kv.max()) if kv.size else 10
        return self.planner.plan(
            n_rows=n_rows,
            fragment_chars=self.corpus.fragment_chars,
            pattern_chars=query.pattern_chars,
            n_patterns=query.n_patterns if mode == "batched" else None,
            per_row=mode == "per_row", backend=query.backend,
            chunk_rows=query.chunk_rows, predicate=query.predicate,
            filter_ctx=filter_ctx, n_shards=self._row_shards,
            reduction=query.reduction, topk_k=topk_k,
            one_card=self.one_card)

    @property
    def one_card(self) -> bool:
        """Every row shard on one card: a cross-shard join is a copy
        within device memory, not over a link.  Every process of a mesh
        across processes reads the same answer off the mesh."""
        return self._row_shards == 1 or self.mesh.n_cards == 1

    # -- q-gram filter stage ----------------------------------------------------
    def _filter_context(self, query: MatchQuery, mode: Optional[str],
                        ops: Optional[FilterOperands] = None
                        ) -> Tuple[Optional[FilterContext],
                                   Optional[FilterOperands]]:
        """Filter eligibility + pricing inputs + operands for one query.

        ``(None, None)`` when the two-stage strategy is not legal: the
        filter prunes whole rows, so only the ``threshold`` reduction
        (whose ``hits`` provably lose nothing) qualifies; explicit row
        subsets keep their own gather path; per-row patterns have no
        shared signature.  Ineligible or unprunable queries scan -- the
        filter is an optimization, never a semantic change.  ``ops``
        short-circuits the operand build (they derive from the query
        content and the index parameters only).

        A sharded engine never drops ``filter=True`` to a full scan
        silently: when the forced strategy is impossible it raises.
        """
        if query.filter is True and self._row_shards > 1:
            why = None
            if self.index is None:
                why = "no CorpusIndex is attached (index=False)"
            elif query.rows_b is not None:
                why = "row-subset queries keep their own gather path"
            elif mode == "per_row":
                why = "per-row patterns have no shared signature"
            elif query.pattern_chars < self.index.q:
                why = (f"pattern ({query.pattern_chars} chars) is shorter "
                       f"than the index q-gram (q={self.index.q})")
            if why is not None:
                raise ValueError(
                    f"sharded engine cannot honor filter=True: {why}; "
                    "pass filter=None to let the planner decide or "
                    "filter=False to scan")
        if (self.index is None or query.filter is False
                or query.reduction != "threshold"
                or query.rows_b is not None or mode == "per_row"
                or query.pattern_chars < self.index.q):
            return None, None
        masks2d = query.masks if len(query.shape) == 2 else \
            query.masks[None, :]
        if ops is None:
            thr = query.threshold
            if len(thr) == 1 and masks2d.shape[0] > 1:
                thr = thr * masks2d.shape[0]
            ops = build_query_filter(masks2d, thr, self.index.q,
                                     self.index.n_bits)
        # A query whose slack covers all its required bits passes every
        # row (so does one with no fully-exact q-grams): in a survivor
        # union one such member makes the whole filter pointless.  The
        # operands are still returned, so a held query does not rebuild
        # them on every revalidation.
        prunable = all(s < 0 or (b > 0 and s < b)
                       for b, s in zip(ops.n_bits, ops.slacks))
        if not prunable:
            return None, ops
        frac = self.index.estimate_survivor_frac(ops.n_bits, ops.slacks)
        ctx = FilterContext(sig_words=self.index.sig_words,
                            n_queries=masks2d.shape[0], prunable=True,
                            survivor_frac=frac,
                            force=query.filter is True)
        return ctx, ops

    def _run_filter(self, cm: CompiledMatch, n_rows: int) -> np.ndarray:
        """Filter stage: (n_rows,) bool candidate flags for one query.

        One ``filter_qgram`` launch per pattern per shard over the
        resident signatures; a row survives if any pattern admits it (the
        batched union, OR-ed on each shard's device); the shards join
        back in logical row order and the final bitmap crosses in one
        pull.  The exact scan's data is never touched for pruned rows.
        Each shard scans its live extent, ``ceil(n_rows / S)`` slots
        padded to the filter tile (the q-gram lemma is a per-row
        property, so it holds shard by shard).
        """
        ops = cm._filter_ops
        if cm._filter_dev is None:
            cm._filter_dev = torch.from_numpy(
                np.ascontiguousarray(ops.qsig_words).view(np.int32)).to(
                    self.device)
        qsigs = self._per_shard(cm._filter_dev)
        sigs = self.index.signature_shards()
        tile = _fq.FILTER_ROW_TILE
        jn = min(first_local(sigs).shape[0],
                 -(-(-(-n_rows // self._row_shards)) // tile) * tile)
        flags = None
        for qi in range(ops.qsig_words.shape[0]):
            f = [None if sg is None else
                 _fq.filter_qgram(sg[:jn], qs[qi:qi + 1],
                                  slack=ops.slacks[qi])
                 for sg, qs in zip(sigs, qsigs)]
            flags = f if flags is None else self.merger.or_(flags, f)
        return self.merger.survivor_union(flags, n_rows)

    def plan(self, patterns, *, backend=_UNSET, mode=_UNSET, rows=_UNSET,
             chunk_rows=_UNSET) -> Plan:
        """Plan without executing (kwarg shim over ``_plan_query``)."""
        query = as_query(patterns, backend=backend, mode=mode, rows=rows,
                         chunk_rows=chunk_rows)
        n_rows = (len(query.rows) if query.rows is not None
                  else self.corpus.n_rows)
        return self._plan_query(query, n_rows)

    # -- kernel dispatch (one chunk, pure device) -----------------------------
    def _launches(self, c0: int, c1: int, idx: Optional[torch.Tensor],
                  idx_log: Optional[np.ndarray]
                  ) -> Tuple[List[_Launch], Optional[np.ndarray]]:
        """The kernel launches of query rows [c0, c1), and, for gathered
        rows, the order the merger joins them in.

        Resident rows: one launch of slots [c0/S, c1/S) a local shard
        (the whole chunk with one shard).  Gathered rows (``idx``: padded
        row ids on the device, ``idx_log`` the same on the host): one
        launch on the one shard, or, with shards, one a local shard that
        holds some of the chunk's rows, its slots padded to the SWAR row
        tile; the order lists the chunk positions of every shard's rows,
        in shard order (``ShardMerger.join_rows``).
        """
        S = self._row_shards
        if idx is None:
            if S == 1:
                return [_Launch(0, slice(c0, c1))], None
            return [_Launch(s, slice(c0 // S, c1 // S))
                    for s in self.corpus.local_shards], None
        if S == 1:
            return [_Launch(0, idx[c0:c1])], None
        ids = idx_log[c0:c1]
        owner = ids % S
        parts = [(s, np.flatnonzero(owner == s))
                 for s in self.corpus.local_shards]
        parts = [(s, pos) for s, pos in parts if pos.size]
        order = np.argsort(owner, kind="stable")
        if not parts:
            return [], order
        # Every launch's slots in one upload, each padded to the row tile.
        tile = _swar.ROW_TILE
        ends = np.cumsum([-(-pos.size // tile) * tile for _, pos in parts])
        slots = np.zeros(int(ends[-1]), np.int64)
        starts = np.concatenate([[0], ends[:-1]])
        for (s, pos), a in zip(parts, starts):
            slots[a:a + pos.size] = ids[pos] // S
        dev = torch.from_numpy(slots).to(self.device)
        return [_Launch(s, dev[a:b].to(self.corpus.devices[s]), pos)
                for (s, pos), a, b in zip(parts, starts, ends)], order

    def _chunk_out(self, launches: List[_Launch], order, outs: list):
        """Per-launch outputs -> the chunk's: the one tensor (one shard),
        a tensor a shard (resident rows, cyclic layout; ``None`` for
        another process's shard), or one tensor in query order on the
        join device (gathered rows, ``order`` set)."""
        if self._row_shards == 1:
            return outs[0]
        if order is None:
            full: List[Optional[torch.Tensor]] = [None] * self._row_shards
            for ln, o in zip(launches, outs):
                full[ln.shard] = o
            return full
        return self.merger.join_rows(
            [o[:ln.pos.size] for ln, o in zip(launches, outs)], order)

    def _refuse_multiprocess(self, plan: Plan) -> None:
        """Per-row and batched SWAR layouts tile or interleave pattern
        rows across shards, which has no multi-process lowering in the
        reference either: refuse them with its message."""
        if (self.merger.multiprocess and plan.backend == "swar"
                and plan.mode in ("per_row", "batched")):
            raise NotImplementedError(
                f"{plan.mode} SWAR queries are not supported on a "
                "multi-process mesh (shared-pattern queries and the "
                "batched MXU backend are); use backend=\"mxu\" or run "
                "the patterns as separate queries")

    def _chunk_scores(self, plan: Plan, pats2d: np.ndarray, c0: int,
                      c1: int, packed: list, idx: Optional[torch.Tensor],
                      idx_log: Optional[np.ndarray] = None):
        """Scores for query rows [c0, c1): (rows, L) or (rows, L, Q) int32,
        or, for a sharded resident chunk, a list of a shard's each.

        ``pats2d`` is the 2-D pattern operand for the ref backend -- codes
        for exact plans, accept masks for accept plans.  ``packed`` holds
        the pattern operands on each shard's device.  ``idx`` (padded row
        ids on the device) is set for row-subset queries: the chunk is
        gathered from the resident forms instead of sliced; ``idx_log``
        carries the same ids on the host.
        """
        dev = self.device
        if plan.backend == "ref":
            if idx is not None:
                rows = self.corpus.fragments[idx_log[c0:min(c1, plan.n_rows)]]
            else:
                rows = self.corpus.fragments[c0:min(c1, self.corpus.n_rows)]
            frags = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
            pats = torch.from_numpy(np.array(pats2d)).to(dev)
            fn = (_kref.match_scores_masks_ref if plan.predicate == "accept"
                  else _kref.match_scores_ref)
            if plan.mode == "batched":
                return torch.stack([fn(frags, pats[q])
                                    for q in range(plan.n_patterns)], -1)
            return fn(frags, pats[c0:c1] if plan.mode == "per_row" else pats)

        self._refuse_multiprocess(plan)
        launches, order = self._launches(c0, c1, idx, idx_log)
        return self._chunk_out(launches, order, [
            self._launch_scores(plan, c0, c1, ln, packed[ln.shard])
            for ln in launches])

    def _launch_scores(self, plan: Plan, c0: int, c1: int, ln: _Launch,
                       packed) -> torch.Tensor:
        """One launch's (rows, L[, Q]) int32 scores."""
        if plan.backend == "swar":
            kern = (_swar.match_swar_masks if plan.predicate == "accept"
                    else _swar.match_swar)
            out = kern(*self._swar_operands(plan, c0, c1, ln, packed),
                       n_locs=plan.n_locs, pattern_chars=plan.pattern_chars)
            if plan.mode == "batched":
                return out.reshape(plan.n_patterns, -1, plan.n_locs
                                   ).permute(1, 2, 0)
            return out

        # mxu
        ref_flat = self.corpus.onehot_shards(plan.f_chars)[ln.shard][ln.rows]
        out = _mxu.match_mxu(ref_flat, packed, l_pad=plan.l_pad)
        scores = torch.round(out[:, :plan.n_locs, :plan.n_patterns]
                             ).to(torch.int32)
        return scores[:, :, 0] if plan.mode != "batched" else scores

    def _swar_operands(self, plan: Plan, c0: int, c1: int, ln: _Launch,
                       packed):
        """(words, pattern rows, valid mask) of one SWAR launch: a batched
        plan tiles the launch's rows Q times and rides each pattern as a
        per-row pattern (one launch for all Q queries, rows ordered
        pattern-major); a shared pattern is a row stride-0 view; per-row
        patterns follow the launch's query positions, zero past them."""
        words = self.corpus.swar_shards(plan.need_words)[ln.shard][ln.rows]
        pat_rows, mask = packed   # (Q, Wp) words or (Q, 4*Wp) planes
        if plan.mode == "per_row":
            r_pad = words.shape[0]
            if self._row_shards == 1:
                rows = pat_rows[c0:min(c1, pat_rows.shape[0])]
            else:
                S = self._row_shards
                pos = (np.arange(r_pad) * S + ln.shard if ln.pos is None
                       else ln.pos)
                q = c0 + pos[c0 + pos < pat_rows.shape[0]]
                rows = pat_rows[torch.from_numpy(q).to(pat_rows.device)]
            if rows.shape[0] < r_pad:
                rows = torch.cat([rows, rows.new_zeros(
                    (r_pad - rows.shape[0], rows.shape[1]))], 0)
            return words, rows, mask
        if plan.mode == "batched":
            Rc = words.shape[0]
            return (words.repeat(plan.n_patterns, 1),
                    pat_rows.repeat_interleave(Rc, 0), mask)
        return words, pat_rows[0][None, :].expand(words.shape[0], -1), mask

    def _chunk_best(self, plan: Plan, c0: int, c1: int, packed: list,
                    idx: Optional[torch.Tensor],
                    idx_log: Optional[np.ndarray] = None):
        """(best_loc, best_score) for query rows [c0, c1), each (rows, q)
        int32 (a list of a shard's each for a sharded resident chunk),
        from kernels that reduce in their epilogue: ``match_mxu_best``
        (q = q_pad) or, for exact SWAR, ``match_swar_best`` (q = Q
        batched, else 1)."""
        self._refuse_multiprocess(plan)
        launches, order = self._launches(c0, c1, idx, idx_log)
        outs = [self._launch_best(plan, c0, c1, ln, packed[ln.shard])
                for ln in launches]
        return (self._chunk_out(launches, order, [o[0] for o in outs]),
                self._chunk_out(launches, order, [o[1] for o in outs]))

    def _launch_best(self, plan: Plan, c0: int, c1: int, ln: _Launch,
                     packed) -> Tuple[torch.Tensor, torch.Tensor]:
        """One fused launch's (rows, q) best locations and scores."""
        if plan.backend == "mxu":
            ref_flat = self.corpus.onehot_shards(
                plan.f_chars)[ln.shard][ln.rows]
            return _mxu.match_mxu_best(ref_flat, packed, n_locs=plan.n_locs,
                                       n_k=4 * plan.pattern_chars)
        bl, bs = _swar.match_swar_best(
            *self._swar_operands(plan, c0, c1, ln, packed),
            n_locs=plan.n_locs, pattern_chars=plan.pattern_chars)
        q = plan.n_patterns if plan.mode == "batched" else 1
        return bl.reshape(q, -1).t(), bs.reshape(q, -1).t()

    # -- empty subsets --------------------------------------------------------
    def _empty_plan(self, query: MatchQuery,
                    mode: Optional[str] = None) -> Plan:
        """Zero-row plan for a query with no rows to scan (geometry checked)."""
        P = query.pattern_chars
        F = self.corpus.fragment_chars
        if P < 1:
            raise ValueError("pattern must have at least one character")
        L = F - P + 1
        if L <= 0:
            raise ValueError("pattern longer than fragment")
        if len(query.shape) == 1:
            mode, Q = "shared", 1
        else:
            if mode is None:
                mode = query.mode if query.mode is not None else "batched"
            Q = query.n_patterns
        return Plan(backend="ref", mode=mode, n_rows=0, fragment_chars=F,
                    pattern_chars=P, n_patterns=Q if mode == "batched"
                    else 1, n_locs=L, chunk_rows=0,
                    reason="empty row subset", predicate=query.predicate)

    def _empty_result(self, query: MatchQuery, plan: Plan) -> MatchResult:
        """Well-formed all-empty MatchResult for a zero-row subset query."""
        batched = plan.mode == "batched"
        Q = plan.n_patterns
        shape0 = (0, Q) if batched else (0,)
        res = MatchResult(plan=plan,
                          best_locs=np.zeros(shape0, np.int32),
                          best_scores=np.zeros(shape0, np.int32),
                          n_shards=self._row_shards,
                          merge_path=self.merger.merge_path)
        if query.reduction == "full":
            res.scores = np.zeros((0, plan.n_locs, Q) if batched
                                  else (0, plan.n_locs), np.int32)
        elif query.reduction == "topk":
            res.topk_rows = np.zeros(shape0, np.int32)
            res.topk_scores = np.zeros(shape0, np.int32)
        elif query.reduction == "threshold":
            res.hits = np.zeros((0, 4 if batched else 3), np.int64)
        return res

    # -- execution ------------------------------------------------------------
    def match(self, patterns, *, backend=_UNSET, mode=_UNSET, rows=_UNSET,
              reduction=_UNSET, k=_UNSET, threshold=_UNSET,
              chunk_rows=_UNSET, filter=_UNSET) -> MatchResult:
        """Run one query (a ``MatchQuery``, or a uint8 code array with the
        legacy kwargs, which this shim folds into a content-cached query).
        ``filter`` is ``MatchQuery.filter``: ``True`` forces the q-gram
        filter stage (threshold queries only), ``False`` forbids it,
        ``None`` leaves it to the planner."""
        query = as_query(patterns, backend=backend, mode=mode, rows=rows,
                         reduction=reduction, k=k, threshold=threshold,
                         chunk_rows=chunk_rows, filter=filter)
        return self.compile(query).run()

    def scores(self, patterns, *, backend=_UNSET, mode=_UNSET, rows=_UNSET,
               chunk_rows=_UNSET) -> np.ndarray:
        """Full materialized score tensor (compat path for small problems)."""
        query = as_query(patterns, backend=backend, mode=mode, rows=rows,
                         chunk_rows=chunk_rows)
        query = dataclasses.replace(query, reduction="full", k=(),
                                    threshold=None)
        return self.match(query).scores
