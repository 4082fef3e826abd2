"""Standing queries: device-resident pattern bank (port of
``repro.match.standing``).

Patterns are the resident axis here and the arriving documents the
transient one -- a fixed set of detectors scored against every batch.

* **Registration freezes.**  ``register`` normalizes any pattern spelling
  (IUPAC string, code array, 1-D ``MatchQuery``) through ``as_masks`` and
  freezes it as a threshold ``MatchQuery`` -- the same IR an ad-hoc caller
  would compile, which is what the parity tests compare against.  Each
  pattern carries an id, a threshold, an optional TTL and an optional hit
  callback.
* **Residency protocol.**  Host buffers are the source of truth; the
  device forms (accept-mask bit planes for the verify kernel; required-
  bit q-gram signatures + per-pattern slacks for the prefilter) pack
  lazily **once** (``plane_pack_count`` / ``sig_pack_count`` <= 1),
  ``register`` / ``unregister`` write only the touched slots in place,
  and growth zero-extends.  Live patterns always occupy slots
  ``[0, n_live)``: ``unregister`` swap-moves the last live slot into the
  hole, so the verify operand is a plain slice.
* **One verify launch per batch.**  ``scan`` scores a document batch
  against every live pattern in a single ``match_swar_masks`` launch with
  the roles swapped (docs on the row axis, the bank on the pattern axis:
  the engine's ``mode="batched"`` formulation), so hits are identical to
  compiling each pattern as an ad-hoc threshold query over the batch.
  The threshold is applied on the device (integer-exact ``s >= ceil(t)``)
  and only the hits cross to the host -- the JAX bank pulls the whole
  (patterns x docs, alignments) score block.
* **Pattern-side prefilter.**  The q-gram lemma read backwards: a doc
  holding a qualifying alignment of pattern p contains all of that
  window's q-grams, so ``popcount(psig & ~docsig) > slack_p`` proves p
  cannot fire on it.  One ``bank_prefilter`` launch prunes the pattern
  axis for the whole batch (doc signatures are hashed on the device);
  ``Planner.plan_bank`` prices prefilter-then-verify against the full
  scan, with a bank-local measured-selectivity EWMA.

Not in this slice: driving the bank from ``MatchService.ingest``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import filter_qgram as _fq
from repro_torch.kernels import match_swar as _swar
from repro_torch.obs import NULL_OBS

from . import index as _idx
from .corpus import pack_words
from .engine import _pack_mask_planes, _valid_mask, _words
from .feedback import EwmaRatio
from .merge import ShardMerger
from .planner import BankPlan, Planner, _swar_geometry
from .query import MatchQuery, as_masks

# Hit array columns (HitTicket.hits): batch-local doc index, alignment
# location, pattern id, similarity score.
HIT_DOC, HIT_LOC, HIT_PATTERN, HIT_SCORE = 0, 1, 2, 3
_I32 = np.iinfo(np.int32)


@dataclasses.dataclass(frozen=True)
class StandingPattern:
    """One registered pattern's frozen metadata (the bank's slot record)."""

    pattern_id: int
    query: MatchQuery            # frozen threshold IR (ad-hoc equivalent)
    threshold: float
    deadline: float              # clock seconds; +inf = no TTL
    n_sig_bits: int              # distinct required signature bits
    slack: int                   # q-gram mismatch budget (< 0: unsat.)


@dataclasses.dataclass
class HitTicket:
    """Result of scanning one document batch against the bank.

    ``hits`` is (n, 4) int64 ``[doc, loc, pattern_id, score]`` in the
    engine's batched-threshold order (ascending doc, then loc, then the
    pattern's launch column) -- per pattern, identical to the ``hits`` of
    an ad-hoc threshold query over the same docs.  ``base_row`` anchors
    the batch: doc ``d`` becomes corpus row ``base_row + d`` once
    appended.
    """

    n_docs: int
    base_row: Optional[int] = None
    hits: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4), np.int64))
    plan: Optional[BankPlan] = None
    n_patterns: int = 0          # live bank slots at scan time
    n_verified: int = 0          # patterns that reached the verify launch
    survivor_frac: Optional[float] = None  # measured (None: no prefilter)
    n_bank_launches: int = 0     # verify launches this scan (0 or 1)
    wall_s: float = 0.0

    @property
    def corpus_rows(self) -> Optional[np.ndarray]:
        """Per-hit corpus row ids (None when the scan was unanchored)."""
        if self.base_row is None:
            return None
        return self.base_row + self.hits[:, HIT_DOC]

    def by_pattern(self) -> Dict[int, np.ndarray]:
        """Hits grouped per pattern id (insertion order = launch order)."""
        out: Dict[int, np.ndarray] = {}
        for pid in np.unique(self.hits[:, HIT_PATTERN]):
            out[int(pid)] = self.hits[self.hits[:, HIT_PATTERN] == pid]
        return out


class PatternBank:
    """Thousands of standing patterns, resident once, scanned per batch.

    ``fragment_chars`` / ``pattern_chars`` fix the launch geometry (every
    pattern has the same length, like every corpus row has the same
    width); ``filter`` is the routing hint with ``MatchQuery.filter``
    semantics (None: price it, True: force the prefilter whenever the
    bank is prunable, False: always full scan).  ``clock`` injects time
    for TTL tests.  ``device=None`` means the CUDA device.
    """

    def __init__(self, fragment_chars: int, pattern_chars: int, *,
                 q: int = _idx.DEFAULT_Q, n_bits: int = _idx.DEFAULT_BITS,
                 capacity: int = 256, planner: Optional[Planner] = None,
                 filter: Optional[bool] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device: DeviceLike = None):
        F, P = int(fragment_chars), int(pattern_chars)
        if P < 1:
            raise ValueError("pattern_chars must be >= 1")
        if F - P + 1 <= 0:
            raise ValueError(
                f"pattern_chars={P} longer than fragment_chars={F}")
        q = int(q)
        n_bits = int(n_bits)
        if q < 1 or q > 16:
            raise ValueError(f"q must be in [1, 16], got {q}")
        if n_bits < 32 or n_bits & (n_bits - 1):
            raise ValueError(
                f"n_bits must be a power of two >= 32, got {n_bits}")
        if filter is not None and not isinstance(filter, bool):
            raise ValueError("filter must be None, True or False")
        self.device = resolve_device(device)
        self.fragment_chars = F
        self.pattern_chars = P
        self.n_locs = F - P + 1
        self.q = q
        self.n_bits = n_bits
        self.sig_words = n_bits // 32
        self.filter = filter
        self.capacity = max(1, int(capacity))
        self.planner = planner or Planner()
        self.clock = clock
        self.wp, self.need_words = _swar_geometry(P, self.n_locs)
        # Host source-of-truth buffers, dense over slots [0, n_live).
        self._masks = np.zeros((self.capacity, P), np.uint8)
        self._sig_host = np.zeros((self.capacity, self.sig_words), np.uint32)
        self._thr = np.zeros(self.capacity, np.float64)
        self._slack = np.full(self.capacity, -1, np.int64)
        self._nbits = np.zeros(self.capacity, np.int32)
        self._ids = np.full(self.capacity, -1, np.int64)
        self._deadline = np.full(self.capacity, np.inf, np.float64)
        self._slots: Dict[int, int] = {}          # pattern id -> slot
        self._patterns: Dict[int, StandingPattern] = {}
        self._callbacks: Dict[int, Callable] = {}
        self.n_live = 0
        self._next_id = 0
        # Device forms (lazy pack-once; slot writes keep them current).
        self._planes: Optional[torch.Tensor] = None     # (cap, 4*Wp) int32
        self._sigs: Optional[torch.Tensor] = None       # (capF, Wb) int32
        self._slacks_dev: Optional[torch.Tensor] = None  # (capF, 1) int32
        self._valid = _words(_valid_mask(P, self.wp), self.device)
        # Residency + scan counters (the invariants tests assert on).
        self.plane_pack_count = 0
        self.sig_pack_count = 0
        self.slot_update_count = 0
        self.generation = 0
        self.n_registered = 0
        self.n_expired = 0
        self.n_scans = 0
        self.n_bank_launches = 0
        self.n_prefilter_launches = 0
        self.n_hits = 0
        self.last_survivor_frac: Optional[float] = None
        self._hit_counts: Dict[int, int] = {}
        # Bank-local measured-selectivity calibration, the discipline of
        # CorpusIndex.record_selectivity.
        self._selectivity = EwmaRatio(decay=0.3, clamp=(0.1, 10.0))
        # Host pulls route through a ShardMerger for transfer accounting;
        # spans record into ``obs``.
        self.merger = ShardMerger()
        self.obs = NULL_OBS

    # -- geometry --------------------------------------------------------------
    @property
    def _cap_filter(self) -> int:
        """Filter-form slot count: capacity padded to the filter row tile."""
        tile = _fq.FILTER_ROW_TILE
        return -(-self.capacity // tile) * tile

    # -- registration ----------------------------------------------------------
    def register(self, pattern, *, threshold: float,
                 ttl_s: Optional[float] = None,
                 on_hit: Optional[Callable] = None) -> int:
        """Freeze one pattern into the bank; returns its pattern id.

        ``pattern`` is an IUPAC string, a uint8 code array, or a 1-D
        ``MatchQuery`` of the bank's ``pattern_chars``.  ``on_hit(
        pattern_id, hits)`` fires from ``scan`` with that pattern's (n, 4)
        hit rows.  The new slot is written into the cached device forms;
        nothing repacks.
        """
        masks = as_masks(pattern)
        if masks.shape[0] != self.pattern_chars:
            raise ValueError(
                f"bank patterns are {self.pattern_chars} chars; got "
                f"{masks.shape[0]}")
        query = MatchQuery.from_masks(masks, reduction="threshold",
                                      threshold=float(threshold))
        fo = _idx.build_query_filter(masks[None, :], (float(threshold),),
                                     self.q, self.n_bits)
        if self.n_live == self.capacity:
            self.reserve(self.capacity * 2)
        slot = self.n_live
        pid = self._next_id
        self._next_id += 1
        deadline = (np.inf if ttl_s is None
                    else self.clock() + float(ttl_s))
        self._masks[slot] = masks
        self._sig_host[slot] = fo.qsig_words[0]
        self._thr[slot] = float(threshold)
        self._slack[slot] = fo.slacks[0]
        self._nbits[slot] = fo.n_bits[0]
        self._ids[slot] = pid
        self._deadline[slot] = deadline
        self._slots[pid] = slot
        self._patterns[pid] = StandingPattern(
            pattern_id=pid, query=query, threshold=float(threshold),
            deadline=float(deadline), n_sig_bits=int(fo.n_bits[0]),
            slack=int(fo.slacks[0]))
        if on_hit is not None:
            self._callbacks[pid] = on_hit
        self._splice_slot(slot)
        self.n_live += 1
        self.n_registered += 1
        self.generation += 1
        return pid

    def unregister(self, pattern_id: int) -> None:
        """Drop one pattern; the last live slot swap-fills the hole.

        Touches at most two slots on the device (the hole and the cleared
        tail), keeping operands dense over ``[0, n_live)`` with flat pack
        counters.
        """
        slot = self._slots.pop(int(pattern_id), None)
        if slot is None:
            raise ValueError(f"unknown pattern id {pattern_id}")
        self._patterns.pop(int(pattern_id))
        self._callbacks.pop(int(pattern_id), None)
        last = self.n_live - 1
        if slot != last:
            for buf in (self._masks, self._sig_host, self._thr,
                        self._slack, self._nbits, self._ids,
                        self._deadline):
                buf[slot] = buf[last]
            self._slots[int(self._ids[slot])] = slot
            self._splice_slot(slot)
        # Clear the vacated tail slot: the verify operand slices
        # [:n_live], but the prefilter scans padded slots -- slack -1
        # guarantees they never survive.
        self._masks[last] = 0
        self._sig_host[last] = 0
        self._thr[last] = 0.0
        self._slack[last] = -1
        self._nbits[last] = 0
        self._ids[last] = -1
        self._deadline[last] = np.inf
        if self._slacks_dev is not None:
            self._slacks_dev[last, 0] = -1
            self.slot_update_count += 1
        self.n_live -= 1
        self.generation += 1

    def expire(self, now: Optional[float] = None) -> List[int]:
        """Unregister every pattern whose TTL deadline has passed."""
        now = self.clock() if now is None else float(now)
        stale = [int(pid) for pid in self._ids[:self.n_live]
                 if self._deadline[self._slots[int(pid)]] <= now]
        for pid in stale:
            self.unregister(pid)
        self.n_expired += len(stale)
        return stale

    def reserve(self, capacity: int) -> None:
        """Grow slot capacity in place; device forms zero-extend.

        No repack (pack counters flat); new filter slots carry slack -1 so
        they can never survive the prefilter.
        """
        capacity = int(capacity)
        if capacity <= self.capacity:
            return
        grow = capacity - self.capacity
        old_capf = self._cap_filter
        self._masks = np.concatenate(
            [self._masks, np.zeros((grow, self.pattern_chars), np.uint8)])
        self._sig_host = np.concatenate(
            [self._sig_host, np.zeros((grow, self.sig_words), np.uint32)])
        self._thr = np.concatenate([self._thr, np.zeros(grow)])
        self._slack = np.concatenate(
            [self._slack, np.full(grow, -1, np.int64)])
        self._nbits = np.concatenate(
            [self._nbits, np.zeros(grow, np.int32)])
        self._ids = np.concatenate([self._ids, np.full(grow, -1, np.int64)])
        self._deadline = np.concatenate(
            [self._deadline, np.full(grow, np.inf)])
        self.capacity = capacity
        if self._planes is not None:
            self._planes = torch.cat(
                [self._planes,
                 self._planes.new_zeros((grow, 4 * self.wp))], 0)
        capf = self._cap_filter
        if capf > old_capf and self._sigs is not None:
            pad = capf - old_capf
            self._sigs = torch.cat(
                [self._sigs, self._sigs.new_zeros((pad, self.sig_words))], 0)
            self._slacks_dev = torch.cat(
                [self._slacks_dev, self._slacks_dev.new_full((pad, 1), -1)],
                0)

    def pattern(self, pattern_id: int) -> StandingPattern:
        """Frozen record for one live pattern (raises if unknown)."""
        try:
            return self._patterns[int(pattern_id)]
        except KeyError:
            raise ValueError(f"unknown pattern id {pattern_id}") from None

    def live_ids(self) -> np.ndarray:
        """(n_live,) pattern ids in slot order (the launch column order)."""
        return np.array(self._ids[:self.n_live])

    # -- device residency ------------------------------------------------------
    def _splice_slot(self, slot: int) -> None:
        """Write one slot's host row into every cached device form."""
        touched = False
        if self._planes is not None:
            planes, _ = _pack_mask_planes(self._masks[slot][None, :],
                                          self.wp)
            self._planes[slot] = _words(planes[0], self.device)
            touched = True
        if self._sigs is not None:
            self._sigs[slot] = _words(self._sig_host[slot], self.device)
            self._slacks_dev[slot, 0] = int(self._slack[slot])
            touched = True
        if touched:
            self.slot_update_count += 1

    def planes(self) -> torch.Tensor:
        """(capacity, 4*Wp) int32 verify operand, packed at most once."""
        if self._planes is None:
            planes = np.zeros((self.capacity, 4 * self.wp), np.uint32)
            if self.n_live:
                live, _ = _pack_mask_planes(self._masks[:self.n_live],
                                            self.wp)
                planes[:self.n_live] = live
            self._planes = _words(planes, self.device)
            self.plane_pack_count += 1
        return self._planes

    def filter_operands(self) -> tuple:
        """((capF, Wb) int32 signatures, (capF, 1) int32 slacks), packed
        at most once."""
        if self._sigs is None:
            capf = self._cap_filter
            sigs = np.zeros((capf, self.sig_words), np.uint32)
            sigs[:self.capacity] = self._sig_host
            slacks = np.full((capf, 1), -1, np.int32)
            slacks[:self.capacity, 0] = np.clip(self._slack, -1, _I32.max)
            self._sigs = _words(sigs, self.device)
            self._slacks_dev = torch.from_numpy(slacks).to(self.device)
            self.sig_pack_count += 1
        return self._sigs, self._slacks_dev

    # -- selectivity model -----------------------------------------------------
    @property
    def prunable(self) -> bool:
        """True iff the prefilter can exclude at least one live pattern."""
        n = self.n_live
        return bool(n and (self._slack[:n] < self._nbits[:n]).any())

    def estimate_survivor_frac(self, *, calibrated: bool = True) -> float:
        """Estimated fraction of live patterns surviving one doc batch.

        Per pattern: P(#absent required bits <= slack) against a document
        at the analytic occupancy density (the bank never indexes the
        transient docs) -- mean over patterns.  ``calibrated`` folds in
        the bank-local measured EWMA.
        """
        n = self.n_live
        if not n:
            return 0.0
        d = _idx.expected_density(self.fragment_chars, self.q, self.n_bits)
        total = sum(_idx.pass_probability(int(self._nbits[i]),
                                          int(self._slack[i]), d)
                    for i in range(n))
        frac = total / n
        if calibrated and self._selectivity.value is not None:
            frac *= self._selectivity.value
        return float(min(1.0, frac))

    # -- the scan --------------------------------------------------------------
    def scan(self, docs: np.ndarray, *, base_row: Optional[int] = None
             ) -> HitTicket:
        """Score one arriving batch against every live pattern.

        One fused ``match_swar_masks`` launch regardless of bank size
        (``n_bank_launches`` increments by exactly one), optionally
        preceded by one ``bank_prefilter`` launch when the planner prices
        the two-stage path cheaper.  Empty batches and empty banks launch
        nothing.
        """
        t0 = time.perf_counter()
        docs = np.asarray(docs, np.uint8)
        if docs.ndim == 1:
            docs = docs[None, :]
        if docs.ndim != 2 or docs.shape[1] != self.fragment_chars:
            raise ValueError(
                f"docs must be (n, {self.fragment_chars}); got "
                f"{docs.shape}")
        D = docs.shape[0]
        ticket = HitTicket(n_docs=D, base_row=base_row,
                           n_patterns=self.n_live)
        if D == 0 or self.n_live == 0:
            return ticket
        self.n_scans += 1
        tr = self.obs.tracer
        with tr.span("bank.scan",
                     {"n_docs": D, "n_patterns": self.n_live}
                     if tr.enabled else None):
            with tr.span("plan") as sp_plan:
                plan = self.planner.plan_bank(
                    n_docs=D, fragment_chars=self.fragment_chars,
                    pattern_chars=self.pattern_chars,
                    n_patterns=self.n_live, sig_words=self.sig_words,
                    survivor_frac=self.estimate_survivor_frac(),
                    prunable=self.prunable, force=self.filter)
                if tr.enabled:
                    sp_plan.set("strategy", plan.strategy)
                    sp_plan.set("est_seconds", plan.est_seconds)
            ticket.plan = plan
            codes = torch.from_numpy(docs).to(self.device)
            slots = np.arange(self.n_live, dtype=np.int64)
            if plan.strategy == "filter":
                with tr.span("filter",
                             {"op": "bank_prefilter"}
                             if tr.enabled else None) as sp_fil:
                    slots = self._prefilter(codes)
                    ticket.survivor_frac = len(slots) / self.n_live
                    if tr.enabled:
                        sp_fil.set("survivor_frac", ticket.survivor_frac)
            ticket.n_verified = len(slots)
            if len(slots):
                with tr.span("launch",
                             {"op": "bank_verify", "n_verified": len(slots)}
                             if tr.enabled else None):
                    hits = self._verify(codes, slots)
                ticket.n_bank_launches = 1
                ticket.hits = hits
                self.n_hits += hits.shape[0]
                self._deliver(hits)
        ticket.wall_s = time.perf_counter() - t0
        return ticket

    def _prefilter(self, codes: torch.Tensor) -> np.ndarray:
        """One ``bank_prefilter`` launch -> surviving live slot ids.

        The docs' occurrence signatures are hashed on the device.
        """
        doc_sigs, _ = _idx.signature_words(codes, self.q, self.n_bits)
        sigs, slacks = self.filter_operands()
        flags = self.merger.pull(_fq.bank_prefilter(sigs, doc_sigs,
                                                    slacks))[:, 0]
        self.n_prefilter_launches += 1
        survivors = np.flatnonzero(flags[:self.n_live]).astype(np.int64)
        measured = len(survivors) / self.n_live
        self._selectivity.update(
            measured / max(self.estimate_survivor_frac(calibrated=False),
                           1e-9))
        self.last_survivor_frac = measured
        return survivors

    def _verify(self, codes: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        """One fused roles-swapped batched launch -> (n, 4) hit rows.

        The engine's ``mode="batched"`` execution: tile the doc words per
        pattern, repeat each pattern's planes per doc row, one
        ``match_swar_masks`` launch.  The threshold is applied on the
        device, ``s >= ceil(t)`` (scores are integers, so this selects
        exactly ``s >= t``), and only the hits are pulled; they are then
        put in the engine's order (doc, loc, launch column).
        """
        D = codes.shape[0]
        Qs = len(slots)
        dev = self.device
        d_pad = -(-D // _swar.ROW_TILE) * _swar.ROW_TILE
        words = codes.new_zeros((d_pad, self.need_words), dtype=torch.int32)
        words[:D] = pack_words(codes, self.need_words)
        planes_all = self.planes()
        if Qs == self.n_live:
            planes_sel = planes_all[:self.n_live]   # dense slice, no gather
        else:
            planes_sel = planes_all[torch.from_numpy(slots).to(dev)]
        out = _swar.match_swar_masks(
            words.repeat(Qs, 1), planes_sel.repeat_interleave(d_pad, 0),
            self._valid, n_locs=self.n_locs,
            pattern_chars=self.pattern_chars)
        self.n_bank_launches += 1
        sc = out.view(Qs, d_pad, self.n_locs)[:, :D]
        thr_int = np.clip(np.ceil(self._thr[slots]), _I32.min,
                          _I32.max).astype(np.int32)
        hot = sc >= torch.from_numpy(thr_int).to(dev).view(Qs, 1, 1)
        where = self.merger.pull(torch.nonzero(hot))        # (n, 3) q, d, l
        if not where.shape[0]:
            return np.zeros((0, 4), np.int64)
        vals = self.merger.pull(sc[hot])
        q, d, loc = where[:, 0], where[:, 1], where[:, 2]
        order = np.lexsort((q, loc, d))
        pids = self._ids[slots[q]]
        return np.column_stack([d, loc, pids, vals])[order].astype(np.int64)

    def _deliver(self, hits: np.ndarray) -> None:
        """Per-pattern hit accounting + callback dispatch."""
        for pid in np.unique(hits[:, HIT_PATTERN]):
            pid = int(pid)
            mine = hits[hits[:, HIT_PATTERN] == pid]
            self._hit_counts[pid] = (self._hit_counts.get(pid, 0)
                                     + mine.shape[0])
            cb = self._callbacks.get(pid)
            if cb is not None:
                cb(pid, mine)

    # -- stats -----------------------------------------------------------------
    def hit_counts(self) -> Dict[int, int]:
        """Cumulative per-pattern hit counts (live and expired patterns)."""
        return dict(self._hit_counts)

    def stats(self) -> dict:
        return {
            "n_live": self.n_live,
            "capacity": self.capacity,
            "n_registered": self.n_registered,
            "n_expired": self.n_expired,
            "generation": self.generation,
            "q": self.q,
            "n_bits": self.n_bits,
            "plane_pack_count": self.plane_pack_count,
            "sig_pack_count": self.sig_pack_count,
            "slot_update_count": self.slot_update_count,
            "n_scans": self.n_scans,
            "n_bank_launches": self.n_bank_launches,
            "n_prefilter_launches": self.n_prefilter_launches,
            "n_hits": self.n_hits,
            "last_survivor_frac": self.last_survivor_frac,
            "calibration": (None if self._selectivity.value is None
                            else round(self._selectivity.value, 4)),
            "hits_by_pattern": self.hit_counts(),
        }
