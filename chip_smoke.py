#!/usr/bin/env python3
"""Drive the PyTorch port's match path on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA device, the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``.  Phases, each
printing its wall time:

1. Environment: torch / CUDA versions, the card's name and power limit.
2. Build: the five CUDA sources with nvcc, in parallel; the
   ``-Xptxas -v`` resource summary.
3. Kernels against their plain versions at edge shapes, bit for bit
   (``match_swar_best`` also on a read planted at two alignments and an
   all-zero row; ``popcount_rows`` at ragged row counts, rows counted by
   several threads and rows streamed in chunks).
4. Main path at the size of GRCh38 chr1 (248,956,422 bp, seeded random
   DNA of that length folded into 500-char rows for 100-char reads):
   ``MatchEngine`` (q-gram index attached, the default) ->
   ``compile(MatchQuery)`` -> ``run()`` for (a) an exact read, best,
   SWAR with the best reduction in the kernel's epilogue
   (``match_swar_best``); (b) an IUPAC read, threshold 95, SWAR
   accept-set; (c) 128
   batched reads with 0-3 mismatches, top-10, tensor cores with the best
   reduction in the kernel's epilogue (``match_mxu_best``); (d) read (a)
   with the planner's own choice; (c') (c)'s reads at threshold 97 on the
   tensor cores over a 16,384-row subset holding the planted rows (the
   full-block ``match_mxu``); then (e) read (a) at threshold 99 with the
   filter forced (filter-then-verify, the survivors through the
   full-block ``match_swar``) and (f) the same with the planner's
   choice.  Launch counters are zeroed just before each query and read
   just after; (a) and (b) are held against the ``ref`` backend on the
   full corpus, (e) against the same query scanned.
4b. Standing bank: ``PatternBank(500, 100)`` with 4,096 patterns drawn
   from the reference, scanned against 4 batches of 256 seeded 500-char
   docs (32 planted hits each) with the prefilter forced on and off;
   both hit sets equal, every planted hit found, sampled patterns equal
   ad-hoc threshold queries.
4c. Bulk ops: ``ops.popcount`` over the resident SWAR form (its rows
   unpadded; its host-clock time, the least of 20 calls each ending in
   ``torch.cuda.synchronize()``) and ``ops.bitwise("XOR", ...)`` on a
   256 MiB pair.
5. Kernels at their paths' shapes: each kernel against its plain
   version at (or beyond) its launch shape with the path's own
   operands, bit for bit (``match_swar_best`` at (a)'s launch, the
   full-block ``match_swar`` at (e)'s verify launch, whose operands one
   run of (e) hands over, and at (a)'s chunk; ``popcount`` at the SWAR
   form padded to 256-row tiles, the launch earlier builds were timed
   at, and at its rows unpadded, the bulk path's own launch);
   ``match_mxu_best`` also
   against the full-block kernel plus ``argmax``/``amax`` on every
   corpus row, and (c)'s top-10 against the top-10 of those best scores;
   at the launch shape, the kernel's and the library call's device time
   with the L2 flushed before each launch (``torch.profiler`` through
   ``obs.device_time``, which retakes a reading with device events lost;
   kernel and library timed in turns), the kernel's time per call and
   the plain version's (CUDA events, back to back), beside the roofline
   bound (for the exact SWAR kernels, from the shipped mainloop's own
   operation counts).
6. Profile: one run each of (a), (c) and (e) under ``torch.profiler``
   (device time by kernel, device busy share) and one under the
   engine's own span tracer (host stage breakdown).
7. Service: ``MatchService`` over phase 4's engine with phase 4b's bank
   (its prefilter the planner's choice) and a window of the corpus's
   rows.  Tick 1 serves three tenants' groups (32 exact best reads with
   0-3 mismatches, 8 exact reads at threshold 99, the IUPAC read at 95):
   launches as ``plan_batch`` prices them, every result equal to a solo
   ``engine.match``, every planted read found, no ticket in error, the
   tick's wall time beside the 41 solo runs'.  Tick 2 serves them all
   from the cache with no launch.  Ticks 3-6 ingest phase 4b's batches:
   one bank verify launch each, hits equal to the standalone scans,
   ``n_live`` held at the window, one compaction (timed alone).  Then
   the newest row is found, an evicted row is not, and one traced tick
   shows the service spans.
8. Summary: a ``kernels`` line, the ``{"kernels": [...]}`` JSON line, the
   card's name and power limit, and ``{"ok": true, "device": {...}}``
   as the last line.

Any mismatch raises and the script exits non-zero; no phase catches a
failure.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

CHR1_BP = 248_956_422        # GRCh38 chr1 length
FRAG, READ = 500, 100        # benchmarks/fig5_throughput.py MR_FRAG / MR_PAT
SEED = 0
N_BATCH = 128                # batched reads of query (c)
SUBSET_C2 = 16_384           # rows of query (c'), the planted rows among them
THRESHOLD_C2 = 97            # (c'): every read has at most 3 mismatches
SUBSET_ROWS = 65_536         # rows held kernel-against-plain in phase 5
TIMED_RUNS = 3
# Standing bank (phase 4b): live patterns, docs per batch, batches,
# planted hits per batch, patterns held against ad-hoc queries.
BANK_PATTERNS, BANK_DOCS, BANK_BATCHES, BANK_PLANTED = 4096, 256, 4, 32
BANK_SAMPLE = 24
# Service (phase 7): exact best reads of (c)'s with 0-3 mismatches, and
# exact reads at threshold READ - 1, each taken at a known row.
SVC_BEST, SVC_THR = 32, 8
XOR_BYTES = 256 * 2**20      # each operand of the bulk XOR (phase 4c)
L2_FLUSH_BYTES = 128 * 2**20  # written before each timed launch (50 MB L2)
# Peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W): bf16
# tensor cores, HBM bandwidth, and the CUDA-core INT32 rate (132 SMs x 64
# INT32 ops/clock x 1.98 GHz boost, Hopper white paper).
PEAK_BF16 = 989e12
PEAK_INT32 = 132 * 64 * 1.98e9
HBM_BW = 3.35e12
# Population counts: 16 per clock per SM on compute capability 9.0 (CUDA
# C++ Programming Guide, arithmetic instruction throughput).
PEAK_POPC = 132 * 16 * 1.98e9
# INT32 logic/shift operations per (row, alignment, pattern word) as the
# SWAR kernels' first sm_90a build issued them (cuobjdump): exact = funnel
# shift, xor, shift, fold-and-mask (LOP3); accept-set = 3 shifts, 8 LOP3.
# Each word also takes one popcount, and one add that the compiler issues
# on the FMA pipe (IMAD), not counted.  The accept-set kernel still runs
# that loop; for the exact kernels this count is printed as
# ``bound_ms_first_build``, so their rows compare across builds.
SWAR_INT_OPS_PER_WORD = {"match_swar": 4, "match_swar_best": 4,
                         "match_swar_masks": 11}
# INT32-pipe operations per (row, alignment) of the shipped exact
# mainloop, per pair of pattern words and per unpaired word, from its
# SASS (``python -m repro_torch.kernels.match_swar_variants --sass``): a
# pair issues 3 SHF (two funnel shifts, the second word's >> 1) and 4
# LOP3 (two xors, two fold-and-masks), an unpaired word 1 SHF and 2 LOP3;
# at shift 0 the funnel shifts fold away (2 fewer a pair, 1 fewer a
# word).  Each pair or unpaired word takes one popcount.  The << 1, the
# pair's add and the accumulate issue as IMADs on the FMA pipe, fewer
# than these at no lower a rate, so they never bind; BEST's fold and
# STORE's staging are not counted either.  The bound is the kernels'
# ``bound_ms``.
EXACT_INT_OPS = {"match_swar": (7, 3), "match_swar_best": (7, 3)}
SOURCES = {
    "match_swar": ("src/repro_torch/kernels/csrc/match_swar.cu",
                   "src/repro/kernels/match_swar.py:82"),
    "match_swar_best": ("src/repro_torch/kernels/csrc/match_swar.cu",
                        "src/repro/kernels/match_swar.py:82"),
    "match_swar_masks": ("src/repro_torch/kernels/csrc/match_swar.cu",
                         "src/repro/kernels/match_swar.py:146"),
    "match_mxu": ("src/repro_torch/kernels/csrc/match_mxu.cu",
                  "src/repro/kernels/match_mxu.py:54"),
    "match_mxu_best": ("src/repro_torch/kernels/csrc/match_mxu.cu",
                       "src/repro/kernels/match_mxu.py:54"),
    "filter_qgram": ("src/repro_torch/kernels/csrc/filter_qgram.cu",
                     "src/repro/kernels/filter_qgram.py:63"),
    "bank_prefilter": ("src/repro_torch/kernels/csrc/filter_qgram.cu",
                       "src/repro/kernels/filter_qgram.py:131"),
    "popcount": ("src/repro_torch/kernels/csrc/popcount.cu",
                 "src/repro/kernels/popcount.py:41"),
    "bitwise": ("src/repro_torch/kernels/csrc/bitwise.cu",
                "src/repro/kernels/bitwise.py:41"),
}
BUILD = ("match_swar", "match_mxu", "filter_qgram", "popcount", "bitwise")
# Readings some kernel rows carry beside their own: the exact SWAR bound
# by the first build's count, STORE match_swar at (a)'s chunk, popcount
# over the SWAR form's rows unpadded and its bound there.
EXTRA_MS = ("bound_ms_first_build", "ms_a_chunk", "ms_unpadded",
            "bound_ms_unpadded")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_runs(engine, queries) -> None:
    """Device time by kernel and host stage seconds for one run each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.device_time import device_us
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for key, q in queries.items():
        cm = engine.compile(q)
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            cm.run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        by_kernel = {}
        for ev in prof.key_averages():
            # Device-side events only (kernels, copies): an operator's
            # host event carries its kernels' time again.
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = device_us(ev)
            if us > 0:
                by_kernel[ev.key] = (us / 1e3, ev.count)
        dev_ms = sum(ms for ms, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
        print(f"  ({key}) profiled wall {wall_ms:.3f} ms, device busy "
              f"{dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%)")
        for name, (ms, n) in top:
            print(f"    {ms:10.3f} ms  x{n:<6d} {name[:90]}")
        engine.obs.tracer.enabled = True
        res = cm.run()
        engine.obs.tracer.enabled = False
        engine.obs.tracer.clear()
        print(f"  ({key}) span stages (s): " + json.dumps(
            {k: round(v, 6) for k, v in res.timings.items()}))


def device_ms_turns(fns, reps: int, flush, rounds: int = 2):
    """``device_ms`` of each function, timed in turns (a, b, a, b): the
    mean per function over ``rounds`` and every round's reading."""
    from repro_torch.obs.device_time import device_ms
    runs = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            runs[k].append(device_ms(fn, reps, flush))
    return {k: sum(v) / len(v) for k, v in runs.items()}, runs


def exact_swar_ops(name: str, R: int, n_locs: int, wp: int):
    """(INT32-pipe ops, popcounts) of the shipped exact SWAR mainloop over
    R rows x n_locs alignments of a wp-word pattern (``EXACT_INT_OPS``)."""
    per_pair, per_single = EXACT_INT_OPS[name]
    n_pairs, n_single = divmod(wp, 2)
    n_shift0 = -(-n_locs // 16)           # alignments at shift 0, per row
    int_ops = R * (n_locs * (per_pair * n_pairs + per_single * n_single)
                   - n_shift0 * (2 * n_pairs + n_single))
    return int_ops, R * n_locs * (n_pairs + n_single)


def bound(nbytes: float, ops: float, ops_rate: float):
    """(bound ms, what bounds it): the larger of bytes over HBM bandwidth
    and operations over their peak rate."""
    t_ops, t_bytes = ops / ops_rate, nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def plan_kernel(plan, reduction: str) -> str:
    """The kernel a SWAR or mxu plan launches for a reduction: best and
    top-k reduce in the exact kernels' epilogues (``*_best``)."""
    if plan.backend == "swar" and plan.predicate == "accept":
        return "match_swar_masks"
    fused = "_best" if reduction in ("best", "topk") else ""
    return {"swar": "match_swar", "mxu": "match_mxu"}[plan.backend] + fused


def same_as_solo(got, solo) -> bool:
    """A service result against a solo ``engine.match`` of the same query:
    hits equal, and the best arrays equal on the rows the solo run scanned.
    A filtered threshold query verifies only its survivor rows, and a
    coalesced one the union of its group's, so the best arrays compare on
    the solo run's rows (all rows when neither filtered)."""
    import numpy as np
    if (got.hits is None) != (solo.hits is None) or (
            got.hits is not None and not np.array_equal(got.hits,
                                                        solo.hits)):
        return False
    if got.survivor_rows is None and solo.survivor_rows is None:
        pos = slice(None)
    else:
        rg = (np.arange(len(got.best_locs)) if got.survivor_rows is None
              else got.survivor_rows)
        rs = (np.arange(len(solo.best_locs)) if solo.survivor_rows is None
              else solo.survivor_rows)
        pos = np.searchsorted(rg, rs)
        if np.any(pos >= len(rg)) or not np.array_equal(rg[pos], rs):
            return False
    return (np.array_equal(got.best_locs[pos], solo.best_locs)
            and np.array_equal(got.best_scores[pos], solo.best_scores))


def service_phase(engine, bank, *, best, thr, iupac, batches, bank_hits,
                  evicted_read, n_compactions, zero_counts, read_counts,
                  sync, compact_dead_frac=0.001):
    """Phase 7: ``MatchService`` over the engine's corpus with the bank.

    ``best`` is a list of (codes, row, loc, score) exact reads taken at
    known rows, ``thr`` of (codes, row, loc) exact reads for threshold
    READ - 1, ``iupac`` one (pattern, row, loc) IUPAC read for threshold
    95; ``batches`` are doc batches with ``bank_hits`` the bank's hits on
    each when scanned alone; ``evicted_read`` occurs only in row 0.  The
    window keeps the corpus's live rows; ``n_compactions`` is how many
    compactions the ingests must trigger.  Returns what the phase prints
    as its JSON line.
    """
    import numpy as np

    from repro_torch.match import MatchQuery, MatchService
    corpus, planner = engine.corpus, engine.planner
    F = corpus.fragment_chars
    window = corpus.n_live
    svc = MatchService(engine, bank=bank, window_rows=window,
                       compact_dead_frac=compact_dead_frac)
    stats = svc.stats
    tick_ms, tick_launches = {}, {}

    def timed_tick(label):
        zero_counts()
        t = time.perf_counter()
        n = svc.tick()
        sync()
        tick_ms[label] = (time.perf_counter() - t) * 1e3
        tick_launches[label] = {k: v for k, v in read_counts().items() if v}
        return n, read_counts()

    # -- tick 1: three tenants' groups ------------------------------------
    q_best = [MatchQuery.exact(c, reduction="best") for c, *_ in best]
    q_thr = [MatchQuery.exact(c, reduction="threshold", threshold=READ - 1)
             for c, *_ in thr]
    q_iu = MatchQuery.iupac(iupac[0], reduction="threshold", threshold=95)
    queries = q_best + q_thr + [q_iu]
    groups = [(q_best, "exact"), (q_thr, "exact"), ([q_iu], "accept")]
    want_launches = want_coalesced = want_fallback = 0
    for grp, pred in groups:
        bp = planner.plan_batch(
            n_rows=corpus.n_rows, fragment_chars=F,
            pattern_chars=grp[0].pattern_chars, n_queries=len(grp),
            predicate=pred)
        print(f"  plan_batch Q={len(grp)} {pred} "
              f"{grp[0].reduction}: {bp.reason}")
        want_coalesced += int(bp.coalesced)
        want_launches += 1 if bp.coalesced else len(grp)
        want_fallback += len(grp) if len(grp) > 1 and not bp.coalesced else 0
    tickets = [svc.submit(q) for q in queries]
    n_done, counts1 = timed_tick("1")
    print(f"  tick 1: {n_done} queries in {tick_ms['1']:.3f} ms, launches "
          f"{counts1}")
    check(n_done == len(queries) and all(t.done for t in tickets),
          "tick 1 completes every ticket")
    errors = [repr(t.error) for t in tickets if t.error is not None]
    check(not errors, f"no ticket ends with an error ({errors})")
    check((stats.n_launches, stats.n_coalesced_launches,
           stats.n_sequential_fallback)
          == (want_launches, want_coalesced, want_fallback),
          "tick 1's launches are plan_batch's")
    want_kernels = set()
    for t, q in zip(tickets, queries):
        p = t.result.plan
        if p.backend != "ref":
            want_kernels.add(plan_kernel(p, q.reduction))
        if p.strategy == "filter":
            want_kernels.add("filter_qgram")
    got_kernels = {k for k, n in counts1.items() if n}
    check(got_kernels == want_kernels, f"tick 1 launched {got_kernels}, its "
          f"plans name {want_kernels}")
    for t, (_, row, loc, score) in zip(tickets, best):
        check(int(t.result.best_scores[row]) == score
              and int(t.result.best_locs[row]) == loc,
              f"best read planted at row {row} found at loc {loc}")
    for t, (_, row, loc) in zip(tickets[len(best):], thr):
        check((row, loc, READ) in {tuple(h) for h in t.result.hits.tolist()},
              f"threshold read planted at row {row} reported")
    check(iupac[1:] + (READ,) in
          {tuple(h) for h in tickets[-1].result.hits.tolist()},
          "IUPAC read's planted hit reported")
    # The same 41 queries one by one: each result equals its scattered one.
    solo_ms = {"first": 0.0, "again": 0.0}
    for key in solo_ms:
        for t, q in zip(tickets, queries):
            sync()
            t0 = time.perf_counter()
            solo = engine.match(q)
            sync()
            solo_ms[key] += (time.perf_counter() - t0) * 1e3
            check(same_as_solo(t.result, solo),
                  f"service result equals a solo run ({q.reduction})")
    print(f"  tick 1 {tick_ms['1']:.3f} ms against {len(queries)} solo runs "
          f"{solo_ms['first']:.3f} ms (first) / {solo_ms['again']:.3f} ms "
          "(again); every scattered result equals its solo run")

    # -- tick 2: the same queries from the result cache --------------------
    hits0 = stats.n_cache_hits
    again = [svc.submit(q) for q in queries]
    n_done, counts2 = timed_tick("2")
    check(stats.n_cache_hits - hits0 == len(queries)
          and all(t.cached for t in again), "tick 2 served from the cache")
    check(stats.launches_last_tick == 0 and not any(counts2.values()),
          f"tick 2 launched nothing ({counts2})")
    print(f"  tick 2: {n_done} cache hits in {tick_ms['2']:.3f} ms")

    # -- ticks 3-6: ingest against the bank, past the window ----------------
    compact = corpus.compact
    compact_ms = []

    def timed_compact():
        sync()
        t0 = time.perf_counter()
        out = compact()
        sync()
        compact_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    corpus.compact = timed_compact
    ingest = []
    try:
        for i, (docs, hits) in enumerate(zip(batches, bank_hits)):
            base_row = corpus.n_rows
            tk = svc.ingest(docs)
            label = str(3 + i)
            _, counts = timed_tick(label)
            bt = tk.bank_ticket
            filtered = bt.plan.strategy == "filter"
            check(counts["match_swar_masks"] == 1
                  and counts["bank_prefilter"] == int(filtered),
                  f"tick {label}: one bank verify launch ({counts})")
            check(np.array_equal(bt.hits, hits),
                  f"tick {label}: bank hits equal the standalone scan's")
            check(tk.start == base_row and np.array_equal(
                bt.corpus_rows, base_row + bt.hits[:, 0]),
                f"tick {label}: hits anchored at the appended rows")
            check(corpus.n_live == window, f"tick {label}: n_live == window")
            check(stats.n_evicted_rows == len(docs) * (i + 1),
                  f"tick {label}: evicted {stats.n_evicted_rows}")
            ingest.append({"tick": label, "strategy": bt.plan.strategy,
                           "n_hits": int(bt.hits.shape[0]),
                           "survivor_frac": bt.survivor_frac,
                           "ms": tick_ms[label]})
            print(f"  tick {label}: ingest {len(docs)} docs, bank "
                  f"{bt.plan.strategy}, {bt.hits.shape[0]} hits, "
                  f"{tick_ms[label]:.3f} ms, live {corpus.n_live} of "
                  f"{corpus.n_rows} rows")
            if i == 0:
                # The generation moved: tick 1's first query runs again.
                t = svc.submit(q_best[0])
                timed_tick("3b")
                check(not t.cached and t.error is None,
                      "after an ingest the cache is dropped")
    finally:
        del corpus.compact
    check(stats.n_compactions == corpus.n_compactions == n_compactions
          and len(compact_ms) == n_compactions,
          f"{n_compactions} compaction(s) ({stats.n_compactions})")
    print(f"  compaction: {compact_ms} ms")

    # -- after the window: the newest row found, the evicted one gone -------
    newest = batches[-1][-1][:READ]
    res = svc.match(newest, reduction="threshold", threshold=READ)
    check((corpus.n_rows - 1, 0, READ) in {tuple(h) for h in
                                          res.hits.tolist()},
          "the newest ingested row is found")
    res = svc.match(evicted_read, reduction="threshold", threshold=READ)
    check(res.hits.shape[0] == 0, "the evicted row is gone")
    tracer = engine.obs.tracer
    bp = planner.plan_batch(n_rows=corpus.n_rows, fragment_chars=F,
                            pattern_chars=READ, n_queries=2)
    check(bp.coalesced, "two exact reads coalesce")
    tracer.enabled = True
    try:
        for q in q_best[:2]:
            svc.submit(q)
        timed_tick("traced")
        names = {sp.name for sp in tracer.iter_spans()}
    finally:
        tracer.enabled = False
        tracer.clear()
    want = {"service.tick", "service.coalesce", "service.enqueue"}
    check(want <= names, f"spans {sorted(want - names)} traced")
    snap = stats.snapshot()
    check(snap["n_failed"] == 0, "no ticket failed")
    print("service_stats " + json.dumps(snap))
    print(f"  latency p50 {snap['latency_p50_s'] * 1e3:.3f} ms, p95 "
          f"{snap['latency_p95_s'] * 1e3:.3f} ms, p99 "
          f"{snap['latency_p99_s'] * 1e3:.3f} ms, {snap['qps']} qps")
    return {"tick_ms": tick_ms, "tick_launches": tick_launches,
            "solo_ms": solo_ms, "compact_ms": compact_ms, "ingest": ingest,
            "n_queries": len(queries)}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on an "
              "NVIDIA card", file=sys.stderr)
        return 2

    from repro_torch.convert import swar_words_from_numpy
    from repro_torch.core import encoding
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitwise as kbw
    from repro_torch.kernels import filter_qgram as kfq
    from repro_torch.kernels import match_mxu as kmx
    from repro_torch.kernels import match_swar as ksw
    from repro_torch.kernels import ops
    from repro_torch.kernels import popcount as kpc
    from repro_torch.kernels.ref import as_u32, popcount_words
    from repro_torch.match import (MatchEngine, MatchQuery, PackedCorpus,
                                   PatternBank)
    from repro_torch.match.corpus import one_hot_flat
    from repro_torch.match.engine import _valid_mask
    from repro_torch.match.index import signature_words
    from repro_torch.obs.device_time import device_ms

    dev = torch.device("cuda")
    wrappers = {"match_swar": ksw.match_swar,
                "match_swar_best": ksw.match_swar_best,
                "match_swar_masks": ksw.match_swar_masks,
                "match_mxu": kmx.match_mxu,
                "match_mxu_best": kmx.match_mxu_best,
                "filter_qgram": kfq.filter_qgram,
                "bank_prefilter": kfq.bank_prefilter,
                "popcount": kpc.popcount,
                "bitwise": kbw.bitwise}
    plains = {"match_swar": ksw.match_swar_plain,
              "match_swar_best": ksw.match_swar_best_plain,
              "match_swar_masks": ksw.match_swar_masks_plain,
              "match_mxu": kmx.match_mxu_plain,
              "match_mxu_best": kmx.match_mxu_best_plain}

    def zero_counts():
        for w in wrappers.values():
            w.n_launches = 0

    def read_counts():
        return {n: w.n_launches for n, w in wrappers.items()}

    # -- 1. environment ---------------------------------------------------
    with Phase("phase 1: environment"):
        print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
              f"cuda {torch.version.cuda}  device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"card: {smi}")

    # -- 2. build ---------------------------------------------------------
    with Phase("phase 2: build (nvcc, sm_90a)"):
        _build.build(BUILD)
        for name in BUILD:
            for line in _build.build_log(name).splitlines():
                if "Used" in line or "spill" in line or "entry" in line:
                    print(f"  {name}: {line.strip()}")

    # -- 3. edge shapes -----------------------------------------------------
    def words(a):
        return swar_words_from_numpy(a, dev)

    def u32(rng, shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint32)

    def same(got, want):
        if isinstance(got, tuple):
            return all(torch.equal(x, y) for x, y in zip(got, want))
        return torch.equal(got, want)

    with Phase("phase 3: kernels vs plain versions, edge shapes"):
        rng = np.random.default_rng(SEED)
        # sh == 0 only; P % 16 != 0; Wp 1-3; R exactly 8; P = 100; P > 256.
        for R, P, L in [(8, 16, 1), (8, 7, 40), (16, 23, 33), (8, 40, 17),
                        (24, 100, 50), (8, 300, 20), (64, 100, 401)]:
            wp = -(-P // 16)
            W = (L - 1) // 16 + wp + 2
            ref = words(u32(rng, (R, W)))
            val = words(_valid_mask(P, wp))
            for name, planes in (("match_swar", 1), ("match_swar_best", 1),
                                 ("match_swar_masks", 4)):
                pat = words(u32(rng, (R, planes * wp)))
                for p in (pat, pat[:1].expand(R, -1)):
                    got = wrappers[name](ref, p, val, n_locs=L,
                                         pattern_chars=P)
                    want = plains[name](ref, p, val, n_locs=L,
                                        pattern_chars=P)
                    check(same(got, want), f"{name} R={R} P={P} L={L}")
        # match_swar_best: a read planted at two alignments of row 0 (the
        # first wins) and an all-zero padding row (every alignment ties).
        R, P, L = 16, READ, 401
        wp = -(-P // 16)
        W = (L - 1) // 16 + wp + 2
        codes = rng.integers(0, 4, (R, 16 * W), np.uint8)
        pcodes = np.zeros(16 * wp, np.uint8)
        pcodes[:P] = rng.integers(0, 4, P)
        for loc in (17, 130):
            codes[0, loc:loc + P] = pcodes[:P]
        codes[:, -16:] = 0
        codes[-1] = 0

        def pack(c):
            lanes = c.reshape(c.shape[0], -1, 16).astype(np.uint32)
            return (lanes << (2 * np.arange(16, dtype=np.uint32))).sum(
                -1, dtype=np.uint32)
        ref, val = words(pack(codes)), words(_valid_mask(P, wp))
        pat = words(pack(pcodes[None])).expand(R, -1)
        got = ksw.match_swar_best(ref, pat, val, n_locs=L, pattern_chars=P)
        check(same(got, ksw.match_swar_best_plain(ref, pat, val, n_locs=L,
                                                   pattern_chars=P))
              and (int(got[0][0]), int(got[1][0])) == (17, P)
              and int(got[0][-1]) == 0,
              "match_swar_best planted tie and zero row")
        for R, P, Q in [(3, 20, 5), (2, 40, 1), (5, 100, 128), (2, 33, 256),
                        (8, 100, 130)]:
            p_chars = -(-P // kmx.CHARS_PER_CHUNK) * kmx.CHARS_PER_CHUNK
            l_pad = 2 * kmx.L_TILE
            f_chars = l_pad + p_chars
            flat = one_hot_flat(torch.from_numpy(rng.integers(
                0, 4, (R, f_chars), np.uint8)).to(dev), 4 * f_chars)
            q_pad = -(-Q // 128) * 128
            pat = torch.zeros((p_chars * 4, q_pad), dtype=torch.bfloat16,
                              device=dev)
            pat[:P * 4, :Q] = torch.from_numpy(
                rng.integers(0, 2, (P * 4, Q))).to(dev, torch.bfloat16)
            got = kmx.match_mxu(flat, pat, l_pad=l_pad)
            want = kmx.match_mxu_plain(flat, pat, l_pad=l_pad)
            check(torch.equal(torch.round(got).to(torch.int32),
                              torch.round(want).to(torch.int32)),
                  f"match_mxu R={R} P={P} Q={Q}")
        # match_mxu_best: n_locs off the 64 grid, an odd char count (rows
        # alternately 16- and 8-byte aligned), Q = 1 in a 128 pad, P4 =
        # 1,024 (the halved pattern tile), Q = 256.
        for R, P, Q, n_locs, extra in [(3, 20, 5, 201, 0),
                                       (4, 40, 128, 150, 1),
                                       (2, 33, 1, 77, 0),
                                       (2, 256, 130, 300, 0),
                                       (9, 100, 130, 401, 1)]:
            p_chars = -(-P // kmx.CHARS_PER_CHUNK) * kmx.CHARS_PER_CHUNK
            f_chars = kmx.best_l_pad(n_locs) + p_chars + extra
            flat = one_hot_flat(torch.from_numpy(rng.integers(
                0, 4, (R, f_chars), np.uint8)).to(dev), 4 * f_chars)
            q_pad = -(-Q // 128) * 128
            pat = torch.zeros((p_chars * 4, q_pad), dtype=torch.bfloat16,
                              device=dev)
            pat[:P * 4, :Q] = torch.from_numpy(
                rng.integers(0, 2, (P * 4, Q))).to(dev, torch.bfloat16)
            got = kmx.match_mxu_best(flat, pat, n_locs=n_locs, n_k=4 * P)
            want = kmx.match_mxu_best_plain(flat, pat, n_locs=n_locs,
                                            n_k=4 * P)
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"match_mxu_best R={R} P={P} Q={Q} n_locs={n_locs} "
                  f"F4={4 * f_chars}")
        # filter_qgram: dense rows (few absent bits) beside random ones.
        for wb in (1, 8, 16):
            sigs = u32(rng, (128, wb))
            sigs[64:] |= u32(rng, (64, wb)) | u32(rng, (64, wb))
            ts, tq = words(sigs), words(u32(rng, (1, wb)))
            for slack in (-1, 0, 3, wb * 32):
                check(torch.equal(
                    kfq.filter_qgram(ts, tq, slack=slack),
                    kfq.filter_qgram_plain(ts, tq, slack=slack)),
                    f"filter_qgram Wb={wb} slack={slack}")
        # bank_prefilter: D of one doc, a few, and three shared-memory
        # tiles; -1 pad rows; an all-zero doc; Wb beyond the register path.
        for wb, D in ((8, 1), (8, 8), (8, 700), (40, 50)):
            ps = words(u32(rng, (256, wb)) & u32(rng, (256, wb)))
            docs = u32(rng, (D, wb)) | u32(rng, (D, wb))
            if D > 1:
                docs[D // 2] = 0
            sl = rng.integers(-1, 30, (256, 1)).astype(np.int32)
            sl[-64:] = -1
            ds, tsl = words(docs), torch.from_numpy(sl).to(dev)
            got = kfq.bank_prefilter(ps, ds, tsl)
            check(torch.equal(got, kfq.bank_prefilter_plain(ps, ds, tsl))
                  and int(got[-64:].sum()) == 0,
                  f"bank_prefilter Wb={wb} D={D}")
        for w in (1, 33):
            x = words(u32(rng, (512, w)))
            check(torch.equal(kpc.popcount(x), kpc.popcount_plain(x)),
                  f"popcount W={w}")
        # popcount_rows: a ragged last tile with 1-3 words past its last 16
        # bytes, G > 1 threads a row (W = 257, 1024), chunked rows (W =
        # 2500), and one row.
        for n, w in ((1, 1), (5, 3), (129, 33), (4099, 33), (127, 257),
                     (9, 1024), (5, 2500)):
            x = words(u32(rng, (n, w)))
            check(torch.equal(kpc.popcount_rows(x), kpc.popcount_plain(x)),
                  f"popcount_rows N={n} W={w}")
        a, b = words(u32(rng, (256, 37))), words(u32(rng, (256, 37)))
        for op in kbw.OPS:
            for x, y in ((a, b), (a.view(-1)[1:1 + 256 * 36].view(256, 36),
                                  b.view(-1)[:256 * 36].view(256, 36))):
                check(torch.equal(kbw.bitwise(op, x, y),
                                  kbw.bitwise_plain(op, x, y)),
                      f"bitwise {op}")
        torch.cuda.synchronize()
        print("  all edge shapes bit-identical")

    # -- 4. main path at chr1 scale ----------------------------------------
    def drive(engine, q, reps=TIMED_RUNS):
        cm = engine.compile(q)
        cm.run()                                  # warm-up
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            res = cm.run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return res, times

    with Phase("phase 4: main path, chr1-sized reference"):
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        ref = encoding.random_dna(rng, CHR1_BP)
        corpus = PackedCorpus.from_reference(ref, FRAG, READ, device="cuda")
        engine = MatchEngine(corpus)
        n_rows = corpus.n_rows
        step = FRAG - READ + 1
        print(f"  reference {CHR1_BP} bp -> {n_rows} rows x {FRAG} chars "
              f"(set-up {time.perf_counter() - t0:.1f} s)")

        # Reads at known (row, loc): distinct rows, every read wholly
        # inside its row (loc <= FRAG - READ), so it occurs in that row
        # only.
        rows = rng.choice(n_rows - 1, N_BATCH + 2, replace=False)
        locs = rng.integers(0, FRAG - READ + 1, N_BATCH + 2)

        def read_at(i):
            pos = int(rows[i]) * step + int(locs[i])
            return ref[pos:pos + READ].copy()

        read_a = read_at(0)
        read_b = read_at(1)
        iupac = list(encoding.decode_dna(read_b))
        for i in rng.choice(READ, 16, replace=False)[:10]:
            iupac[i] = "N"
        for i in range(0, READ, 17):
            if iupac[i] in "AG":
                iupac[i] = "R"
            elif iupac[i] in "CT":
                iupac[i] = "Y"
        iupac = "".join(iupac)
        reads_c = np.stack([read_at(2 + q) for q in range(N_BATCH)])
        n_mism = np.arange(N_BATCH) % 4
        queries_c = reads_c.copy()
        for q in range(N_BATCH):
            for i in rng.choice(READ, n_mism[q], replace=False):
                queries_c[q, i] = (queries_c[q, i] + 1) % 4

        qa = MatchQuery.exact(read_a, reduction="best", backend="swar")
        qb = MatchQuery.iupac(iupac, reduction="threshold", threshold=95,
                              backend="swar")
        qc = MatchQuery.exact(queries_c, mode="batched", reduction="topk",
                              k=10, backend="mxu")
        qd = MatchQuery.exact(read_a, reduction="best")
        qe = MatchQuery.exact(read_a, reduction="threshold", threshold=99,
                              filter=True)
        qf = dataclasses.replace(qe, filter=None)
        qe_scan = dataclasses.replace(qe, filter=False)
        # (c'): a row subset that holds (c)'s planted rows.
        planted_c = rows[2:2 + N_BATCH]
        others = rng.choice(n_rows, 2 * SUBSET_C2, replace=False)
        others = others[~np.isin(others, planted_c)][:SUBSET_C2 - N_BATCH]
        rows_c2 = np.sort(np.concatenate([planted_c, others]))
        qc2 = MatchQuery.exact(queries_c, mode="batched",
                               reduction="threshold", threshold=THRESHOLD_C2,
                               backend="mxu", rows=rows_c2, filter=False)
        runs = TIMED_RUNS + 1                     # warm-up + timed runs

        torch.cuda.reset_peak_memory_stats()
        results, timings, per_query = {}, {}, {}
        for key, q in (("a", qa), ("b", qb), ("c", qc), ("d", qd)):
            zero_counts()
            results[key], timings[key] = drive(engine, q)
            per_query[key] = read_counts()
        launches = {n: sum(c[n] for c in per_query.values())
                    for n in wrappers}
        peak_mem = torch.cuda.max_memory_allocated()
        print(f"  launches on the (a)-(d) path: {launches}")

        ra, rb, rc, rd = (results[k] for k in "abcd")
        check(int(ra.best_scores[rows[0]]) == READ
              and int(ra.best_locs[rows[0]]) == int(locs[0]),
              "(a) planted read scores 100 at its loc")
        check(int(np.count_nonzero(ra.best_scores == READ)) == 1,
              "(a) planted row is the only exact hit")
        hits_b = {tuple(h) for h in rb.hits.tolist()}
        check((int(rows[1]), int(locs[1]), READ) in hits_b,
              "(b) planted IUPAC hit reported")
        check(rb.plan.predicate == "accept", "(b) ran the accept predicate")
        print(f"  (b) strategy {rb.plan.strategy}: {rb.plan.reason}")
        check(np.array_equal(rc.topk_rows[0], rows[2:2 + N_BATCH])
              and np.array_equal(rc.topk_scores[0], READ - n_mism),
              "(c) every query's top row is its planted row")
        check(per_query["c"]["match_mxu_best"] == runs * rc.n_chunks
              and per_query["c"]["match_mxu"] == 0,
              "(c) launches match_mxu_best once per chunk, match_mxu never")
        print(f"  (d) planner chose {rd.plan.backend}: {rd.plan.reason}")
        check(rd.plan.backend == "swar", "(d) planner chose SWAR")
        check(np.array_equal(rd.best_scores, ra.best_scores)
              and np.array_equal(rd.best_locs, ra.best_locs),
              "(d) agrees with (a)")
        for key, res in (("a", ra), ("d", rd)):
            check(per_query[key]["match_swar_best"] == runs * res.n_chunks
                  and per_query[key]["match_swar"] == 0,
                  f"({key}) launches match_swar_best once per chunk, "
                  "match_swar never")
        for name in ("match_swar_best", "match_swar_masks",
                     "match_mxu_best"):
            check(launches[name] > 0, f"{name} launched on the main path")

        # (c'): the full-block kernel and the threshold reduction.
        zero_counts()
        results["c2"], timings["c2"] = drive(engine, qc2)
        launches_c2 = read_counts()
        rc2 = results["c2"]
        print(f"  launches on the (c') path: {launches_c2}")
        check(launches_c2["match_mxu"] == runs * rc2.n_chunks
              and launches_c2["match_mxu_best"] == 0,
              "(c') launches match_mxu once per chunk")
        hits_c2 = {tuple(h) for h in rc2.hits.tolist()}
        missing = [q for q in range(N_BATCH)
                   if (int(rows[2 + q]), int(locs[2 + q]), q,
                       READ - int(n_mism[q])) not in hits_c2]
        check(not missing, f"(c') every planted hit reported "
              f"(missing reads {missing})")
        print(f"  (c') {rc2.hits.shape[0]} hits at >= {THRESHOLD_C2} over "
              f"{len(rows_c2)} rows, all {N_BATCH} planted hits among them")

        # (e), (f): filter-then-verify through the q-gram index.
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.index.signatures()
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t
        print(f"  q-gram index built on the card in {index_s:.3f} s "
              f"({engine.index.stats()})")
        zero_counts()
        for key, q in (("e", qe), ("f", qf)):
            results[key], timings[key] = drive(engine, q)
        launches_ef = read_counts()
        print(f"  launches on the (e)-(f) path: {launches_ef}")
        results["e_scan"], timings["e_scan"] = drive(engine, qe_scan)
        re_, rf, rs = results["e"], results["f"], results["e_scan"]
        check(re_.plan.strategy == "filter", "(e) ran filter-then-verify")
        check(rs.plan.strategy == "scan", "(e) scanned with filter=False")
        check(np.array_equal(re_.hits, rs.hits)
              and np.array_equal(rf.hits, rs.hits),
              "(e), (f) hits equal the scan's")
        check((int(rows[0]), int(locs[0]), READ) in
              {tuple(h) for h in re_.hits.tolist()},
              "(e) planted hit reported")
        check(int(rows[0]) in set(re_.survivor_rows.tolist()),
              "(e) planted row survived the filter")
        check(engine.index.sig_pack_count == 1, "(e) one signature pack")
        check(launches_ef["filter_qgram"] > 0,
              "filter_qgram launched on the (e)-(f) path")
        check(launches_ef["match_swar"] > 0,
              "match_swar launched on the (e)-(f) path (verify)")
        print(f"  (e) survivors {len(re_.survivor_rows)} rows "
              f"({re_.survivor_frac:.6f} of {n_rows}), "
              f"{re_.hits.shape[0]} hits; (f) planner chose "
              f"{rf.plan.strategy}: {rf.plan.reason}")

        main_path = {}
        for key, q in (("a", qa), ("b", qb), ("c", qc), ("d", qd),
                       ("c2", qc2), ("e", qe), ("f", qf),
                       ("e_scan", qe_scan)):
            res, ts = results[key], timings[key]
            best = min(ts)
            scanned = len(rows_c2) if key == "c2" else n_rows
            main_path[key] = {
                "backend": res.plan.backend, "predicate": res.plan.predicate,
                "strategy": res.plan.strategy,
                "reduction": q.reduction, "n_patterns": res.plan.n_patterns,
                "chunk_rows": res.plan.chunk_rows, "n_chunks": res.n_chunks,
                "survivor_frac": res.survivor_frac,
                "ms": [t * 1e3 for t in ts], "best_ms": best * 1e3,
                "rows": scanned, "rows_per_s": scanned / best,
                "row_patterns_per_s": scanned * res.plan.n_patterns / best}
            print(f"  ({key}) {res.plan.backend}/{res.plan.predicate} "
                  f"{q.reduction} {res.plan.strategy}: runs "
                  f"{[round(t * 1e3, 3) for t in ts]} ms, "
                  f"{scanned / best:.4g} rows/s, "
                  f"{res.n_chunks} chunks of {res.plan.chunk_rows}")
        main_path["index_build_s"] = index_s
        print(f"  peak device memory over (a)-(d) {peak_mem / 2**30:.3f} GiB")

        # (a) and (b) against the ref backend on the full corpus (the same
        # strategy as the kernel run, so the best arrays cover the same
        # rows).
        for key, q in (("a", qa), ("b", qb)):
            res = results[key]
            qr = dataclasses.replace(
                q, backend="ref", filter=(res.plan.strategy == "filter"))
            t = time.perf_counter()
            rr = engine.compile(qr).run()
            torch.cuda.synchronize()
            main_path[key]["ref_ms"] = (time.perf_counter() - t) * 1e3
            check(np.array_equal(rr.best_locs, res.best_locs)
                  and np.array_equal(rr.best_scores, res.best_scores),
                  f"({key}) best arrays equal the ref backend's")
            if q.reduction == "threshold":
                check(np.array_equal(rr.hits, res.hits),
                      f"({key}) hits equal the ref backend's")
        print(f"  (a), (b) identical to the ref backend on all {n_rows} "
              "rows")
        print("main_path " + json.dumps(main_path))

    # -- 4b. standing bank ----------------------------------------------------
    with Phase("phase 4b: standing bank, 4,096 patterns x 256-doc batches"):
        t0 = time.perf_counter()
        brng = np.random.default_rng(SEED + 1)
        starts = rng.integers(0, CHR1_BP - READ, BANK_PATTERNS)
        bank_pats = np.stack([ref[s:s + READ] for s in starts])
        thresholds = np.where(np.arange(BANK_PATTERNS) % 4 == 3, READ - 1,
                              READ)
        bank = PatternBank(FRAG, READ)
        pids = np.array([bank.register(p, threshold=float(t))
                         for p, t in zip(bank_pats, thresholds)])
        batches, planted = [], []
        for _ in range(BANK_BATCHES):
            docs = brng.integers(0, 4, (BANK_DOCS, FRAG), np.uint8)
            d_sel = brng.choice(BANK_DOCS, BANK_PLANTED, replace=False)
            p_sel = brng.choice(BANK_PATTERNS, BANK_PLANTED, replace=False)
            l_sel = brng.integers(0, FRAG - READ + 1, BANK_PLANTED)
            for d, p, lo in zip(d_sel, p_sel, l_sel):
                docs[d, lo:lo + READ] = bank_pats[p]
            batches.append(docs)
            planted.append({(int(d), int(lo), int(pids[p]), READ)
                            for d, p, lo in zip(d_sel, p_sel, l_sel)})
        print(f"  {bank.n_live} patterns registered, "
              f"{BANK_BATCHES} batches made "
              f"(set-up {time.perf_counter() - t0:.1f} s)")
        for docs in batches[:1]:                  # warm-up, both modes
            for mode in (True, False):
                bank.filter = mode
                bank.scan(docs)
        torch.cuda.synchronize()
        n0_scans, n0_bank = bank.n_scans, bank.n_bank_launches
        zero_counts()
        tickets = {True: [], False: []}
        bank_ms = {True: [], False: []}
        verify_peak = 0
        for docs in batches:
            for mode in (True, False):
                bank.filter = mode
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t = time.perf_counter()
                tk = bank.scan(docs)
                torch.cuda.synchronize()
                bank_ms[mode].append((time.perf_counter() - t) * 1e3)
                if not mode:
                    verify_peak = max(verify_peak,
                                      torch.cuda.max_memory_allocated()
                                      - base)
                tickets[mode].append(tk)
        launches_bank = read_counts()
        n_scans = bank.n_scans - n0_scans
        print(f"  launches on the bank path: {launches_bank}")
        check(bank.n_bank_launches - n0_bank == n_scans
              == 2 * BANK_BATCHES, "one verify launch per scan")
        check(launches_bank["bank_prefilter"] == BANK_BATCHES,
              "bank_prefilter launched once per filtered scan")
        check(launches_bank["match_swar_masks"] == n_scans,
              "one match_swar_masks launch per scan")
        for i, docs in enumerate(batches):
            tf, ts = tickets[True][i], tickets[False][i]
            check(np.array_equal(tf.hits, ts.hits),
                  f"bank batch {i}: filtered hits equal the full scan's")
            check(planted[i] <= {tuple(h) for h in tf.hits.tolist()},
                  f"bank batch {i}: every planted hit found")
        # Per pattern, the bank's hits equal an ad-hoc threshold query
        # over the batch (index-free engine), on a sample that includes
        # planted patterns.
        docs, tk = batches[0], tickets[True][0]
        adhoc = MatchEngine(docs, index=False)
        sample = sorted({h[2] for h in planted[0]})[:BANK_SAMPLE // 2]
        sample += [int(p) for p in brng.choice(pids, BANK_SAMPLE // 2,
                                                replace=False)]
        for pid in sample:
            want = adhoc.match(bank.pattern(pid).query).hits
            mine = tk.hits[tk.hits[:, 2] == pid][:, [0, 1, 3]]
            check(np.array_equal(mine, want),
                  f"bank pattern {pid} equals its ad-hoc query")
        surv = [t.survivor_frac for t in tickets[True]]
        bank_info = {
            "n_patterns": bank.n_live, "n_docs": BANK_DOCS,
            "filter_ms": bank_ms[True], "scan_ms": bank_ms[False],
            "survivor_frac": surv,
            "n_hits": [int(t.hits.shape[0]) for t in tickets[True]],
            "verify_peak_bytes": verify_peak,
            "plan": tickets[True][0].plan.reason}
        print(f"  filtered scans {[round(m, 3) for m in bank_ms[True]]} ms, "
              f"full scans {[round(m, 3) for m in bank_ms[False]]} ms; "
              f"survivor fractions {[round(f, 4) for f in surv]}; "
              f"verify peak {verify_peak / 2**30:.3f} GiB above the "
              f"resident forms; {len(sample)} sampled patterns equal "
              "their ad-hoc queries")
        print("bank " + json.dumps(bank_info))

    # -- 4c. bulk ops ---------------------------------------------------------
    with Phase("phase 4c: bulk popcount and XOR"):
        swar = corpus.swar_words(1)
        n_xor = XOR_BYTES // 4 // 256
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        xa, xb = (torch.randint(-2**31, 2**31, (n_xor, 256),
                                dtype=torch.int32, device=dev,
                                generator=gen) for _ in range(2))
        zero_counts()
        pc = ops.popcount(swar)
        xo = ops.bitwise("XOR", xa, xb)
        torch.cuda.synchronize()
        launches_bulk = read_counts()
        print(f"  launches on the bulk path: {launches_bulk}")
        want_pc = popcount_words(as_u32(swar)).sum(-1).to(torch.int32)
        check(torch.equal(pc, want_pc), "ops.popcount equals its plain "
              f"version over the SWAR form {tuple(swar.shape)}")
        check(torch.equal(xo, torch.bitwise_xor(xa, xb)),
              f"ops.bitwise XOR equals torch.bitwise_xor on {n_xor} x 256")
        check(launches_bulk["popcount"] == 1
              and launches_bulk["bitwise"] == 1, "bulk kernels launched")
        print(f"  popcount of {tuple(swar.shape)} words: "
              f"{int(pc.sum())} bits set; XOR of two {XOR_BYTES >> 20} MiB "
              "operands bit-identical")
        # ops.popcount end to end: host clock around a call that ends in a
        # synchronize, the least of 20 after a warm-up.
        for _ in range(3):
            ops.popcount(swar)
        torch.cuda.synchronize()
        pc_host = []
        for _ in range(20):
            t0 = time.perf_counter()
            ops.popcount(swar)
            torch.cuda.synchronize()
            pc_host.append((time.perf_counter() - t0) * 1e3)
        print(f"  ops.popcount host clock over {tuple(swar.shape)}: min "
              f"{min(pc_host):.4f} ms, median "
              f"{sorted(pc_host)[len(pc_host) // 2]:.4f} ms (20 calls)")

    # -- 5. kernels at their paths' shapes ----------------------------------
    with Phase("phase 5: kernels at their paths' shapes"):
        kernels = []
        l2 = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

        def flush():
            l2.zero_()
        # The SWAR kernels at their paths' launches: match_swar_best at
        # (a)'s (one chunk of rows against the read, broadcast), STORE
        # match_swar at (e)'s verify (the operands of that launch, taken
        # from one run: the gathered survivor rows and the read broadcast
        # to them; also timed at (a)'s chunk, the shape earlier builds
        # were timed at), match_swar_masks at (b)'s.  Each is held
        # against its plain version on max(chunk, SUBSET_ROWS) rows of
        # (a)'s or (b)'s operands, STORE also on the verify's.  Bytes:
        # the rows read once, and the (R, L) block or BEST's (R,) pairs
        # written.
        verify_ops = []
        swar_operands = engine._swar_operands

        def spy(*a, **kw):
            verify_ops.append(swar_operands(*a, **kw))
            return verify_ops[-1]
        engine._swar_operands = spy
        try:
            zero_counts()
            cm = engine.compile(qe)
            cm.run()
            plan_e = cm.plan
            check(len(verify_ops) == ksw.match_swar.n_launches > 0,
                  "(e) verifies through match_swar")
        finally:
            del engine._swar_operands
        for name, key in (("match_swar_best", "a"), ("match_swar", "a"),
                          ("match_swar_masks", "b")):
            cm = engine.compile(qa if key == "a" else qb)
            plan = cm.plan
            base = corpus.swar_words(plan.need_words)
            pat_rows, val = cm._packed
            kern, plain = wrappers[name], plains[name]

            def args(r):
                return (base[:r], pat_rows[:1].expand(r, -1), val)
            kw = dict(n_locs=plan.n_locs, pattern_chars=plan.pattern_chars)
            n_cmp = max(plan.chunk_rows, SUBSET_ROWS)
            cmp_sets = [args(n_cmp)]
            if name == "match_swar":
                check((plan_e.n_locs, plan_e.pattern_chars, plan_e.wp)
                      == (plan.n_locs, plan.pattern_chars, plan.wp),
                      "(e)'s verify launch has (a)'s geometry")
                cmp_sets.append(verify_ops[0])
            err = 0
            for ops_ in cmp_sets:
                got = kern(*ops_, **kw)
                want = plain(*ops_, **kw)
                err = max([err] + [int((x - y).abs().max()) for x, y in (
                    zip(got, want) if isinstance(got, tuple)
                    else [(got, want)])])
                del got, want
            check(err == 0, f"{name} equals its plain version on "
                  + " and ".join(str(o[0].shape[0]) for o in cmp_sets)
                  + " rows")
            a = cmp_sets[-1] if name == "match_swar" else args(plan.chunk_rows)
            R = a[0].shape[0]             # the path's launch shape
            ms = device_ms(lambda: kern(*a, **kw), 20, flush)
            event_ms = cuda_ms(lambda: kern(*a, **kw), 20)
            plain_ms = cuda_ms(lambda: plain(*a, **kw), 2)
            extra = {}
            if name == "match_swar":
                a_chunk = args(plan.chunk_rows)
                extra["ms_a_chunk"] = device_ms(
                    lambda: kern(*a_chunk, **kw), 20, flush)
            W = a[0].shape[1]
            n_planes = pat_rows.shape[1]
            n_words = R * plan.n_locs * plan.wp
            out_bytes = R * 8 if name == "match_swar_best" \
                else R * plan.n_locs * 4
            nbytes = R * W * 4 + n_planes * 4 + plan.wp * 4 + out_bytes
            t_word = max(n_words * SWAR_INT_OPS_PER_WORD[name] / PEAK_INT32,
                         n_words / PEAK_POPC)
            if name in EXACT_INT_OPS:
                int_ops, n_popc = exact_swar_ops(name, R, plan.n_locs,
                                                 plan.wp)
                t_ops = max(int_ops / PEAK_INT32, n_popc / PEAK_POPC)
                extra["bound_ms_first_build"] = max(
                    t_word, nbytes / HBM_BW) * 1e3
            else:
                t_ops = t_word
            t_bytes = nbytes / HBM_BW
            kernels.append(dict(
                name=name, rows=R, ms=ms, event_ms=event_ms,
                plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, max_abs_err=err, **extra))

        cm = engine.compile(qc)
        plan = cm.plan
        base = corpus.onehot_flat(plan.f_chars)
        pat = cm._packed
        R = plan.chunk_rows
        Qn = plan.n_patterns
        bkw = dict(n_locs=plan.n_locs, n_k=4 * plan.pattern_chars)
        err = err_best = 0
        for r0 in range(0, SUBSET_ROWS, R):
            rows_ = base[r0:min(r0 + R, SUBSET_ROWS)]
            got = torch.round(kmx.match_mxu(rows_, pat, l_pad=plan.l_pad))
            want = torch.round(kmx.match_mxu_plain(rows_, pat,
                                                   l_pad=plan.l_pad))
            err = max(err, int((got - want).abs().max()))
            for x, y in zip(kmx.match_mxu_best(rows_, pat, **bkw),
                            kmx.match_mxu_best_plain(rows_, pat, **bkw)):
                err_best = max(err_best, int((x - y).abs().max()))
        check(err == 0, f"match_mxu equals its plain version on "
              f"{SUBSET_ROWS} rows")
        check(err_best == 0, f"match_mxu_best equals its plain version on "
              f"{SUBSET_ROWS} rows")
        # Every corpus row: the fused best against the full block +
        # argmax/amax (the engine's epilogue before the fusion), and (c)'s
        # top-10 against the top-10 of those best scores under (score
        # desc, row asc).
        n_pad = corpus.n_rows_padded
        store_bs = torch.empty((n_pad, Qn), dtype=torch.int32, device=dev)
        n_diff = 0
        for r0 in range(0, n_pad, R):
            rows_ = base[r0:min(r0 + R, n_pad)]
            sc = torch.round(kmx.match_mxu(rows_, pat, l_pad=plan.l_pad)[
                :, :plan.n_locs, :Qn]).to(torch.int32)
            fl, fs = kmx.match_mxu_best(rows_, pat, **bkw)
            n_diff += int((fl[:, :Qn] != sc.argmax(1)).sum()
                          + (fs[:, :Qn] != sc.amax(1)).sum())
            store_bs[r0:r0 + rows_.shape[0]] = sc.amax(1)
        check(n_diff == 0, "match_mxu_best equals match_mxu + argmax/amax "
              f"on all {n_pad} rows")
        ids = torch.arange(n_rows, dtype=torch.int64, device=dev)[:, None]
        key = torch.sort((-store_bs[:n_rows].to(torch.int64) << 32) | ids,
                         dim=0).values[:rc.topk_rows.shape[0]]
        check(np.array_equal(rc.topk_rows, (key & 0xFFFFFFFF).cpu().numpy())
              and np.array_equal(rc.topk_scores,
                                 (-(key >> 32)).cpu().numpy()),
              "(c)'s top-10 equals the full-block kernel's")
        print(f"  match_mxu_best equals match_mxu + argmax/amax on all "
              f"{n_pad} rows; (c)'s top-10 rows and scores equal theirs")

        chunk = base[:R]
        # Library yardstick (never used by the port): cuDNN conv1d of the
        # one-hot rows against the patterns, TF32 off.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        f_chars = chunk.shape[1] // 4
        x = chunk.view(R, f_chars, 4).permute(0, 2, 1).contiguous()
        w = pat.view(plan.p_chars_pad, 4, plan.q_pad).permute(2, 1, 0
                                                              ).contiguous()
        conv = torch.nn.functional.conv1d(x, w)
        out = kmx.match_mxu(chunk, pat, l_pad=plan.l_pad)
        check(torch.equal(
            torch.round(conv[:, :, :plan.l_pad].float()).permute(0, 2, 1),
            torch.round(out)), "conv1d yardstick agrees with match_mxu")
        del conv, out
        times, turns = device_ms_turns(
            {"kernel": lambda: kmx.match_mxu(chunk, pat, l_pad=plan.l_pad),
             "library": lambda: torch.nn.functional.conv1d(x, w)}, 10, flush)
        event_ms = cuda_ms(lambda: kmx.match_mxu(chunk, pat,
                                                 l_pad=plan.l_pad), 10)
        plain_ms = cuda_ms(
            lambda: kmx.match_mxu_plain(chunk, pat, l_pad=plan.l_pad), 2)
        F4, P4, Q = chunk.shape[1], pat.shape[0], pat.shape[1]
        flops = R * plan.l_pad * P4 * 2 * Q
        nbytes = R * F4 * 2 + P4 * Q * 2 + R * plan.l_pad * Q * 4
        bms, bby = bound(nbytes, flops, PEAK_BF16)
        kernels.append(dict(
            name="match_mxu", rows=R, ms=times["kernel"], event_ms=event_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
            library_ms=times["library"], max_abs_err=err, turns=turns))

        # match_mxu_best at (c)'s launch.  No one PyTorch call computes the
        # best alignment; the bound counts the unpadded work (n_locs
        # alignments, 4P rows, the query's patterns).
        ms = device_ms(lambda: kmx.match_mxu_best(chunk, pat, **bkw), 20,
                       flush)
        event_ms = cuda_ms(lambda: kmx.match_mxu_best(chunk, pat, **bkw), 20)
        plain_ms = cuda_ms(
            lambda: kmx.match_mxu_best_plain(chunk, pat, **bkw), 2)
        flops = R * plan.n_locs * bkw["n_k"] * 2 * Qn
        nbytes = R * F4 * 2 + P4 * Q * 2 + 2 * R * Q * 4
        bms, bby = bound(nbytes, flops, PEAK_BF16)
        kernels.append(dict(
            name="match_mxu_best", rows=R, ms=ms, event_ms=event_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None,
            max_abs_err=err_best))

        # filter_qgram at (e)'s launch: every live row's signature.
        cm = engine.compile(qe)
        sigs = engine.index.signatures()
        tile = kfq.FILTER_ROW_TILE
        rows_f = sigs[:-(-n_rows // tile) * tile]
        qsig, slack = cm._filter_dev[0:1], cm._filter_ops.slacks[0]
        got = kfq.filter_qgram(rows_f, qsig, slack=slack)
        want = kfq.filter_qgram_plain(rows_f, qsig, slack=slack)
        err = int((got - want).abs().max())
        check(err == 0, f"filter_qgram equals its plain version on "
              f"{rows_f.shape[0]} rows")
        ms = device_ms(lambda: kfq.filter_qgram(rows_f, qsig, slack=slack),
                       50, flush)
        event_ms = cuda_ms(lambda: kfq.filter_qgram(rows_f, qsig,
                                                    slack=slack), 50)
        plain_ms = cuda_ms(lambda: kfq.filter_qgram_plain(rows_f, qsig,
                                                          slack=slack), 3)
        Rf, Wb = rows_f.shape
        # Per word: one and-not (INT32 issue) and one popcount.
        t_ops = max(Rf * Wb / PEAK_POPC, 2 * Rf * Wb / PEAK_INT32)
        nbytes = Rf * Wb * 4 + Wb * 4 + Rf * 4
        kernels.append(dict(
            name="filter_qgram", rows=Rf, ms=ms, event_ms=event_ms,
            plain_ms=plain_ms,
            bound_ms=max(t_ops, nbytes / HBM_BW) * 1e3,
            bound_by="operations" if t_ops >= nbytes / HBM_BW else "bytes",
            library_ms=None, max_abs_err=err))

        # bank_prefilter at the bank's launch: all pattern slots against
        # one batch's doc signatures.  Its work depends on the data: a
        # pattern stops at its first admitting doc, and slack -1 rows test
        # none, so the bound counts the (pattern, doc) tests this batch
        # needs.
        psigs, pslacks = bank.filter_operands()
        dsigs, _ = signature_words(
            torch.from_numpy(batches[0]).to(dev), bank.q, bank.n_bits)
        got = kfq.bank_prefilter(psigs, dsigs, pslacks)
        want = kfq.bank_prefilter_plain(psigs, dsigs, pslacks)
        err = int((got - want).abs().max())
        check(err == 0, "bank_prefilter equals its plain version")
        ms = device_ms(lambda: kfq.bank_prefilter(psigs, dsigs, pslacks),
                       50, flush)
        event_ms = cuda_ms(lambda: kfq.bank_prefilter(psigs, dsigs,
                                                      pslacks), 50)
        plain_ms = cuda_ms(
            lambda: kfq.bank_prefilter_plain(psigs, dsigs, pslacks), 3)
        absent = popcount_words(as_u32(psigs)[:, None, :]
                                & ~as_u32(dsigs)[None]).sum(-1)
        fits = absent <= pslacks.to(torch.int64)
        D = dsigs.shape[0]
        tested = torch.where(fits.any(1), fits.int().argmax(1) + 1, D)
        tested = torch.where(pslacks[:, 0] < 0, 0, tested)
        n_tests = int(tested.sum())
        Qb, Wb = psigs.shape
        t_ops = max(n_tests * Wb / PEAK_POPC, 2 * n_tests * Wb / PEAK_INT32)
        nbytes = (Qb + D) * Wb * 4 + Qb * 8
        kernels.append(dict(
            name="bank_prefilter", rows=Qb, ms=ms, event_ms=event_ms,
            plain_ms=plain_ms,
            bound_ms=max(t_ops, nbytes / HBM_BW) * 1e3,
            bound_by="operations" if t_ops >= nbytes / HBM_BW else "bytes",
            library_ms=None, max_abs_err=err, pair_tests=n_tests))

        # popcount at the SWAR form padded to 256-row tiles (the launch
        # earlier builds were timed at), and at the bulk path's own launch
        # since the pad went: the form's rows as they are.
        pcin = swar if swar.shape[0] % kpc.N_TILE == 0 else torch.cat(
            [swar, swar.new_zeros((-swar.shape[0] % kpc.N_TILE,
                                   swar.shape[1]))])
        got = kpc.popcount(pcin)
        err = int((got - kpc.popcount_plain(pcin)).abs().max())
        got = kpc.popcount_rows(swar)
        err = max(err, int((got - kpc.popcount_plain(swar)).abs().max()))
        check(err == 0, "popcount equals its plain version, padded and not")
        ms = device_ms(lambda: kpc.popcount(pcin), 50, flush)
        ms_unpadded = device_ms(lambda: kpc.popcount_rows(swar), 50, flush)
        event_ms = cuda_ms(lambda: kpc.popcount(pcin), 50)
        plain_ms = cuda_ms(lambda: kpc.popcount_plain(pcin), 3)
        Np, Wp_ = pcin.shape
        bms, bby = bound(Np * Wp_ * 4 + Np * 4, Np * Wp_, PEAK_POPC)
        Nu = swar.shape[0]
        bms_u, _ = bound(Nu * Wp_ * 4 + Nu * 4, Nu * Wp_, PEAK_POPC)
        kernels.append(dict(
            name="popcount", rows=Np, ms=ms, event_ms=event_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None,
            max_abs_err=err, ms_unpadded=ms_unpadded,
            bound_ms_unpadded=bms_u, rows_unpadded=Nu))

        # bitwise at the bulk path's launch: XOR of the 256 MiB pair.
        got = kbw.bitwise("XOR", xa, xb)
        err = int((got != kbw.bitwise_plain("XOR", xa, xb)).sum())
        check(err == 0, "bitwise equals its plain version")
        times, turns = device_ms_turns(
            {"kernel": lambda: kbw.bitwise("XOR", xa, xb),
             "library": lambda: torch.bitwise_xor(xa, xb)}, 20, flush)
        event_ms = cuda_ms(lambda: kbw.bitwise("XOR", xa, xb), 20)
        plain_ms = cuda_ms(lambda: kbw.bitwise_plain("XOR", xa, xb), 20)
        bms, bby = bound(3 * xa.numel() * 4, xa.numel(), PEAK_INT32)
        kernels.append(dict(
            name="bitwise", rows=xa.shape[0], ms=times["kernel"],
            event_ms=event_ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=bby, library_ms=times["library"],
            max_abs_err=err, turns=turns))
        for k in kernels:
            print(f"  {k['name']}: {k['rows']} rows, kernel {k['ms']:.4f} ms "
                  f"on the device ({k['event_ms']:.4f} ms per call by "
                  f"events), plain {k['plain_ms']:.4f} ms, bound "
                  f"{k['bound_ms']:.4f} ms ({k['bound_by']}), library "
                  f"{k['library_ms']}"
                  + (f", in turns {k['turns']}" if "turns" in k else "")
                  + "".join(f", {x} {k[x]:.4f}" for x in EXTRA_MS
                            if x in k)
                  + (f" at {k['rows_unpadded']} rows"
                     if "rows_unpadded" in k else ""))

    with Phase("phase 6: profile of one run of (a), (c) and (e)"):
        profile_runs(engine, {"a": qa, "c": qc, "e": qe})

    # -- 7. the service -------------------------------------------------------
    with Phase("phase 7: MatchService, coalesced ticks, cache, ingest into "
               "the window"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bank.filter = None                        # the planner's choice
        svc_best = [(queries_c[q], int(rows[2 + q]), int(locs[2 + q]),
                     READ - int(n_mism[q])) for q in range(SVC_BEST)]
        svc_thr = [(reads_c[q], int(rows[2 + q]), int(locs[2 + q]))
                   for q in range(SVC_BEST, SVC_BEST + SVC_THR)]
        service = service_phase(
            engine, bank, best=svc_best, thr=svc_thr,
            iupac=(iupac, int(rows[1]), int(locs[1])), batches=batches,
            bank_hits=[t.hits for t in tickets[False]],
            evicted_read=ref[:READ].copy(), n_compactions=1,
            zero_counts=zero_counts, read_counts=read_counts,
            sync=torch.cuda.synchronize)
        service["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(f"  peak device memory over the phase "
              f"{service['peak_bytes'] / 2**30:.3f} GiB; card: {smi}")
        print("service " + json.dumps(service))

    # -- 8. summary ---------------------------------------------------------
    # Each kernel's launches come from its own path's run.
    path_launches = dict(launches)
    path_launches["match_mxu"] = launches_c2["match_mxu"]
    path_launches["match_swar"] = launches_ef["match_swar"]
    path_launches["filter_qgram"] = launches_ef["filter_qgram"]
    path_launches["bank_prefilter"] = launches_bank["bank_prefilter"]
    path_launches["popcount"] = launches_bulk["popcount"]
    path_launches["bitwise"] = launches_bulk["bitwise"]
    rows_out = []
    for k in kernels:
        src, replaces = SOURCES[k["name"]]
        n = path_launches[k["name"]]
        check(n > 0, f"{k['name']} launched on its path")
        rows_out.append({
            "name": k["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "event_ms": k["event_ms"], "turns_ms": k.get("turns"),
            "shape_rows": k["rows"], "n_launches": n,
            "matches_plain": k["max_abs_err"] == 0,
            **{x: k[x] for x in EXTRA_MS + ("rows_unpadded",) if x in k}})
    check(len(rows_out) == len(SOURCES), "every kernel measured")
    print("kernels " + json.dumps([
        {"name": r["name"], "n_launches": r["n_launches"],
         "matches_plain": r["matches_plain"]} for r in rows_out]))
    print(json.dumps({"kernels": rows_out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
