"""Serving launcher of the port: string-match traffic through ``MatchService``.

``python -m repro_torch.launch.serve --workload match`` serves synthetic
string-match traffic: many small shared-mode queries through a
``MatchService`` over one resident corpus (micro-batched multi-tenant
execution), mixed with online ingestion (``--ingest-every``: the corpus
grows in place under load), and reports coalescing + cache + ingest stats
alongside QPS.

``--workload stream`` is the inverted regime: an open-loop
document-arrival generator drives ``MatchService.ingest`` against a
standing ``PatternBank`` -- mostly benign docs, a few with planted bank
hits -- over a sliding-window corpus, and reports per-tick bank-launch
counts, hit latency, and prefilter survivor fractions.

Both run on the card unless ``--device cpu`` is given, print the same
report lines as ``repro.launch.serve`` (the match workload's also counts
``failed=`` queries, and any makes the run fail), and return the
service's ``ServiceStats.snapshot()``.  ``--workload lm`` (the LM serving engine)
is refused: the port has no LM substrate yet.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np

from repro_torch.obs import Observability


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _build_obs(args) -> Observability:
    """Observability for the match/stream workloads.

    Spans turn on exactly when a ``--trace`` destination exists -- the
    disabled tracer is a no-op singleton, so an untraced run pays
    nothing -- while the metrics registry is always on (it only
    observes).  ``--profiler`` also feeds every span to
    ``torch.profiler.record_function``.
    """
    return Observability(spans=bool(args.trace),
                         profiler=bool(args.profiler))


def _export_trace(obs: Observability, path: str) -> None:
    """Write the collected span tree: Chrome/Perfetto JSON by default,
    JSON-lines when the path ends in ``.jsonl``."""
    if path.endswith(".jsonl"):
        obs.tracer.write_jsonl(path)
        n = obs.tracer.n_spans
        print(f"trace: wrote {n} spans to {path} (JSON-lines)")
    else:
        n = obs.tracer.write_chrome(path)
        print(f"trace: wrote {n} spans to {path} "
              f"(load in Perfetto / chrome://tracing)")


def _print_metrics(svc, tick_label: str) -> None:
    """One greppable per-interval metrics line (``--metrics-every``)."""
    s = svc.stats
    m = svc.obs.metrics
    print(f"metrics,{tick_label},"
          f"completed={s.n_completed},"
          f"p50_ms={s.latency_hist.quantile(0.50) * 1e3:.2f},"
          f"p95_ms={s.latency_hist.quantile(0.95) * 1e3:.2f},"
          f"p99_ms={s.latency_hist.quantile(0.99) * 1e3:.2f},"
          f"launches_last_tick={s.launches_last_tick},"
          f"queue_depth={int(m.gauge('service.queue_depth').value)},"
          f"plan_mispredict_rate={m.mispredict_rate():.3f}")


def run_match_service(args) -> Dict:
    """Synthetic multi-tenant match traffic through one MatchService.

    Requests are declarative ``MatchQuery`` objects; ``--predicate
    wildcard`` turns a few positions of every pattern into ``N`` wildcards
    (accept-everything masks), exercising the accept-set kernel path under
    the same coalescing machinery.  ``--ingest-every K`` mixes online
    ingestion into the stream: every Kth request also appends a fresh
    corpus row through ``service.ingest`` (batched per tick, in-place
    ``append_rows``).  ``--selective K`` makes every Kth request a
    planted-substring threshold lookup, the workload the q-gram filter
    index serves; filter routing stats print alongside QPS.  Returns the
    stats snapshot.
    """
    from repro_torch.match import MatchEngine, MatchQuery, MatchService

    rng = np.random.default_rng(0)
    frags = rng.integers(0, 4, (args.corpus_rows, args.fragment_chars),
                         np.uint8)
    obs = _build_obs(args)
    eng = MatchEngine(frags, obs=obs, device=args.device)
    svc = MatchService(eng)
    P = args.pattern_chars
    pats = rng.integers(0, 4, (args.requests, P), np.uint8)
    if args.predicate == "wildcard":
        masks = (np.uint8(1) << pats).astype(np.uint8)
        n_wild = max(1, P // 8)
        for q in range(args.requests):
            masks[q, rng.integers(0, P, n_wild)] = 0b1111
        queries = [MatchQuery.from_masks(m) for m in masks]
    else:
        queries = [MatchQuery.exact(p) for p in pats]
    if args.selective:
        # Every Kth request is a selective needle-in-haystack lookup: an
        # exact threshold query for a substring planted in the resident
        # corpus.  The planner routes each through filter-then-verify or
        # full scan on its own cost model; the filter stats below report
        # what actually happened.
        for i in range(0, args.requests, args.selective):
            row = int(rng.integers(0, args.corpus_rows))
            off = int(rng.integers(0, args.fragment_chars - P + 1))
            queries[i] = MatchQuery.exact(frags[row, off:off + P],
                                          reduction="threshold",
                                          threshold=P)
    # Warm the forms so the ingest counters below isolate growth behavior.
    eng.match(queries[0])
    rows_before = eng.corpus.n_rows
    t0 = time.perf_counter()
    tickets, ingests = [], []
    for i, q in enumerate(queries):
        if args.ingest_every and i % args.ingest_every == 0:
            ingests.append(svc.ingest(
                rng.integers(0, 4, args.fragment_chars, np.uint8)))
        tickets.append(svc.submit(q))
        if args.tick_every and (i + 1) % args.tick_every == 0:
            svc.tick()                 # mixed ingest+query ticks under load
            if (args.metrics_every
                    and svc.stats.n_ticks % args.metrics_every == 0):
                _print_metrics(svc, f"tick={svc.stats.n_ticks}")
    svc.flush()
    dt = time.perf_counter() - t0
    _require(all(t.done for t in tickets) and all(t.done for t in ingests),
             "every ticket completes")
    stats = svc.stats.snapshot()
    # Tenant isolation completes a failed group's tickets with ``error``
    # set; a kernel that fails to build or launch would land there too, so
    # a served run must have none.
    _require(stats["n_failed"] == 0
             and all(t.error is None for t in tickets),
             f"{stats['n_failed']} queries failed: "
             f"{next((t.error for t in tickets if t.error), None)!r}")
    print(f"served {len(tickets)} {args.predicate} match queries in "
          f"{dt:.2f}s ({len(tickets)/dt:.1f} qps)")
    print(f"launches={stats['n_launches']} "
          f"coalesced={stats['n_coalesced_launches']} "
          f"(fused {stats['n_coalesced_queries']} queries) "
          f"cache_hits={stats['n_cache_hits']} "
          f"(hit_rate={stats['cache_hit_rate']:.2f}) "
          f"avg_latency={stats['avg_latency_s']*1e3:.1f}ms "
          f"latency_p50={stats['latency_p50_s']*1e3:.1f}ms "
          f"p95={stats['latency_p95_s']*1e3:.1f}ms "
          f"p99={stats['latency_p99_s']*1e3:.1f}ms "
          f"ticks={stats['n_ticks']} "
          f"launches/tick={stats['avg_launches_per_tick']} "
          f"failed={stats['n_failed']}")
    if stats["timings"]:
        print("stage seconds (last tick): " + " ".join(
            f"{k}={v:.4f}" for k, v in stats["timings"].items()))
    print(f"plan-vs-actual: mispredict_rate="
          f"{stats['plan_mispredict_rate']:.3f} over "
          f"{len(stats['plan_actual'] or {})} (kernel, shape) buckets")
    if args.selective:
        print(f"filtered_launches={stats['n_filtered_launches']} "
              f"(filter_hit_rate={stats['filter_hit_rate']:.2f}) "
              f"avg_survivor_frac={stats['avg_survivor_frac']:.4f} "
              f"index={eng.index.stats() if eng.index else None}")
    if ingests:
        grew = eng.corpus.n_rows - rows_before
        # Resident repacks = packs beyond the lazy first one per form (a
        # coalesced launch may legitimately first-pack the *other* form
        # when the batched roofline picks the other kernel).
        repacks = (max(0, eng.corpus.swar_pack_count - 1)
                   + max(0, eng.corpus.onehot_pack_count - 1))
        _require(repacks == 0,
                 "resident rows must never repack during ingest")
        print(f"ingested {stats['n_ingested_rows']} rows in "
              f"{stats['n_ingest_batches']} batched appends "
              f"({rows_before} -> {eng.corpus.n_rows} rows, capacity "
              f"{eng.corpus.capacity}, resident repacks: {repacks})")
        _require(grew == stats["n_ingested_rows"],
                 "the corpus grew by the ingested rows")
    if args.trace:
        _export_trace(obs, args.trace)
    return stats


def run_stream(args) -> Dict:
    """Open-loop document stream against a standing pattern bank.

    Each tick, ``--docs-per-tick`` synthetic documents arrive via
    ``service.ingest``; every ``--plant-every``-th document carries a
    planted substring of a registered standing pattern, so the expected
    hit stream is known.  The service scans each tick's fused batch
    against the whole bank in **one** roles-swapped launch before
    appending (checked below), evicts past ``--window-rows``, and the
    report covers what a standing-query deployment is judged on: bank
    launches per tick, planted-hit detection + latency percentiles, and
    prefilter survivor fractions.  Returns the stats snapshot.
    """
    from repro_torch.match import (MatchEngine, MatchService, PackedCorpus,
                                   PatternBank)

    rng = np.random.default_rng(0)
    F, P = args.fragment_chars, args.pattern_chars
    corpus = PackedCorpus(rng.integers(0, 4, (args.corpus_rows, F),
                                       np.uint8), device=args.device)
    obs = _build_obs(args)
    eng = MatchEngine(corpus, obs=obs)
    bank = PatternBank(F, P, capacity=max(8, args.bank_patterns),
                       filter={"auto": None, "on": True,
                               "off": False}[args.bank_filter],
                       device=corpus.device)
    pats = rng.integers(0, 4, (args.bank_patterns, P), np.uint8)
    for p in pats:
        bank.register(p, threshold=P)
    svc = MatchService(eng, bank=bank, window_rows=args.window_rows or None)

    per_tick_launches, survivor_fracs, latencies = [], [], []
    n_planted = n_detected = 0
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        docs = rng.integers(0, 4, (args.docs_per_tick, F), np.uint8)
        planted_docs = set()
        if args.plant_every:
            for d in range(0, args.docs_per_tick, args.plant_every):
                j = int(rng.integers(0, args.bank_patterns))
                off = int(rng.integers(0, F - P + 1))
                docs[d, off:off + P] = pats[j]
                planted_docs.add(d)
                n_planted += 1
        t_arrive = time.perf_counter()
        ticket = svc.ingest(docs)
        before = svc.stats.n_bank_launches
        svc.tick()
        t_done = time.perf_counter()
        per_tick_launches.append(svc.stats.n_bank_launches - before)
        bt = ticket.bank_ticket
        hit_docs = set(int(d) for d in bt.hits[:, 0])
        n_detected += len(planted_docs & hit_docs)
        latencies.extend((t_done - t_arrive,) * len(planted_docs & hit_docs))
        if bt.survivor_frac is not None:
            survivor_fracs.append(bt.survivor_frac)
    dt = time.perf_counter() - t0

    _require(all(n == 1 for n in per_tick_launches),
             "every ingest tick must cost exactly one fused bank launch")
    _require(n_detected == n_planted,
             f"planted hits missed: {n_detected}/{n_planted}")
    total_docs = args.ticks * args.docs_per_tick
    lat = np.array(sorted(latencies)) if latencies else np.zeros(1)
    print(f"streamed {total_docs} docs over {args.ticks} ticks against "
          f"{bank.n_live} standing patterns in {dt:.2f}s "
          f"({total_docs / dt:.1f} docs/s)")
    print(f"bank launches/tick={np.mean(per_tick_launches):.0f} "
          f"(total {svc.stats.n_bank_launches}, prefilter "
          f"{svc.stats.n_bank_prefilter_launches}) "
          f"planted hits detected {n_detected}/{n_planted} "
          f"hit latency p50={np.percentile(lat, 50) * 1e3:.1f}ms "
          f"p95={np.percentile(lat, 95) * 1e3:.1f}ms")
    surv = (f"mean={np.mean(survivor_fracs):.4f} "
            f"last={survivor_fracs[-1]:.4f}" if survivor_fracs
            else "(scan strategy: no prefilter launches)")
    print(f"prefilter survivor fractions {surv}")
    if args.window_rows:
        print(f"window: corpus {corpus.n_live} live / {corpus.n_rows} "
              f"physical rows (evicted {svc.stats.n_evicted_rows}, "
              f"compactions {corpus.n_compactions})")
        _require(corpus.n_live <= args.window_rows,
                 "the window bounds the live rows")
    if args.trace:
        _export_trace(obs, args.trace)
    return svc.stats.snapshot()


def build_parser() -> argparse.ArgumentParser:
    """The reference launcher's flags, plus ``--device`` and ``--profiler``
    (in place of ``--jax-profiler``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "match", "stream"),
                    default="lm")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--corpus-rows", type=int, default=64,
                    help="match workload: resident corpus rows")
    ap.add_argument("--fragment-chars", type=int, default=256,
                    help="match workload: fragment length")
    ap.add_argument("--pattern-chars", type=int, default=32,
                    help="match workload: query pattern length")
    ap.add_argument("--predicate", choices=("exact", "wildcard"),
                    default="exact",
                    help="match workload: exact queries or N-wildcard "
                         "accept-mask queries")
    ap.add_argument("--selective", type=int, default=0,
                    help="match workload: make every Kth request a "
                         "selective exact-threshold lookup of a planted "
                         "substring (0 disables); eligible for the q-gram "
                         "filter index")
    ap.add_argument("--ingest-every", type=int, default=4,
                    help="match workload: ingest one fresh corpus row "
                         "every K requests (0 disables ingestion)")
    ap.add_argument("--tick-every", type=int, default=8,
                    help="match workload: drive a service tick every K "
                         "submissions (0: one big flush at the end)")
    ap.add_argument("--bank-patterns", type=int, default=64,
                    help="stream workload: standing patterns registered "
                         "in the bank")
    ap.add_argument("--ticks", type=int, default=8,
                    help="stream workload: arrival ticks to run")
    ap.add_argument("--docs-per-tick", type=int, default=16,
                    help="stream workload: documents arriving per tick")
    ap.add_argument("--plant-every", type=int, default=4,
                    help="stream workload: every Kth arriving doc carries "
                         "a planted bank hit (0 disables)")
    ap.add_argument("--window-rows", type=int, default=256,
                    help="stream workload: sliding-window corpus bound "
                         "(0: append-only)")
    ap.add_argument("--bank-filter", choices=("auto", "on", "off"),
                    default="auto",
                    help="stream workload: pattern-side q-gram prefilter "
                         "routing (auto: planner prices it)")
    ap.add_argument("--trace", type=str, default="",
                    help="match/stream workloads: write the span tree "
                         "here on exit -- Chrome/Perfetto trace-event "
                         "JSON, or JSON-lines if the path ends in "
                         ".jsonl (enables span collection)")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="match workload: print one greppable metrics "
                         "line every N service ticks (0 disables)")
    ap.add_argument("--profiler", action="store_true",
                    help="annotate spans into the torch profiler timeline "
                         "(torch.profiler.record_function) as well")
    return ap


def main(argv=None) -> Dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.workload == "match":
        return run_match_service(args)
    if args.workload == "stream":
        return run_stream(args)
    ap.error("--workload lm needs the LM serving engine, which the port "
             "does not have yet (ROADMAP Queue 1, item 16: the LM "
             "substrate)")


if __name__ == "__main__":
    main()
