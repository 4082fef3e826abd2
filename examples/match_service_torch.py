"""Match service on the PyTorch/CUDA port: many tenants, one resident
corpus.

The multi-tenant serving layer (DESIGN.md Sec. 3d) in four steps:

1. Concurrent small queries coalesce into one fused batched launch.
2. Mixed reductions / row subsets group separately but stay correct.
3. Repeat queries hit the LRU result cache.
4. A corpus row write bumps the generation and invalidates the cache.
5. Declarative wildcard queries (accept-mask predicates) coalesce too.

The twin of ``match_service.py``: the same seeds, sizes, printed lines
and asserts, on ``repro_torch`` (each group's plan takes its kernel on
the card: SWAR at these sizes); ``main(device="cpu")`` runs the plain
versions on the CPU.

Run:  PYTHONPATH=src python examples/match_service_torch.py
"""

import numpy as np

from repro_torch.match import MatchEngine, MatchQuery, MatchService


def main(device=None) -> None:
    rng = np.random.default_rng(0)
    frags = rng.integers(0, 4, (64, 256), np.uint8)
    engine = MatchEngine(frags, device=device)
    service = MatchService(engine)

    print("== 1. coalescing: 16 tenants submit, one fused launch ==")
    pats = rng.integers(0, 4, (16, 32), np.uint8)
    tickets = [service.submit(p) for p in pats]
    service.flush()
    s = service.stats.snapshot()
    print(f"  {s['n_completed']} queries served by {s['n_launches']} launch"
          f" ({s['n_coalesced_queries']} fused);"
          f" avg latency {s['avg_latency_s']*1e3:.1f}ms")
    solo = engine.match(pats[3])
    assert np.array_equal(tickets[3].result.best_scores, solo.best_scores)
    print("  scattered result == solo engine.match: True")

    print("\n== 2. mixed work in one tick ==")
    t_best = service.submit(pats[0])                       # cache hit
    t_topk = service.submit(rng.integers(0, 4, 32, np.uint8),
                            reduction="topk", k=3)
    t_sub = service.submit(rng.integers(0, 4, 32, np.uint8),
                           rows=np.array([5, 1, 9]))
    done = service.tick()
    print(f"  one tick completed {done} requests "
          f"(best-from-cache={t_best.cached}, "
          f"topk rows={t_topk.result.topk_rows.tolist()}, "
          f"subset best={t_sub.result.best_scores.tolist()})")

    print("\n== 3. result cache ==")
    before = service.stats.n_cache_hits
    service.match(pats[7])
    print(f"  resubmitted a seen pattern: cache hits "
          f"{before} -> {service.stats.n_cache_hits}")

    print("\n== 4. corpus write invalidates ==")
    gen = engine.corpus.generation
    engine.corpus.set_rows(0, rng.integers(0, 4, (1, 256), np.uint8))
    t = service.submit(pats[7])
    service.tick()
    print(f"  generation {gen} -> {engine.corpus.generation}; "
          f"resubmit after write served from cache: {t.cached}")

    print("\n== 5. wildcard predicates coalesce like exact queries ==")
    before_launches = service.stats.n_launches
    wild = []
    for q in range(8):
        masks = (np.uint8(1) << rng.integers(0, 4, 32, np.uint8))
        masks[rng.integers(0, 32, 4)] = 0b1111     # four N wildcards each
        wild.append(service.submit(MatchQuery.from_masks(masks)))
    service.flush()
    s = service.stats.snapshot()
    print(f"  8 N-wildcard queries served by "
          f"{s['n_launches'] - before_launches} fused launch; "
          f"predicate={wild[0].result.plan.predicate!r} "
          f"backend={wild[0].result.plan.backend!r}")


if __name__ == "__main__":
    main()
