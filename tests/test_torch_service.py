"""Service parity: the port's ``MatchService`` against the JAX package's.

Every case of ``tests/test_match_service.py`` runs twice over the same
seeded inputs: once through ``repro.match.MatchService`` (its Pallas
kernels in interpret mode on the CPU) and once through
``repro_torch.match.MatchService`` over ``device="cpu"`` (the kernels'
plain versions).  Each case keeps the reference's own assertions on the
port, and adds parity:

* every ticket's result is bit-identical to the JAX ticket's (best
  arrays, scores, top-k, hits, survivor rows; values and dtypes) --
  exact, since all results are integers;
* the counters of ``ServiceStats.snapshot()`` are equal, leaving out only
  the time-based fields and the roofline-dependent ones
  (``NOT_COUNTERS``).

``Planner.plan_batch`` is compared at the sizes the service meets: the
verdict, the query count and the plan's backend and geometry must equal
JAX's at Q = 1, 2, 3, 8 and 64; the verdict must equal it for every Q up
to 128.
"""

import numpy as np
import pytest

import repro.match as jm
import repro_torch.match as tm

R, F, P = 24, 96, 16

# Snapshot fields that hold a time (latencies, qps, stage seconds) or a
# price from the planner's roofline (plan-vs-actual); every other field is
# a counter both services must agree on.
NOT_COUNTERS = ("avg_latency_s", "latency_p50_s", "latency_p95_s",
                "latency_p99_s", "qps", "timings", "plan_actual",
                "plan_mispredict_rate")
RESULT_ARRAYS = ("best_locs", "best_scores", "scores", "topk_rows",
                 "topk_scores", "hits", "survivor_rows")


def counters(snap):
    return {k: v for k, v in snap.items() if k not in NOT_COUNTERS}


def assert_same_result(got, want):
    """Bit-identical result arrays (``None`` where the other is ``None``)."""
    for f in RESULT_ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.survivor_frac == want.survivor_frac
    assert got.n_chunks == want.n_chunks


class Pair:
    """One JAX service and one port service driven identically.

    ``submit`` / ``ingest`` return (jax ticket, port ticket); ``tick`` and
    ``flush`` drive both and check that their snapshot counters agree.
    """

    def __init__(self, frags, *, capacity=None, bank=None, **svc_kw):
        kw = {} if capacity is None else {"capacity": capacity}
        self.je = jm.MatchEngine(jm.PackedCorpus(frags, **kw))
        self.te = tm.MatchEngine(tm.PackedCorpus(frags, device="cpu", **kw))
        jb, tb = bank if bank is not None else (None, None)
        self.js = jm.MatchService(self.je, bank=jb, **svc_kw)
        self.ts = tm.MatchService(self.te, bank=tb, **svc_kw)

    def submit(self, *a, **kw):
        return self.js.submit(*a, **kw), self.ts.submit(*a, **kw)

    def submit_query(self, make_query):
        """Submit ``make_query(package)`` to each package's service (a
        ``MatchQuery`` is the package's own IR)."""
        return self.js.submit(make_query(jm)), self.ts.submit(make_query(tm))

    def ingest(self, rows):
        return self.js.ingest(rows), self.ts.ingest(rows)

    def match(self, *a, **kw):
        j, t = self.submit(*a, **kw)
        return self.wait(j, t)

    def wait(self, j, t):
        want, got = j.wait(), t.wait()
        assert_same_result(got, want)
        self.same_stats()
        return got

    def tick(self):
        a, b = self.js.tick(), self.ts.tick()
        assert a == b
        self.same_stats()
        return b

    def flush(self):
        self.js.flush()
        self.ts.flush()
        self.same_stats()

    def same_stats(self):
        assert counters(self.ts.stats.snapshot()) == \
            counters(self.js.stats.snapshot())

    def same_tickets(self, pairs):
        for j, t in pairs:
            assert j.done and t.done
            assert j.cached == t.cached
            assert (j.error is None) == (t.error is None)
            if j.error is None:
                assert_same_result(t.result, j.result)


def make(seed=0, cache_size=256):
    rng = np.random.default_rng(seed)
    frags = rng.integers(0, 4, (R, F), np.uint8)
    return rng, Pair(frags, cache_size=cache_size)


class TestCoalescingCorrectness:
    @pytest.mark.parametrize("reduction", ["best", "full"])
    def test_fused_equals_oracle(self, reduction):
        rng, pair = make(1)
        pats = [rng.integers(0, 4, P, np.uint8) for _ in range(6)]
        tickets = [pair.submit(p, reduction=reduction) for p in pats]
        pair.flush()
        assert pair.ts.stats.n_coalesced_launches == 1
        assert pair.ts.stats.n_launches == 1
        pair.same_tickets(tickets)
        for (_, t), p in zip(tickets, pats):
            assert_same_result(t.result,
                               pair.te.match(p, reduction=reduction))

    def test_fused_topk_per_query_k(self):
        rng, pair = make(2)
        pats = [rng.integers(0, 4, P, np.uint8) for _ in range(5)]
        ks = [1, 3, 7, 2, 50]                     # includes k > R
        tickets = [pair.submit(p, reduction="topk", k=k)
                   for p, k in zip(pats, ks)]
        pair.flush()
        pair.same_tickets(tickets)
        for (_, t), p, k in zip(tickets, pats, ks):
            want = pair.te.match(p, reduction="topk", k=k)
            np.testing.assert_array_equal(t.result.topk_scores,
                                          want.topk_scores)
            assert t.result.topk_rows.shape == want.topk_rows.shape

    def test_fused_threshold_per_query_threshold(self):
        rng, pair = make(3)
        pats = [rng.integers(0, 4, P, np.uint8) for _ in range(5)]
        thrs = [6, 8, 10, 7, 9]
        tickets = [pair.submit(p, reduction="threshold", threshold=t)
                   for p, t in zip(pats, thrs)]
        pair.flush()
        pair.same_tickets(tickets)
        for (_, t), p, thr in zip(tickets, pats, thrs):
            want = pair.te.match(p, reduction="threshold", threshold=thr)
            np.testing.assert_array_equal(t.result.hits, want.hits)

    def test_rows_subsets_do_not_cross_coalesce(self):
        rng, pair = make(4)
        pats = [rng.integers(0, 4, P, np.uint8) for _ in range(4)]
        subs = [None, [3, 1, 8], None, [3, 1, 8]]
        tickets = [pair.submit(p, rows=s) for p, s in zip(pats, subs)]
        pair.flush()
        assert pair.ts.stats.n_launches == 2      # one group per subset
        pair.same_tickets(tickets)
        for (_, t), p, s in zip(tickets, pats, subs):
            assert_same_result(t.result, pair.te.match(p, rows=s))

    def test_empty_subset_through_service(self):
        rng, pair = make(5)
        pat = rng.integers(0, 4, P, np.uint8)
        res = pair.match(pat, rows=np.array([], dtype=int))
        assert res.best_locs.shape == (0,)

    def test_mixed_pattern_lengths_grouped_separately(self):
        rng, pair = make(6)
        p16 = [rng.integers(0, 4, 16, np.uint8) for _ in range(3)]
        p32 = [rng.integers(0, 4, 32, np.uint8) for _ in range(3)]
        ts = [pair.submit(p) for p in p16 + p32]
        pair.flush()
        assert pair.ts.stats.n_launches == 2
        pair.same_tickets(ts)
        for (_, t), p in zip(ts, p16 + p32):
            assert_same_result(t.result, pair.te.match(p))

    def test_two_dim_patterns_pass_through(self):
        rng, pair = make(7)
        pats = rng.integers(0, 4, (4, P), np.uint8)
        res = pair.match(pats, mode="batched")
        assert_same_result(res, pair.te.match(pats, mode="batched"))

    def test_same_tick_duplicates_share_one_query(self):
        rng, pair = make(8)
        pat = rng.integers(0, 4, P, np.uint8)
        other = rng.integers(0, 4, P, np.uint8)
        ts = [pair.submit(pat), pair.submit(other), pair.submit(pat)]
        pair.flush()
        assert pair.ts.stats.n_launches == 1
        assert ts[0][1].result is ts[2][1].result  # deduped within the tick
        pair.same_tickets(ts)
        assert_same_result(ts[0][1].result, pair.te.match(pat))


class TestCacheSemantics:
    def test_cache_hit_on_repeat(self):
        rng, pair = make(10)
        pat = rng.integers(0, 4, P, np.uint8)
        first = pair.match(pat)
        hit = pair.submit(pat)
        pair.tick()
        assert hit[1].cached and hit[1].result is first
        pair.same_tickets([hit])
        assert pair.ts.stats.n_cache_hits == 1
        assert pair.ts.stats.n_launches == 1      # no second launch

    def test_different_k_not_conflated(self):
        rng, pair = make(11)
        pat = rng.integers(0, 4, P, np.uint8)
        a = pair.match(pat, reduction="topk", k=2)
        b = pair.match(pat, reduction="topk", k=5)
        assert a.topk_rows.shape == (2,) and b.topk_rows.shape == (5,)
        assert pair.ts.stats.n_cache_hits == 0

    def test_set_rows_invalidates(self):
        rng, pair = make(12)
        pat = rng.integers(0, 4, P, np.uint8)
        stale = pair.match(pat)
        gen = pair.te.corpus.generation
        new_rows = rng.integers(0, 4, (R, F), np.uint8)
        pair.je.corpus.set_rows(0, new_rows)
        pair.te.corpus.set_rows(0, new_rows)
        assert pair.te.corpus.generation > gen
        fresh = pair.submit(pat)
        pair.tick()
        assert not fresh[1].cached
        pair.same_tickets([fresh])
        assert_same_result(fresh[1].result, pair.te.match(pat))
        with pytest.raises(AssertionError):
            np.testing.assert_array_equal(fresh[1].result.best_scores,
                                          stale.best_scores)

    def test_lru_eviction(self):
        rng, pair = make(13, cache_size=2)
        pats = [rng.integers(0, 4, P, np.uint8) for _ in range(3)]
        for p in pats:
            pair.match(p)                         # fills, evicts pats[0]
        pair.match(pats[0])
        assert pair.ts.stats.n_cache_hits == 0
        pair.match(pats[0])                       # now resident
        assert pair.ts.stats.n_cache_hits == 1


class TestPricingAndStats:
    def test_coalesced_launch_counted(self):
        rng, pair = make(20)
        tickets = [pair.submit(p) for p in
                   [rng.integers(0, 4, P, np.uint8) for _ in range(8)]]
        pair.tick()
        pair.same_tickets(tickets)
        s = pair.ts.stats.snapshot()
        assert s["n_coalesced_launches"] == 1
        assert s["n_coalesced_queries"] == 8
        assert s["n_completed"] == 8
        assert s["avg_latency_s"] > 0 and s["qps"] > 0

    def test_singleton_group_runs_solo(self):
        rng, pair = make(21)
        pair.match(rng.integers(0, 4, P, np.uint8))
        assert pair.ts.stats.n_coalesced_launches == 0
        assert pair.ts.stats.n_launches == 1

    def test_tick_returns_completed_count(self):
        rng, pair = make(22)
        for p in [rng.integers(0, 4, P, np.uint8) for _ in range(3)]:
            pair.submit(p)
        assert pair.tick() == 3
        assert pair.tick() == 0

    def test_bad_request_does_not_poison_tick(self):
        rng, pair = make(24)
        good = pair.submit(rng.integers(0, 4, P, np.uint8))
        bad = pair.submit(np.zeros(F + 1, np.uint8))  # longer than fragment
        done = pair.tick()
        assert done == 2 and good[1].done and bad[1].done
        assert good[1].error is None and good[1].result is not None
        assert isinstance(bad[1].error, ValueError)
        assert type(bad[0].error) is type(bad[1].error)
        pair.same_tickets([good, bad])
        with pytest.raises(ValueError, match="longer"):
            bad[1].wait()
        assert pair.ts.stats.n_failed == 1

    def test_explicit_shared_mode_coalesces(self):
        rng, pair = make(25)
        pat = rng.integers(0, 4, P, np.uint8)
        other = rng.integers(0, 4, P, np.uint8)
        pair.submit(pat, mode="shared")
        pair.submit(other)
        pair.tick()
        assert pair.ts.stats.n_coalesced_launches == 1
        hit = pair.submit(pat)
        pair.tick()
        assert hit[1].cached
        pair.same_tickets([hit])

    def test_submit_validates(self):
        rng, pair = make(23)
        for svc in (pair.js, pair.ts):
            with pytest.raises(ValueError, match="unknown reduction"):
                svc.submit(np.zeros(P, np.uint8), reduction="nope")
            with pytest.raises(ValueError, match="requires a threshold"):
                svc.submit(np.zeros(P, np.uint8), reduction="threshold")
        pair.same_stats()


# (n_rows, fragment_chars, pattern_chars): the service tests' corpus, the
# launcher's default, and chr1 folded into 500-char rows for 100-char
# reads (the chip smoke's service cell).
BATCH_SIZES = [(24, 96, 16), (64, 256, 32), (620_839, 500, 100)]


@pytest.mark.parametrize("n_rows,fragment_chars,pattern_chars", BATCH_SIZES)
@pytest.mark.parametrize("n_queries", [1, 2, 3, 8, 64])
def test_plan_batch_matches_jax(n_rows, fragment_chars, pattern_chars,
                                n_queries):
    names = list(tm.BatchPlan.__dataclass_fields__)
    assert names == list(jm.BatchPlan.__dataclass_fields__)
    for backend in (None, "swar", "mxu"):
        for predicate in ("exact", "accept"):
            kw = dict(n_rows=n_rows, fragment_chars=fragment_chars,
                      pattern_chars=pattern_chars, n_queries=n_queries,
                      backend=backend, predicate=predicate)
            a = jm.Planner().plan_batch(**kw)
            b = tm.Planner().plan_batch(**kw)
            assert (b.coalesced, b.n_queries) == (a.coalesced, a.n_queries)
            for f in ("backend", "mode", "n_rows", "n_patterns", "n_locs",
                      "wp", "need_words", "l_pad", "p_chars_pad", "q_pad",
                      "f_chars", "chunk_rows", "predicate"):
                assert getattr(b.plan, f) == getattr(a.plan, f), (kw, f)


@pytest.mark.parametrize("n_rows,fragment_chars,pattern_chars", BATCH_SIZES)
def test_plan_batch_verdict_matches_jax_for_every_group_size(
        n_rows, fragment_chars, pattern_chars):
    """The coalesce-or-not verdict agrees for every Q up to 128.  The
    backend may differ (the North star lets choices differ by chip): the
    H100 roofline keeps some large batched groups on SWAR where the TPU
    roofline moves them to the matrix unit (at chr1 size, exact Q = 32-39
    and accept-set Q = 13-15), and never the other way round."""
    for n_queries in range(1, 129):
        for predicate in ("exact", "accept"):
            kw = dict(n_rows=n_rows, fragment_chars=fragment_chars,
                      pattern_chars=pattern_chars, n_queries=n_queries,
                      predicate=predicate)
            a = jm.Planner().plan_batch(**kw)
            b = tm.Planner().plan_batch(**kw)
            assert b.coalesced == a.coalesced, kw
            if b.plan.backend != a.plan.backend:
                assert (b.plan.backend, a.plan.backend) == ("swar", "mxu"), kw


def test_plan_batch_validates():
    with pytest.raises(ValueError, match="n_queries"):
        tm.Planner().plan_batch(n_rows=R, fragment_chars=F, pattern_chars=P,
                                n_queries=0)
    with pytest.raises(ValueError, match="n_shards"):
        tm.Planner().plan_batch(n_rows=R, fragment_chars=F, pattern_chars=P,
                                n_queries=2, n_shards=4)
