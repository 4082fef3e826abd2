"""Ingest parity: the port's service ingestion, standing bank, sliding
window and ``CRAMDedup`` against the JAX package's.

The cases of ``TestServiceIngestion``, ``TestSameTickDuplicateLaunch``
and ``TestDedupLifetimeEngine`` (``tests/test_match_ingest.py``) and the
service cases of ``tests/test_match_standing.py`` (empty ingest, one bank
scan before the splice, TTL before the scan, the sliding window end to
end) run through both packages over the same seeded inputs: the JAX
service with its Pallas kernels in interpret mode on the CPU, the port's
over ``device="cpu"``.  Each case keeps the reference's own assertions on
the port; results, bank hits, corpus rows and the snapshot counters must
be identical (exact: every result is an integer).
"""

import numpy as np
import pytest

import repro.match as jm
import repro_torch.match as tm
from repro.data import dedup as jdd
from repro_torch.data import dedup as tdd

from test_torch_service import Pair

R0, F, P = 10, 96, 16


def make(seed=0, **kw):
    rng = np.random.default_rng(seed)
    return rng, Pair(rng.integers(0, 4, (R0, F), np.uint8), **kw)


def same_ingest(pair, j, t):
    assert (t.done, t.start, t.n) == (j.done, j.start, j.n)
    if j.bank_ticket is None:
        assert t.bank_ticket is None
        return
    a, b = j.bank_ticket, t.bank_ticket
    np.testing.assert_array_equal(b.hits, a.hits)
    np.testing.assert_array_equal(b.corpus_rows, a.corpus_rows)
    assert (b.base_row, b.survivor_frac, b.n_bank_launches) == \
        (a.base_row, a.survivor_frac, a.n_bank_launches)


def same_corpus(pair):
    jc, tc = pair.je.corpus, pair.te.corpus
    np.testing.assert_array_equal(tc.fragments, jc.fragments)
    np.testing.assert_array_equal(tc.dead_mask, jc.dead_mask)
    np.testing.assert_array_equal(tc.live_row_ids(), jc.live_row_ids())
    np.testing.assert_array_equal(tc.shard_live_rows, jc.shard_live_rows)
    for f in ("n_rows", "n_live", "n_dead", "capacity", "generation",
              "n_compactions", "row_update_count"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert pair.te.n_shards == pair.je.n_shards == 1
    np.testing.assert_array_equal(pair.te.shard_live_rows(),
                                  pair.je.shard_live_rows())


class TestServiceIngestion:
    def test_ingest_applies_on_tick_in_one_batch(self):
        rng, pair = make(20)
        t1 = pair.ingest(rng.integers(0, 4, (2, F), np.uint8))
        t2 = pair.ingest(rng.integers(0, 4, F, np.uint8))
        assert not t1[1].done and pair.te.corpus.n_rows == R0
        pair.tick()
        for t in (t1, t2):
            same_ingest(pair, *t)
        assert (t1[1].start, t1[1].n) == (R0, 2)
        assert (t2[1].start, t2[1].n) == (R0 + 2, 1)  # submission order
        assert pair.te.corpus.n_rows == R0 + 3
        assert pair.ts.stats.n_ingest_batches == 1    # one batched append
        assert pair.ts.stats.n_ingested_rows == 3
        same_corpus(pair)

    def test_ingest_validates_width_at_the_door(self):
        rng, pair = make(21)
        for svc in (pair.js, pair.ts):
            with pytest.raises(ValueError, match=f"\\(n, {F}\\)"):
                svc.ingest(np.zeros((1, F + 5), np.uint8))

    def test_queries_in_same_tick_see_ingested_rows(self):
        rng, pair = make(22)
        pat = rng.integers(0, 4, P, np.uint8)
        planted = np.zeros(F, np.uint8)
        planted[5:5 + P] = pat
        pair.ingest(planted)
        ticket = pair.submit(pat)
        pair.tick()
        pair.same_tickets([ticket])
        assert ticket[1].result.best_scores.shape == (R0 + 1,)
        assert ticket[1].result.best_scores[R0] == P

    def test_cache_invalidated_by_ingest(self):
        rng, pair = make(23)
        pat = rng.integers(0, 4, P, np.uint8)
        stale = pair.match(pat)
        pair.ingest(rng.integers(0, 4, F, np.uint8))
        fresh = pair.submit(pat)
        pair.tick()
        pair.same_tickets([fresh])
        assert not fresh[1].cached                  # generation moved
        assert fresh[1].result.best_scores.shape[0] == R0 + 1
        assert stale.best_scores.shape[0] == R0

    def test_ingest_wait_drives_ticks(self):
        rng, pair = make(24)
        j, t = pair.ingest(rng.integers(0, 4, F, np.uint8))
        assert j.wait() == t.wait() == R0
        assert pair.te.corpus.n_rows == R0 + 1
        pair.same_stats()

    def test_flush_drains_ingest_queue(self):
        rng, pair = make(25)
        pair.ingest(rng.integers(0, 4, (4, F), np.uint8))
        pair.flush()
        assert pair.te.corpus.n_rows == R0 + 4
        same_corpus(pair)

    def test_mixed_ingest_query_stream_no_repacks(self):
        rng, pair = make(26)
        pats = [rng.integers(0, 4, P, np.uint8) for _ in range(6)]
        pair.match(pats[0])                         # warm: pack forms
        packs = pair.te.corpus.host_pack_count
        for p in pats:
            pair.ingest(rng.integers(0, 4, (2, F), np.uint8))
            ticket = pair.submit(p)
            pair.tick()
            pair.same_tickets([ticket])
        assert pair.te.corpus.n_rows == R0 + 12
        assert pair.te.corpus.host_pack_count == packs  # 0 resident repacks
        same_corpus(pair)
        want = tm.MatchEngine(np.array(pair.te.corpus.fragments),
                              device="cpu").match(pats[-1])
        got = pair.match(pats[-1])
        np.testing.assert_array_equal(got.best_scores, want.best_scores)
        np.testing.assert_array_equal(got.best_locs, want.best_locs)


class TestSameTickDuplicateLaunch:
    def test_duplicate_batched_queries_share_one_launch(self):
        rng, pair = make(30)
        pats = rng.integers(0, 4, (4, P), np.uint8)

        def query(pkg):
            return pkg.MatchQuery.exact(pats, mode="batched")
        t1, t2 = pair.submit_query(query), pair.submit_query(query)
        pair.tick()
        assert pair.ts.stats.n_launches == 1
        assert t1[1].result is t2[1].result         # shared, bit-identical
        assert t1[1].result.best_scores.shape == (R0, 4)
        pair.same_tickets([t1, t2])

    def test_distinct_batched_queries_still_launch_separately(self):
        rng, pair = make(31)
        a = rng.integers(0, 4, (3, P), np.uint8)
        b = rng.integers(0, 4, (3, P), np.uint8)
        ta = pair.submit_query(
            lambda pkg: pkg.MatchQuery.exact(a, mode="batched"))
        tb = pair.submit_query(
            lambda pkg: pkg.MatchQuery.exact(b, mode="batched"))
        pair.tick()
        assert pair.ts.stats.n_launches == 2
        assert ta[1].result is not tb[1].result
        pair.same_tickets([ta, tb])


class TestDedupLifetimeEngine:
    def test_engine_survives_capacity_growth(self):
        rng = np.random.default_rng(40)
        d = tdd.CRAMDedup(threshold=1.01, device="cpu")  # never a duplicate
        ref = jdd.CRAMDedup(threshold=1.01)
        engine = d.engine
        corpus = engine.corpus
        for _ in range(70):                         # crosses capacity 64
            doc = rng.bytes(64)
            d.add(doc)
            ref.add(doc)
        assert d.engine is engine                   # no rebuild, ever
        assert d.engine.corpus is corpus
        assert len(d) == 70 and d.capacity == 128
        assert d.total_row_writes == 70
        assert (len(d), d.capacity, d.total_row_writes, d.total_host_packs) \
            == (len(ref), ref.capacity, ref.total_row_writes,
                ref.total_host_packs)
        np.testing.assert_array_equal(d.engine.corpus.fragments,
                                      ref.engine.corpus.fragments)

    def test_add_rejects_fingerprint_wider_than_fp_len(self):
        for d in (tdd.CRAMDedup(fp_len=64, pattern_len=32, device="cpu"),
                  jdd.CRAMDedup(fp_len=64, pattern_len=32)):
            with pytest.raises(ValueError, match="fp_len=64"):
                d.add(np.zeros(65, np.uint8))
            d.add(np.zeros(64, np.uint8))           # exact width is fine
            assert len(d) == 1

    def test_precomputed_fingerprint_roundtrip(self):
        rng = np.random.default_rng(41)
        doc = rng.bytes(200)
        np.testing.assert_array_equal(tdd.fingerprint(doc, 128),
                                      jdd.fingerprint(doc, 128))
        d = tdd.CRAMDedup(threshold=0.9, device="cpu")
        d.add(tdd.fingerprint(doc, d.fp_len))       # array spelling
        assert d.is_duplicate(doc)                  # bytes spelling agrees

    def test_pattern_len_cannot_exceed_fp_len(self):
        for cls, kw in ((tdd.CRAMDedup, {"device": "cpu"}),
                        (jdd.CRAMDedup, {})):
            with pytest.raises(ValueError, match="pattern_len"):
                cls(fp_len=32, pattern_len=64, **kw)

    def test_filter_keeps_what_jax_keeps(self):
        """Near-duplicates (a flipped crumb, a shifted copy) are dropped
        exactly as the JAX store drops them."""
        rng = np.random.default_rng(42)
        base = [rng.bytes(40) for _ in range(6)]
        docs = list(base)
        docs.append(bytes([base[0][0] ^ 1]) + base[0][1:])
        docs.append(base[2][1:])                     # shifted by 4 crumbs
        docs.append(base[4])
        docs += [rng.bytes(40) for _ in range(3)]
        kept = tdd.CRAMDedup(device="cpu").filter(docs)
        assert kept == jdd.CRAMDedup().filter(docs)
        assert len(kept) == 9


# -- the standing bank and the window through the service --------------------

def make_service(seed=31, window=None, bank_kw=None, **kw):
    """The reference's fixture: 24 rows in a 256-row corpus and an empty
    8-slot bank, one per package."""
    rng = np.random.default_rng(seed)
    frags = rng.integers(0, 4, (24, F), np.uint8)
    banks = (jm.PatternBank(F, P, capacity=8, **(bank_kw or {})),
             tm.PatternBank(F, P, capacity=8, device="cpu",
                            **(bank_kw or {})))
    pair = Pair(frags, capacity=256, bank=banks, window_rows=window, **kw)
    return rng, pair, banks


def register(banks, pattern, **kw):
    pids = [b.register(pattern, **kw) for b in banks]
    assert pids[0] == pids[1]
    return pids[1]


def test_empty_ingest_is_noop():
    rng, pair, banks = make_service()
    gen = pair.te.corpus.generation
    q = rng.integers(0, 4, P, np.uint8)
    pair.match(q)
    j, t = pair.ingest(np.zeros((0, F), np.uint8))
    assert t.done and t.n == 0 and t.start == pair.te.corpus.n_rows
    same_ingest(pair, j, t)
    pair.tick()
    assert pair.te.corpus.generation == gen
    assert pair.ts.stats.n_ingest_batches == 0
    assert pair.ts.stats.n_bank_launches == 0
    tk = pair.submit(q)
    pair.tick()
    assert tk[1].cached                               # cache survived
    pair.same_tickets([tk])


def test_ingest_scans_bank_once_before_splice():
    rng, pair, banks = make_service()
    docs = rng.integers(0, 4, (10, F), np.uint8)
    got = {"j": [], "t": []}
    pid = None
    for key, bank, eng in (("j", banks[0], pair.je), ("t", banks[1],
                                                      pair.te)):
        pid = bank.register(
            docs[4, 20:20 + P].copy(), threshold=P,
            on_hit=lambda p, h, key=key, eng=eng: got[key].append(
                (p, eng.corpus.n_rows)))
    base = pair.te.corpus.n_rows
    t1 = pair.ingest(docs[:6])
    t2 = pair.ingest(docs[6:])
    before = pair.ts.stats.n_bank_launches
    pair.tick()
    for t in (t1, t2):
        same_ingest(pair, *t)
    assert got["t"] == got["j"]
    # One fused launch covered both same-tick submissions...
    assert pair.ts.stats.n_bank_launches - before == 1
    # ...and fired before the rows spliced in.
    assert got["t"] and got["t"][0][1] == base
    bt = t1[1].bank_ticket
    assert bt is t2[1].bank_ticket and bt.base_row == base
    assert (bt.corpus_rows == base + bt.hits[:, 0]).all()
    assert {(4, 20)} <= {(int(h[0]), int(h[1])) for h in bt.hits}
    assert pair.ts.stats.n_bank_hits == bt.hits.shape[0]
    snap = pair.ts.stats.snapshot()
    assert snap["n_bank_launches"] == 1
    assert snap["bank"]["hits_by_pattern"][pid] >= 1
    same_corpus(pair)


def test_service_ttl_expires_before_scan():
    clock = [0.0]
    rng, pair, banks = make_service(bank_kw=dict(clock=lambda: clock[0]))
    docs = rng.integers(0, 4, (4, F), np.uint8)
    register(banks, docs[0, 3:3 + P].copy(), threshold=P, ttl_s=1.0)
    clock[0] = 2.0
    t = pair.ingest(docs)
    pair.tick()
    same_ingest(pair, *t)
    assert banks[1].n_live == 0 and banks[1].n_expired == 1
    assert t[1].bank_ticket.hits.shape[0] == 0


@pytest.mark.parametrize("bank_filter", [None, True, False])
def test_sliding_window_eviction_end_to_end(bank_filter):
    """The reference's window case, with a bank that fires on every tick
    (its prefilter priced, forced on and forced off)."""
    rng, pair, banks = make_service(window=30, compact_dead_frac=0.3,
                                    bank_kw={"filter": bank_filter})
    standing = rng.integers(0, 4, P, np.uint8)
    register(banks, standing, threshold=P)
    for i in range(3):
        register(banks, rng.integers(0, 4, P, np.uint8), threshold=P - i)
    for _ in range(5):
        docs = rng.integers(0, 4, (8, F), np.uint8)
        docs[2, 7:7 + P] = standing
        t = pair.ingest(docs)
        pair.tick()
        same_ingest(pair, *t)
        assert (2, 7) in {(int(h[0]), int(h[1]))
                          for h in t[1].bank_ticket.hits}
        same_corpus(pair)
    corpus = pair.te.corpus
    assert corpus.n_live == 30
    assert pair.ts.stats.n_evicted_rows == 24 + 5 * 8 - 30
    assert pair.ts.stats.n_compactions == corpus.n_compactions > 0
    # The window holds exactly the newest 30 rows, query-visible.
    planted = np.array(corpus.fragments[corpus.live_row_ids()[-1]])
    res = pair.match(planted[:P], reduction="threshold", threshold=P)
    assert res.hits.shape[0] >= 1
