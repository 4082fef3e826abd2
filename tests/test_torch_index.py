"""Q-gram index and filter-then-verify parity: the port against the JAX
package.

The same seeded fragments, patterns and thresholds go through
``repro.match`` on the CPU (Pallas in interpret mode) and
``repro_torch.match`` with ``device="cpu"`` (the kernels' plain
versions).  Signature words, filter flags, survivor sets, hits and the
index counters must be bit-identical; the selectivity model's floats
(density, survivor estimates) equal to 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.match as jm
import repro_torch.match as tm
from repro.kernels import filter_qgram as jfq
from repro.match import index as jix
from repro.match import planner as jpl
from repro_torch import convert
from repro_torch.kernels import filter_qgram as tfq
from repro_torch.match import index as tix
from repro_torch.match import planner as tpl

R, F, P = 200, 120, 32
PLANTED = (3, 77, 150, 151)
GEOMETRY = ("backend", "mode", "n_rows", "fragment_chars", "pattern_chars",
            "n_patterns", "n_locs", "wp", "need_words", "l_pad",
            "p_chars_pad", "q_pad", "f_chars", "chunk_rows", "predicate",
            "strategy", "filter_words", "est_survivor_frac", "n_shards")
INDEX_COUNTERS = ("sig_pack_count", "row_update_count", "n_filter_runs",
                  "last_survivor_frac")


def onehot(codes):
    return (np.uint8(1) << np.asarray(codes, np.uint8)).astype(np.uint8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    frags = rng.integers(0, 4, (R, F), np.uint8)
    pats = rng.integers(0, 4, (3, P), np.uint8)
    for i, row in enumerate(PLANTED):
        p = pats[i % 3].copy()
        if i == 3:
            p[5] = (p[5] + 1) % 4               # one mismatch
        off = int(rng.integers(0, F - P + 1))
        frags[row, off:off + P] = p
    return frags, pats


def signatures_equal(jindex, tindex):
    want = convert.swar_words_from_numpy(np.asarray(jindex.signatures()),
                                         "cpu")
    assert torch.equal(tindex.signatures(), want)
    assert jindex.sig_pack_count == tindex.sig_pack_count
    assert jindex.row_update_count == tindex.row_update_count


def assert_same_filtered(rj, rt):
    for f in ("best_locs", "best_scores", "hits", "survivor_rows"):
        a, b = np.asarray(getattr(rj, f)), getattr(rt, f)
        assert isinstance(b, np.ndarray), f
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert rj.survivor_frac == rt.survivor_frac
    assert rj.n_chunks == rt.n_chunks
    for g in GEOMETRY:
        assert getattr(rj.plan, g) == getattr(rt.plan, g), g


def run_both(engines, masks, **spec):
    je, te = engines
    rj = je.compile(jm.MatchQuery.from_masks(masks, **spec)).run()
    rt = te.compile(tm.MatchQuery.from_masks(masks, **spec)).run()
    assert_same_filtered(rj, rt)
    return rj, rt


# -- numpy helpers and the device hash ----------------------------------------

@pytest.mark.parametrize("q,n_bits", [(4, 256), (3, 64), (5, 32),
                                      (16, 1024)])
def test_signatures_match_jax(q, n_bits):
    rng = np.random.default_rng(q * n_bits)
    rows = rng.integers(0, 4, (37, 50), np.uint8)
    vals = tix.qgram_values(rows, q)
    np.testing.assert_array_equal(vals, jix.qgram_values(rows, q))
    np.testing.assert_array_equal(tix.hash_bits(vals, n_bits),
                                  jix.hash_bits(vals, n_bits))
    want_w, want_c = jix.row_signatures(rows, q, n_bits)
    got_w, got_c = tix.row_signatures(rows, q, n_bits)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_c, want_c)
    dw, dc = tix.signature_words(torch.from_numpy(rows), q, n_bits)
    np.testing.assert_array_equal(dw.numpy(), want_w.view(np.int32))
    np.testing.assert_array_equal(dc.numpy(), want_c)
    ragged = [rng.integers(0, n_bits, k) for k in (0, 3, 40)]
    for a, b in zip(tix.pack_bit_rows(ragged, n_bits),
                    jix.pack_bit_rows(ragged, n_bits)):
        np.testing.assert_array_equal(a, b)


def test_build_query_filter_matches_jax():
    rng = np.random.default_rng(3)
    masks = onehot(rng.integers(0, 4, (4, 24)))
    masks[1, [2, 9]] = 15                       # N wildcards
    masks[2, 5] = 0b0101                        # a two-code class
    masks[3] = 15                               # nothing required
    thresholds = (24, 22.5, 10, 30)             # 30 > P: unsatisfiable
    for q, n_bits in ((4, 256), (6, 64)):
        want = jix.build_query_filter(masks, thresholds, q, n_bits)
        got = tix.build_query_filter(masks, thresholds, q, n_bits)
        np.testing.assert_array_equal(got.qsig_words, want.qsig_words)
        assert (got.slacks, got.n_bits) == (want.slacks, want.n_bits)
    short = tix.build_query_filter(masks[:, :3], (3,), 4, 256)
    assert short.n_bits == jix.build_query_filter(masks[:, :3], (3,), 4,
                                                  256).n_bits


def test_selectivity_model_matches_jax():
    for k, n, p in ((-1, 10, 0.5), (5, 10, 0.5), (4, 80, 0.14),
                    (0, 80, 0.14), (30, 20, 0.3), (3, 9, 0.0)):
        assert tix.binom_cdf(k, n, p) == jix.binom_cdf(k, n, p)
    for args in ((500, 4, 256), (120, 4, 64), (3, 4, 256)):
        assert tix.expected_density(*args) == jix.expected_density(*args)
    for args in ((80, 4, 0.86), (20, -1, 0.5), (0, 0, 0.3)):
        assert tix.pass_probability(*args) == jix.pass_probability(*args)


# -- the filter kernel's plain version against the Pallas kernel -------------

@pytest.mark.parametrize("wb", [1, 8, 16])
def test_filter_qgram_plain_matches_pallas(wb):
    import jax.numpy as jnp
    rng = np.random.default_rng(wb)
    sigs = rng.integers(0, 2**32, (256, wb), dtype=np.uint32)
    # Dense rows (few absent bits) next to random ones.
    sigs[128:] |= rng.integers(0, 2**32, (128, wb), dtype=np.uint32)
    qsig = rng.integers(0, 2**32, (1, wb), dtype=np.uint32)
    ts, tq = convert.swar_words_from_numpy(sigs, "cpu"), \
        convert.swar_words_from_numpy(qsig, "cpu")
    # The port clamps a slack beyond int32 (same flags: counts <= 32 Wb).
    for slack in (-1, 0, 3, 17, wb * 32, 10 ** 12):
        want = np.asarray(jfq.filter_qgram(
            jnp.asarray(sigs), jnp.asarray(qsig),
            slack=min(slack, 2 ** 31 - 1), interpret=True))
        got = tfq.filter_qgram(ts, tq, slack=slack)
        assert got.dtype == torch.int32 and got.shape == (256, 1)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="padded"):
        tfq.filter_qgram(ts[:100], tq, slack=0)


# -- the index and filter-then-verify in the engine ---------------------------

@pytest.fixture
def engines(data):
    frags, _ = data
    return jm.MatchEngine(frags), tm.MatchEngine(frags, device="cpu")


def test_index_density_and_estimates_match(engines, data):
    je, te = engines
    _, pats = data
    assert je.index.density() == te.index.density()       # analytic prior
    signatures_equal(je.index, te.index)
    assert abs(je.index.density() - te.index.density()) <= 1e-12
    ops = tix.build_query_filter(onehot(pats), (P - 1, P, P - 2), 4, 256)
    for cal in (True, False):
        assert abs(je.index.estimate_survivor_frac(
            ops.n_bits, ops.slacks, calibrated=cal)
            - te.index.estimate_survivor_frac(
                ops.n_bits, ops.slacks, calibrated=cal)) <= 1e-12
    assert je.index.stats() == te.index.stats()


@pytest.mark.parametrize("backend", ["swar", "ref"])
def test_filtered_threshold_queries(engines, data, backend):
    je, te = engines
    _, pats = data
    cases = [(onehot(pats[0]), {}),                        # single
             (onehot(pats), {"mode": "batched"}),          # batched
             (onehot(pats), {"mode": "batched",
                             "threshold": (P - 1, P, P - 2)})]
    for masks, kw in cases:
        spec = dict(reduction="threshold", threshold=P - 1,
                    backend=backend) | kw
        rj, rt = run_both(engines, masks, filter=True, **spec)
        assert rt.plan.strategy == "filter"
        assert 0 < len(rt.survivor_rows) < R
        scan = te.compile(tm.MatchQuery.from_masks(
            masks, filter=False, **spec)).run()
        assert scan.plan.strategy == "scan" and scan.survivor_rows is None
        np.testing.assert_array_equal(rt.hits, scan.hits)
        assert rt.hits.shape[0] > 0
    for c in INDEX_COUNTERS:
        assert getattr(je.index, c) == getattr(te.index, c), c
    assert je.index.stats() == te.index.stats()


def test_filter_with_wildcards_tombstones_and_no_survivors(engines, data):
    je, te = engines
    frags, pats = data
    iupac = onehot(pats[1])
    iupac[[4, 20]] = 15
    run_both(engines, iupac, reduction="threshold", threshold=P - 1,
             filter=True)
    for c in (je.corpus, te.corpus):
        c.tombstone([PLANTED[1], 9])
    _, rt = run_both(engines, onehot(pats), mode="batched",
                     reduction="threshold", threshold=P - 1, filter=True)
    assert PLANTED[1] not in rt.survivor_rows
    absent = onehot(np.random.default_rng(99).integers(0, 4, P))
    _, rt = run_both(engines, absent, reduction="threshold", threshold=P,
                     filter=True)
    assert rt.survivor_frac == 0.0 and rt.hits.shape == (0, 3)


def test_index_maintenance_through_growth_and_compaction(data):
    frags, pats = data
    jc = jm.PackedCorpus(frags[:100], capacity=120)
    tc = tm.PackedCorpus(frags[:100], capacity=120, device="cpu")
    engines = (jm.MatchEngine(jc), tm.MatchEngine(tc))
    masks = onehot(pats)
    spec = dict(mode="batched", reduction="threshold", threshold=P - 1,
                filter=True)
    run_both(engines, masks, **spec)
    steps = [("append_rows", (frags[100:110],)),          # within capacity
             ("append_rows", (frags[110:180],)),          # grows capacity
             ("set_rows", (5, frags[150:152])),           # planted rows
             ("reserve", (400,)),
             ("tombstone", ([0, 5, 77, 120],)),
             ("compact", ()),
             ("append_rows", (frags[180:],))]
    for name, args in steps:
        for c in (jc, tc):
            getattr(c, name)(*args)
        signatures_equal(engines[0].index, engines[1].index)
        _, rt = run_both(engines, masks, **spec)
        assert rt.hits.shape[0] > 0
    assert tc.host_pack_count == 1 and engines[1].index.sig_pack_count == 1


def test_engines_share_one_index_and_detach_stops_updates(data):
    frags, _ = data
    corpus = tm.PackedCorpus(frags[:50], device="cpu")
    a, b = tm.MatchEngine(corpus), tm.MatchEngine(corpus)
    assert a.index is b.index and corpus._indexes == [a.index]
    a.index.signatures()
    corpus.detach_index(a.index)
    corpus.set_rows(0, frags[60])
    assert a.index.row_update_count == 0
    own = tm.CorpusIndex(corpus, q=3, n_bits=64)
    assert tm.MatchEngine(corpus, index=own).index is own
    corpus.invalidate()
    assert own._sigs is None


def test_plan_geometry_with_forced_strategy():
    ctx_kw = dict(sig_words=8, n_queries=3, prunable=True,
                  survivor_frac=0.0123)
    for force in (True, False):
        for backend in ("swar", "mxu", "ref"):
            kw = dict(n_rows=620_839, fragment_chars=500, pattern_chars=100,
                      n_patterns=3, backend=backend, predicate="exact")
            pj = jpl.Planner().plan(
                filter_ctx=jpl.FilterContext(force=force, **ctx_kw), **kw)
            pt = tpl.Planner().plan(
                filter_ctx=tpl.FilterContext(force=force, **ctx_kw), **kw)
            fields = GEOMETRY if force else GEOMETRY[:15] + ("n_shards",)
            for g in fields:
                assert getattr(pj, g) == getattr(pt, g), (g, backend)
            if force:
                assert pt.strategy == "filter" and pt.filter_words == 8
    assert [f.name for f in dataclasses.fields(jpl.Plan)] == \
        [f.name for f in dataclasses.fields(tpl.Plan)]
    assert [f.name for f in dataclasses.fields(jpl.FilterContext)] == \
        [f.name for f in dataclasses.fields(tpl.FilterContext)]
