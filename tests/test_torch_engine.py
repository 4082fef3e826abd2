"""Engine parity: the PyTorch port against the JAX package's engine.

The same fragments and queries (made with numpy from a seed) go through
``repro.match.MatchEngine(..., index=False)`` on the CPU (Pallas in
interpret mode) and ``repro_torch.match.MatchEngine(..., device="cpu")``
(the kernels' plain versions).  Integer results must be bit-identical,
with the JAX dtypes: scores, best locations and scores, top-k rows and
order, hits, pack counters and chunk counts; ``Plan`` geometry must be
equal for a forced backend.
"""

import itertools

import numpy as np
import pytest

import repro.match as jm
import repro_torch.match as tm
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

R, F, P, Q = 20, 40, 12, 3
CHUNK = 8                        # R_pad = 24 -> three chunks
THRESHOLD, K = 6, 4
GEOMETRY = ("backend", "mode", "n_rows", "fragment_chars", "pattern_chars",
            "n_patterns", "n_locs", "wp", "need_words", "l_pad",
            "p_chars_pad", "q_pad", "f_chars", "chunk_rows", "predicate",
            "strategy", "n_shards")
RESULT_ARRAYS = ("best_locs", "best_scores", "scores", "topk_rows",
                 "topk_scores", "hits")
CORPUS_COUNTERS = ("swar_pack_count", "onehot_pack_count",
                   "row_update_count", "n_rows", "capacity", "n_dead",
                   "n_compactions")


def assert_same(rj, rt):
    for f in RESULT_ARRAYS:
        a, b = getattr(rj, f), getattr(rt, f)
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        assert isinstance(b, np.ndarray), f
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert rj.n_chunks == rt.n_chunks
    for g in GEOMETRY:
        assert getattr(rj.plan, g) == getattr(rt.plan, g), g


def assert_same_counters(cj, ct):
    for c in CORPUS_COUNTERS:
        assert getattr(cj, c) == getattr(ct, c), c


def run_both(engines, masks, **spec):
    je, te = engines
    qj = jm.MatchQuery.from_masks(masks, **spec)
    qt = tm.MatchQuery.from_masks(masks, **spec)
    rj, rt = je.compile(qj).run(), te.compile(qt).run()
    assert_same(rj, rt)
    return rj, rt


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    frags = rng.integers(0, 4, (R, F), np.uint8)

    def onehot(codes):
        return (np.uint8(1) << codes).astype(np.uint8)

    def widen(masks):
        # N wildcards and R/Y-style two-code classes at a few positions.
        m = masks.copy()
        m[..., 1] = 15
        m[..., 4] |= np.uint8(1) << ((np.log2(m[..., 4]).astype(np.uint8)
                                      + 2) % 4)
        return m

    shared = onehot(frags[3, 5:5 + P])
    batched = onehot(rng.integers(0, 4, (Q, P), np.uint8))
    batched[1] = onehot(frags[17, 20:20 + P])
    per_row = onehot(rng.integers(0, 4, (R, P), np.uint8))
    per_row[6] = onehot(frags[6, 2:2 + P])
    pats = {"shared": shared, "batched": batched, "per_row": per_row}
    return frags, {("exact", m): p for m, p in pats.items()} | {
        ("accept", m): widen(p) for m, p in pats.items()}


@pytest.fixture(scope="module")
def engines(data):
    frags, _ = data
    return (jm.MatchEngine(frags, index=False),
            tm.MatchEngine(frags, device="cpu"))


MATRIX = [c for c in itertools.product(
    ("swar", "mxu", "ref"), ("best", "topk", "threshold", "full"),
    ("shared", "per_row", "batched"), ("exact", "accept"))
    if not (c[0] == "mxu" and c[2] == "per_row")]


@pytest.mark.parametrize("backend,reduction,mode,predicate", MATRIX)
def test_matrix(engines, data, backend, reduction, mode, predicate):
    _, pats = data
    spec = dict(backend=backend, reduction=reduction, chunk_rows=CHUNK,
                threshold=THRESHOLD, k=K)
    if mode != "shared":
        spec["mode"] = mode
    rj, rt = run_both(engines, pats[predicate, mode], **spec)
    assert rt.plan.predicate == predicate and rt.n_chunks == 3
    if reduction == "threshold":
        assert rt.hits.shape[0] > 0


@pytest.mark.parametrize("reduction,mode", itertools.product(
    ("best", "topk", "threshold", "full"), ("shared", "batched")))
def test_mxu_reduction_picks_kernel(engines, data, monkeypatch, reduction,
                                    mode):
    """best and top-k reduce in ``match_mxu_best``'s epilogue, one call per
    chunk; threshold and full take the full score block of ``match_mxu``.
    Results stay equal to the JAX engine's either way."""
    from repro_torch.kernels import match_mxu as tmx
    calls = {"match_mxu": 0, "match_mxu_best": 0}
    for name in calls:
        def spy(*a, _name=name, _fn=getattr(tmx, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tmx, name, spy)
    spec = dict(backend="mxu", reduction=reduction, chunk_rows=CHUNK,
                threshold=THRESHOLD, k=K)
    if mode != "shared":
        spec["mode"] = mode
    _, rt = run_both(engines, data[1]["exact", mode], **spec)
    fused = reduction in ("best", "topk")
    assert calls == {"match_mxu": 0 if fused else rt.n_chunks,
                     "match_mxu_best": rt.n_chunks if fused else 0}


SWAR_KERNELS = ("match_swar", "match_swar_best", "match_swar_masks")


@pytest.mark.parametrize("predicate,reduction,mode", [
    *itertools.product(("exact",), ("best", "topk", "threshold", "full"),
                       ("shared", "batched", "per_row")),
    ("accept", "best", "shared")])
def test_swar_reduction_picks_kernel(engines, data, monkeypatch, predicate,
                                     reduction, mode):
    """Exact best and top-k reduce in ``match_swar_best``'s epilogue, one
    call per chunk in every mode; threshold, full and the accept predicate
    take the full score block.  Results stay equal to the JAX engine's."""
    from repro_torch.kernels import match_swar as tsw
    calls = dict.fromkeys(SWAR_KERNELS, 0)
    for name in calls:
        def spy(*a, _name=name, _fn=getattr(tsw, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tsw, name, spy)
    spec = dict(backend="swar", reduction=reduction, chunk_rows=CHUNK,
                threshold=THRESHOLD, k=K)
    if mode != "shared":
        spec["mode"] = mode
    _, rt = run_both(engines, data[1][predicate, mode], **spec)
    want = dict.fromkeys(SWAR_KERNELS, 0)
    if predicate == "accept":
        want["match_swar_masks"] = rt.n_chunks
    elif reduction in ("best", "topk"):
        want["match_swar_best"] = rt.n_chunks
    else:
        want["match_swar"] = rt.n_chunks
    assert calls == want


@pytest.mark.parametrize("backend", ("swar", "mxu", "ref"))
def test_batched_per_query_k_and_thresholds(engines, data, backend):
    _, pats = data
    run_both(engines, pats["accept", "batched"], mode="batched",
             backend=backend, reduction="topk", k=(1, 3, 5))
    run_both(engines, pats["exact", "batched"], mode="batched",
             backend=backend, reduction="threshold",
             threshold=(5, 6.5, 7))


@pytest.mark.parametrize("backend,reduction", itertools.product(
    ("swar", "mxu", "ref"), ("best", "topk", "threshold", "full")))
def test_row_subsets(engines, data, backend, reduction):
    _, pats = data
    rows = [17, 2, 9, 11, 0, 5, 13, 19, 4]
    run_both(engines, pats["exact", "shared"], backend=backend,
             reduction=reduction, rows=rows, chunk_rows=CHUNK,
             threshold=THRESHOLD, k=K)
    run_both(engines, pats["accept", "shared"], backend=backend,
             reduction=reduction, rows=[], threshold=THRESHOLD, k=K)


def test_auto_backend_geometry_and_tied_scores(engines):
    # A one-position pattern ties at many alignments: best_locs must be
    # the first maximal index on both sides (jnp.argmax / torch.argmax),
    # and top-k must break score ties by ascending row.
    for reduction in ("best", "topk"):
        run_both(engines, np.array([1], np.uint8), reduction=reduction,
                 k=7, backend="swar")
    je, te = engines
    for kw in ({}, {"backend": "mxu"}, {"backend": "ref"}):
        pj = je.plan(np.zeros(P, np.uint8), **kw)
        pt = te.plan(np.zeros(P, np.uint8), **kw)
        for g in GEOMETRY[1:]:
            assert getattr(pj, g) == getattr(pt, g), g


@pytest.mark.parametrize("backend", ("swar", "mxu", "ref"))
def test_growth_keeps_pack_counters_flat(data, backend):
    frags, pats = data
    je = jm.MatchEngine(jm.PackedCorpus(frags[:10], capacity=12),
                        index=False)
    te = tm.MatchEngine(tm.PackedCorpus(frags[:10], capacity=12,
                                        device="cpu"))
    spec = dict(backend=backend, reduction="topk", k=K, chunk_rows=CHUNK)
    qj = jm.MatchQuery.from_masks(pats["exact", "shared"], **spec)
    qt = tm.MatchQuery.from_masks(pats["exact", "shared"], **spec)
    cj, ct = je.compile(qj), te.compile(qt)
    assert_same(cj.run(), ct.run())
    for lo, hi in ((10, 11), (11, 16), (16, 20)):   # second grows capacity
        assert je.corpus.append_rows(frags[lo:hi]) == \
            te.corpus.append_rows(frags[lo:hi])
        assert_same(cj.run(), ct.run())
        assert_same_counters(je.corpus, te.corpus)
    je.corpus.set_rows(3, frags[19])
    te.corpus.set_rows(3, frags[19])
    assert_same(cj.run(), ct.run())
    assert_same_counters(je.corpus, te.corpus)
    assert te.corpus.host_pack_count == (0 if backend == "ref" else 1)


@pytest.mark.parametrize("backend", ("swar", "mxu", "ref"))
def test_tombstone_then_compact(data, backend):
    frags, pats = data
    je = jm.MatchEngine(frags, index=False)
    te = tm.MatchEngine(frags, device="cpu")
    for reduction in ("best", "topk", "threshold", "full"):
        run_both((je, te), pats["accept", "shared"], backend=backend,
                 reduction=reduction, threshold=THRESHOLD, k=K,
                 chunk_rows=CHUNK)
    for c in (je.corpus, te.corpus):
        assert c.tombstone([1, 5, 6, 19]) == 4
    for reduction in ("best", "topk", "threshold", "full"):
        run_both((je, te), pats["accept", "shared"], backend=backend,
                 reduction=reduction, threshold=THRESHOLD, k=K,
                 chunk_rows=CHUNK)
    assert_same_counters(je.corpus, te.corpus)
    assert je.corpus.compact() == te.corpus.compact() == 4
    assert_same_counters(je.corpus, te.corpus)
    for reduction in ("best", "topk", "threshold", "full"):
        run_both((je, te), pats["exact", "shared"], backend=backend,
                 reduction=reduction, threshold=THRESHOLD, k=K,
                 chunk_rows=CHUNK)


@pytest.mark.parametrize("batched", [False, True])
def test_merger_primitives_match(batched):
    """Chunk reductions on scores full of ties, and the top-k merge across
    chunks with dead rows, equal the JAX ShardMerger's."""
    import jax.numpy as jnp
    import torch
    from repro.match.merge import ShardMerger as JMerger
    from repro_torch.match.merge import ShardMerger as TMerger
    rng = np.random.default_rng(8)
    shape = (16, 9, 3) if batched else (16, 9)
    jmg, tmg = JMerger(None, None, 1), TMerger()
    thr = np.array([3, 4, 2] if batched else [3], np.int32)
    k, n_cols = 5, 3 if batched else 0
    js, ts = jmg.topk_init(k, n_cols), tmg.topk_init(k, n_cols, "cpu")
    for c in range(3):
        s = rng.integers(-1, 5, shape).astype(np.int32)
        js_, ts_ = jnp.asarray(s), torch.from_numpy(s)
        for a, b in zip(jmg.chunk_best(js_), tmg.chunk_best(ts_)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(jmg.hot_mask(js_, thr)),
                                      tmg.hot_mask(ts_, thr).numpy())
        idx = np.array([3, 0, 15, 3, 0, 0, 0, 0])
        np.testing.assert_array_equal(np.asarray(jmg.gather_rows(js_, idx)),
                                      tmg.gather_rows(ts_, idx).numpy())
        f = s[:, 0] > 1
        np.testing.assert_array_equal(
            np.asarray(jmg.or_(jnp.asarray(f), jnp.asarray(~f))),
            tmg.or_(torch.from_numpy(f), torch.from_numpy(~f)).numpy())
        alive = rng.random(16) > 0.2
        rows = np.arange(16) + 16 * c
        js = jmg.topk_update(js, jmg.chunk_best(js_)[1], phys=False,
                             alive_chunk=alive, rows_np=rows)
        ts = tmg.topk_update(ts, tmg.chunk_best(ts_)[1], alive_chunk=alive,
                             rows_np=rows)
    for a, b in zip(jmg.topk_finalize(js, 40, k),
                    tmg.topk_finalize(ts, 40, k)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_corpus_carried_across_with_convert(data):
    from repro_torch import convert
    frags, pats = data
    jc = jm.PackedCorpus(frags, capacity=32)
    jc.tombstone([2, 7])
    tc = convert.corpus_from_numpy(np.asarray(jc.fragments),
                                   capacity=jc.capacity,
                                   dead_mask=jc.dead_mask, device="cpu")
    assert (tc.capacity, tc.n_dead, tc.n_rows) == (32, 2, R)
    np.testing.assert_array_equal(tc.dead_mask, jc.dead_mask)
    je, te = jm.MatchEngine(jc, index=False), tm.MatchEngine(tc)
    run_both((je, te), pats["exact", "shared"], backend="swar",
             reduction="topk", k=K)
    # The resident forms themselves carry across bit for bit.
    np.testing.assert_array_equal(
        np.asarray(jc.swar_words(6)).view(np.int32),
        tc.swar_words(6).numpy())
    np.testing.assert_array_equal(
        np.asarray(jc.onehot_flat(64), np.float32),
        tc.onehot_flat(64).float().numpy())


def test_match_scores_shim(data):
    frags, pats = data
    for backend in (None, "swar", "mxu", "ref"):
        want = jops.match_scores(frags, frags[8, :P], backend=backend)
        got = tops.match_scores(frags, frags[8, :P], backend=backend,
                                device="cpu")
        np.testing.assert_array_equal(np.asarray(want), got)


def test_slice_end_to_end_on_a_folded_reference():
    """The slice's queries (a)-(d) at a small size: a seeded random
    reference folded 500/100, reads taken at known rows and locs."""
    from repro_torch.core import encoding as tenc
    rng = np.random.default_rng(5)
    frag, read, step = 120, 24, 97
    ref = tenc.random_dna(rng, 3000)
    jc = jm.PackedCorpus.from_reference(ref, frag, read)
    tc = tm.PackedCorpus.from_reference(ref, frag, read, device="cpu")
    np.testing.assert_array_equal(jc.fragments, tc.fragments)
    engines = (jm.MatchEngine(jc, index=False), tm.MatchEngine(tc))
    rows = rng.choice(tc.n_rows - 1, 6, replace=False)
    locs = rng.integers(0, frag - read + 1, 6)
    reads = np.stack([ref[r * step + lo:r * step + lo + read]
                      for r, lo in zip(rows, locs)])
    onehot = (np.uint8(1) << reads).astype(np.uint8)
    iupac = onehot[1].copy()
    iupac[[2, 9, 15]] = 15
    _, ra = run_both(engines, onehot[0], reduction="best", backend="swar")
    assert ra.best_scores[rows[0]] == read
    assert ra.best_locs[rows[0]] == locs[0]
    _, rb = run_both(engines, iupac, reduction="threshold",
                     threshold=read - 1, backend="swar")
    assert [rows[1], locs[1], read] in rb.hits.tolist()
    mutated = onehot[2:].copy()
    mutated[1, 3] = 15 - mutated[1, 3]          # no longer accepts the read
    _, rc = run_both(engines, mutated, mode="batched", reduction="topk",
                     k=3, backend="mxu")
    np.testing.assert_array_equal(rc.topk_rows[0], rows[2:])
    np.testing.assert_array_equal(rc.topk_scores[0], [read, read - 1,
                                                      read, read])
    run_both(engines, onehot[0], reduction="best")
