"""Row-sharded match stack: the port's S-shard engine against one shard.

Counterparts of every case of ``tests/test_match_shard.py``.  The same
numpy fragments and queries go through three engines:

* ``repro_torch.match.MatchEngine`` on a row mesh of S CPU devices
  (``make_row_mesh(S, devices=["cpu"] * S)``);
* the port's one-shard engine (``device="cpu"``);
* the JAX package's one-shard engine (``repro.match.engine.MatchEngine``
  with no mesh, Pallas in interpret mode), which the reference's own
  shard tests hold equal to its S-shard engine.

Every result field (scores, best locations and scores, top-k rows and
scores, hits, survivor sets) must be bit-identical across the three.
From the reference's S-shard engine only what needs no sharded run is
taken: its ``Plan`` (geometry must match wherever the backends agree),
``n_shards``, ``shard_live_rows`` and the ``resolve_axis`` warning.

The ``gpu`` case (S = 4 on ``cuda:0`` against one shard) needs no JAX:
the card's machine has none, so the reference imports only where it is
installed.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro_torch.match as tm
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch.mesh import RowMesh, make_row_mesh

try:
    import jax
    import repro.match as jm
    from repro.distributed import sharding as jsharding
except ImportError:          # the card's machine: only the gpu case runs
    jax = jm = jsharding = None

GEOMETRY = ("backend", "mode", "n_rows", "fragment_chars", "pattern_chars",
            "n_patterns", "n_locs", "wp", "need_words", "l_pad",
            "p_chars_pad", "q_pad", "f_chars", "chunk_rows", "predicate",
            "strategy", "n_shards")
# Geometry that does not depend on the backend the planner picks (the
# H100 and TPU rooflines may pick differently; ROADMAP Queue 3).
SHAPE_GEOMETRY = tuple(g for g in GEOMETRY
                       if g not in ("backend", "chunk_rows"))
RESULT_FIELDS = ("scores", "best_locs", "best_scores", "topk_rows",
                 "topk_scores", "hits")


def cpu_mesh(n_shards: int) -> RowMesh:
    return make_row_mesh(n_shards, devices=["cpu"] * n_shards)


def jax_row_mesh(n_shards: int):
    if len(jax.devices()) < n_shards:
        pytest.skip(f"needs >= {n_shards} devices "
                    "(forced host devices; see tests/conftest.py)")
    from repro.launch.mesh import make_row_mesh as jax_make_row_mesh
    return jax_make_row_mesh(n_shards)


def corpus(n_rows: int, seed: int, chars: int = 64):
    """The reference's ``corpus``: seeded rows, a 16-char pattern planted
    at three rows."""
    rng = np.random.default_rng(seed)
    frags = rng.integers(0, 4, (n_rows, chars), np.uint8)
    pat = frags[n_rows // 3, 10:26].copy()
    for r in (0, n_rows // 2, n_rows - 1):
        frags[r, 20:36] = pat
    return frags, pat


@dataclasses.dataclass
class Trio:
    """Port S-shard, port one-shard, JAX one-shard (+ JAX S-shard, for
    plans and layout only)."""

    ts: tm.MatchEngine
    t1: tm.MatchEngine
    j1: jm.MatchEngine
    js: jm.MatchEngine


def trio(frags: np.ndarray, n_shards: int, **kw) -> Trio:
    t = Trio(ts=tm.MatchEngine(frags.copy(), mesh=cpu_mesh(n_shards), **kw),
             t1=tm.MatchEngine(frags.copy(), device="cpu", **kw),
             j1=jm.MatchEngine(frags.copy(), **kw),
             js=jm.MatchEngine(frags.copy(), mesh=jax_row_mesh(n_shards),
                               **kw))
    assert t.ts.n_shards == t.js.n_shards == n_shards
    assert t.t1.n_shards == t.j1.n_shards == 1
    return t


def assert_result_equal(want, got):
    for f in RESULT_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)


def assert_plan_matches(jplan, tplan):
    """The port's S-shard plan against the reference's: every geometry
    field where the backends agree, the backend-free ones otherwise."""
    fields = GEOMETRY if jplan.backend == tplan.backend else SHAPE_GEOMETRY
    for g in fields:
        assert getattr(jplan, g) == getattr(tplan, g), g


def run(t: Trio, spec: dict, masks=None, *, exact=None):
    """One query through the three engines (and planned on the JAX
    S-shard one); returns the port S-shard result."""
    def query(mod):
        if exact is not None:
            return mod.MatchQuery.exact(exact, **spec)
        return mod.MatchQuery.from_masks(masks, **spec)
    rs = t.ts.compile(query(tm)).run()
    for want in (t.t1.compile(query(tm)).run(),
                 t.j1.compile(query(jm)).run()):
        assert_result_equal(want, rs)
        if want.survivor_rows is not None or rs.survivor_rows is not None:
            np.testing.assert_array_equal(want.survivor_rows,
                                          rs.survivor_rows)
    assert_plan_matches(t.js.compile(query(jm), cached=False).plan, rs.plan)
    assert rs.n_shards == t.ts.n_shards
    assert rs.merge_path == "device"
    return rs


class TestCyclicLayout:
    """The layout helpers are each other's inverses, match the map
    r -> (r % S) * J + r // S, and equal the reference's on numpy and
    torch inputs."""

    @pytest.mark.parametrize("kind", ["numpy", "torch"])
    def test_permute_roundtrip(self, kind):
        rng = np.random.default_rng(0)
        a = rng.integers(0, 100, (24, 3))
        x = torch.from_numpy(a) if kind == "torch" else a
        for s in (1, 2, 4, 8):
            p = tsharding.cyclic_permute(x, s)
            np.testing.assert_array_equal(np.asarray(p),
                                          jsharding.cyclic_permute(a, s))
            np.testing.assert_array_equal(
                np.asarray(tsharding.cyclic_unpermute(p, s)), a)

    def test_physical_rows_match_permute(self):
        rng = np.random.default_rng(1)
        a = rng.integers(0, 100, (24,))
        for s in (2, 4):
            phys = tsharding.cyclic_physical_rows(np.arange(24), s, 24 // s)
            np.testing.assert_array_equal(
                phys, jsharding.cyclic_physical_rows(np.arange(24), s,
                                                     24 // s))
            np.testing.assert_array_equal(
                tsharding.cyclic_permute(a, s)[phys], a)
            tphys = tsharding.cyclic_physical_rows(torch.arange(24), s,
                                                   24 // s)
            np.testing.assert_array_equal(tphys.numpy(), phys)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("backend", ["swar", "mxu", "ref"])
class TestBackendEquivalence:
    def test_full_scores(self, backend, n_shards):
        frags, pat = corpus(100, seed=10)
        t = trio(frags, n_shards)
        got = t.ts.scores(pat, backend=backend)
        np.testing.assert_array_equal(t.t1.scores(pat, backend=backend), got)
        np.testing.assert_array_equal(
            np.asarray(t.j1.scores(pat, backend=backend)), got)

    def test_reductions(self, backend, n_shards):
        frags, pat = corpus(100, seed=11)
        t = trio(frags, n_shards)
        # filter=False pins the scan path, as the reference's case does.
        for spec in (dict(reduction="best", backend=backend),
                     dict(reduction="topk", k=7, backend=backend),
                     dict(reduction="threshold", threshold=14,
                          backend=backend, filter=False)):
            run(t, spec, exact=pat)

    def test_batched_coalesced(self, backend, n_shards):
        frags, pat = corpus(100, seed=12)
        rng = np.random.default_rng(13)
        pats = np.stack([pat] + [rng.integers(0, 4, 16, np.uint8)
                                 for _ in range(3)])
        t = trio(frags, n_shards)
        run(t, dict(mode="batched", reduction="topk", k=[5, 5, 5, 5],
                    backend=backend), exact=pats)


@pytest.mark.parametrize("n_shards", [2, 4])
class TestPredicatesAndSubsets:
    def test_wildcard_iupac(self, n_shards):
        frags, pat = corpus(100, seed=20)
        t = trio(frags, n_shards)
        pstr = "".join("ACGT"[c] for c in pat)
        iupac = "N" + pstr[1:8] + "R" + pstr[9:]
        masks = tm.MatchQuery.iupac(iupac).masks
        run(t, dict(reduction="best"), masks)

    def test_rows_subset_gather(self, n_shards):
        frags, pat = corpus(100, seed=21)
        t = trio(frags, n_shards)
        rows = (0, 3, 33, 50, 97, 99)
        run(t, dict(rows=rows, reduction="topk", k=4), exact=pat)
        # The gathered threshold path: each row verified on its shard,
        # hits back in subset order.
        run(t, dict(rows=rows, reduction="threshold", threshold=10,
                    backend="swar"), exact=pat)

    def test_topk_merge_is_bit_identical_on_ties(self, n_shards):
        # All-identical rows: every score ties, so the merge order is
        # decided purely by the (score desc, row asc) total order.
        frags = np.tile(np.arange(4, dtype=np.uint8), (32, 16))
        pat = frags[0, :16].copy()
        t = trio(frags, n_shards)
        for backend in ("swar", "mxu"):
            rs = run(t, dict(reduction="topk", k=9, backend=backend),
                     exact=pat)
            np.testing.assert_array_equal(rs.topk_rows, np.arange(9))


@pytest.mark.parametrize("n_shards", [2, 4])
class TestGrowth:
    def test_append_rows_equivalence_and_flat_pack_counters(self, n_shards):
        frags, pat = corpus(96, seed=30)
        t = trio(frags, n_shards)
        # Force both device forms resident before growing.
        t.ts.scores(pat, backend="swar")
        t.ts.scores(np.stack([pat, pat]), backend="mxu")
        packs = t.ts.corpus.host_pack_count
        rng = np.random.default_rng(31)
        for n in (5, 64, 300):   # in-place splice, then capacity growth
            more = rng.integers(0, 4, (n, 64), np.uint8)
            for e in (t.ts, t.t1, t.j1, t.js):
                e.corpus.append_rows(more)
            got = t.ts.scores(pat, backend="swar")
            np.testing.assert_array_equal(
                t.t1.scores(pat, backend="swar"), got)
            np.testing.assert_array_equal(
                np.asarray(t.j1.scores(pat, backend="swar")), got)
            np.testing.assert_array_equal(t.ts.shard_live_rows(),
                                          t.js.shard_live_rows())
            assert t.ts.corpus.shard_stride == t.js.corpus.shard_stride
        np.testing.assert_array_equal(
            t.t1.scores(pat, backend="mxu"), t.ts.scores(pat, backend="mxu"))
        # Growth splices rows per shard; it never repacks the resident
        # corpus.
        assert t.ts.corpus.host_pack_count == packs

    def test_compiled_rows_subset_survives_growth(self, n_shards):
        # Capacity growth changes the per-shard stride: the compiled
        # query's rows must still land on their shards and slots.
        frags, pat = corpus(96, seed=32)
        t = trio(frags, n_shards)
        cs, c1 = (e.compile(tm.MatchQuery.exact(pat, rows=[1, 40, 95],
                                                reduction="best"))
                  for e in (t.ts, t.t1))
        cj = t.j1.compile(jm.MatchQuery.exact(pat, rows=[1, 40, 95],
                                              reduction="best"))
        for want in (c1.run(), cj.run()):
            assert_result_equal(want, cs.run())
        more = np.random.default_rng(33).integers(0, 4, (500, 64), np.uint8)
        for e in (t.ts, t.t1, t.j1):
            e.corpus.append_rows(more)
        for want in (c1.run(), cj.run()):
            assert_result_equal(want, cs.run())

    def test_tombstone_compact_and_balance(self, n_shards):
        """Tombstones mask rows on every shard; ``compact()`` re-splices
        from the first dead row under the cyclic layout; the pack
        counters stay flat and the shards stay balanced."""
        frags, pat = corpus(96, seed=34)
        t = trio(frags, n_shards)
        more = np.random.default_rng(35).integers(0, 4, (77, 64), np.uint8)
        specs = (dict(reduction="topk", k=5, backend="swar"),
                 dict(reduction="best", backend="mxu"),
                 dict(reduction="threshold", threshold=13, filter=True))
        for spec in specs:
            run(t, spec, exact=pat)
        packs = (t.ts.corpus.host_pack_count, t.ts.index.sig_pack_count)
        dead = np.random.default_rng(36).choice(96 + 77, 17, replace=False)
        for e in (t.ts, t.t1, t.j1, t.js):
            e.corpus.append_rows(more)
            e.corpus.tombstone(dead)
        for spec in specs:
            run(t, spec, exact=pat)
        for e in (t.ts, t.t1, t.j1, t.js):
            assert e.corpus.compact() == 17
        for spec in specs:
            run(t, spec, exact=pat)
        assert (t.ts.corpus.host_pack_count,
                t.ts.index.sig_pack_count) == packs
        assert t.ts.index.density() == t.j1.index.density()
        live = t.ts.shard_live_rows()
        assert live.sum() == t.ts.corpus.n_rows == 96 + 77 - 17
        assert live.max() - live.min() <= 1


@pytest.mark.parametrize("n_shards", [2, 4])
class TestFilteredPath:
    def test_filtered_threshold_equivalence(self, n_shards):
        frags, pat = corpus(200, seed=40)
        t = trio(frags, n_shards)       # index auto-attached
        rs = run(t, dict(reduction="threshold", threshold=14, filter=True),
                 exact=pat)
        assert rs.plan.strategy == "filter", rs.plan.reason
        # The cross-shard density sum equals the one-shard host means.
        assert t.ts.index._bits_dev is not None
        assert (t.ts.index.density() == t.t1.index.density()
                == t.j1.index.density())

    def test_sharded_filter_zero_false_negatives(self, n_shards):
        # Survivor union vs. exhaustive scan: identical hit sets, with
        # wildcards and after growth.
        frags, pat = corpus(200, seed=41)
        ts = tm.MatchEngine(frags.copy(), mesh=cpu_mesh(n_shards))
        j1 = jm.MatchEngine(frags.copy())
        more = np.random.default_rng(42).integers(0, 4, (100, 64), np.uint8)
        more[7, 5:21] = pat
        ts.corpus.append_rows(more)
        j1.corpus.append_rows(more)
        pstr = "".join("ACGT"[c] for c in pat)
        for spec in (dict(reduction="threshold", threshold=13),
                     dict(reduction="threshold", threshold=13,
                          masks=tm.MatchQuery.iupac("N" + pstr[1:]).masks)):
            masks = spec.pop("masks", None)

            def q(mod, filt):
                if masks is None:
                    return mod.MatchQuery.exact(pat, filter=filt, **spec)
                return mod.MatchQuery.from_masks(masks, filter=filt, **spec)
            filt = ts.match(q(tm, True))
            scan = ts.match(q(tm, False))
            assert scan.plan.strategy == "scan"
            np.testing.assert_array_equal(filt.hits, scan.hits)
            np.testing.assert_array_equal(j1.match(q(jm, False)).hits,
                                          filt.hits)

    def test_sharded_filter_true_never_silent_scans(self, n_shards):
        # A sharded engine must filter or raise a named error -- never
        # drop filter=True to a full scan silently.
        frags, pat = corpus(200, seed=43)
        ts = tm.MatchEngine(frags.copy(), mesh=cpu_mesh(n_shards))
        r = ts.match(tm.MatchQuery.exact(pat, reduction="threshold",
                                         threshold=14, filter=True))
        assert r.plan.strategy == "filter", r.plan.reason
        assert r.survivor_frac is not None
        ts2 = tm.MatchEngine(frags.copy(), mesh=cpu_mesh(n_shards),
                             index=False)
        with pytest.raises(ValueError, match="cannot honor filter=True"):
            ts2.match(tm.MatchQuery.exact(pat, reduction="threshold",
                                          threshold=14, filter=True))


class TestSurfacing:
    def test_resolve_axis_warns_on_fallback(self):
        def build(mod, mesh):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                eng = mod.MatchEngine(np.zeros((10, 64), np.uint8),
                                      mesh=mesh)
            return eng, [str(w.message) for w in rec
                         if issubclass(w.category, UserWarning)
                         and "logical axis" in str(w.message)]
        te, tmsgs = build(tm, cpu_mesh(3))
        je, jmsgs = build(jm, jax_row_mesh(3))
        assert te.n_shards == je.n_shards == 1
        assert any("rows" in m and "replication" in m for m in tmsgs), tmsgs
        assert tmsgs == jmsgs

    def test_repr_and_result_surface_shards(self):
        frags, pat = corpus(64, seed=50)
        es = tm.MatchEngine(frags, mesh=cpu_mesh(2))
        assert "shards=2" in repr(es)
        assert es.match(pat).n_shards == 2
        e1 = tm.MatchEngine(frags.copy(), device="cpu")
        assert e1.match(pat).n_shards == 1
        assert e1.match(pat).merge_path == "host"

    def test_service_reports_per_shard_rows(self):
        frags, pat = corpus(64, seed=51)
        es = tm.MatchEngine(frags, mesh=cpu_mesh(4))
        js = jm.MatchEngine(frags.copy(), mesh=jax_row_mesh(4))
        svc = tm.MatchService(es)
        rng = np.random.default_rng(52)
        for i in range(10):
            rows = rng.integers(0, 4, (1 + i % 3, 64), np.uint8)
            svc.ingest(rows)
            js.corpus.append_rows(rows)
        svc.submit(pat, reduction="best")
        svc.flush()
        snap = svc.stats.snapshot()
        assert snap["n_shards"] == 4
        assert snap["merge_path"] == "device"
        assert snap["collective_bytes"] > 0
        assert sum(snap["shard_rows"]) == es.corpus.n_rows
        assert snap["shard_balance"] <= 1.1
        # Cyclic placement: shard s holds ceil((n - s) / S) rows exactly,
        # as the reference's layout places them.
        np.testing.assert_array_equal(snap["shard_rows"],
                                      es.shard_live_rows())
        np.testing.assert_array_equal(es.shard_live_rows(),
                                      js.shard_live_rows())


class TestRules:
    """``resolve_axis`` on the port's row mesh and on meshes of other
    axes, against the reference's (the ``TestRules`` cases of
    ``tests/test_sharding.py`` that reach ``resolve_axis``)."""

    @dataclasses.dataclass
    class FakeMesh:
        axis_names: tuple
        shape: dict

    @pytest.mark.parametrize("name, dim, axes, rules, want", [
        ("rows", 64, {"data": 2}, None, "data"),          # divisible
        ("rows", 3, {"data": 2}, None, None),             # replicated
        ("vocab", 64, {"data": 2}, None, None),           # axis absent
        ("rows", 64, {"data": 4}, "fsdp", "data"),        # fsdp rows
        ("batch", 8, {"pod": 2, "data": 2, "model": 2}, None,
         ("pod", "data")),                                # composite
        ("batch", 2, {"pod": 2, "data": 2, "model": 2}, None,
         "data"),                                         # partial
        ("rows", 8, {"data": 1}, None, None),             # one shard
        (None, 8, {"data": 2}, None, None),               # unnamed dim
    ])
    def test_resolve_axis_matches_reference(self, name, dim, axes, rules,
                                            want):
        mesh = self.FakeMesh(tuple(axes), dict(axes))
        tr = tsharding.RULE_PROFILES[rules] if rules else None
        jr = jsharding.RULE_PROFILES[rules] if rules else None
        with warnings.catch_warnings(record=True) as trec:
            warnings.simplefilter("always")
            got = tsharding.resolve_axis(name, dim, mesh, tr, warn=True)
        with warnings.catch_warnings(record=True) as jrec:
            warnings.simplefilter("always")
            ref = jsharding.resolve_axis(name, dim, mesh, jr, warn=True)
        assert got == ref == want
        assert ([str(w.message) for w in trec]
                == [str(w.message) for w in jrec])

    def test_row_mesh_reads_like_a_jax_mesh(self):
        tmesh = cpu_mesh(4)
        jmesh = jax_row_mesh(4)
        assert tmesh.axis_names == jmesh.axis_names
        assert dict(tmesh.shape) == dict(jmesh.shape)
        assert tsharding.resolve_axis("rows", 64, tmesh) == \
            jsharding.resolve_axis("rows", 64, jmesh) == "data"
        assert tsharding.LOGICAL_RULES == jsharding.LOGICAL_RULES
        assert tsharding.FSDP_RULES == jsharding.FSDP_RULES


def test_span_lint_counts_the_per_shard_launch_sites():
    """The per-shard launches are dispatch sites of the span lint, and
    every one of them runs under a span."""
    from repro_torch.obs import lint_spans
    root = lint_spans.REPO
    path = root / "src" / "repro_torch" / "match" / "engine.py"
    tree = lint_spans._parse(path)
    aliases, names = lint_spans._kernel_imports(tree)
    v = lint_spans._Visitor(str(path), aliases, names,
                            lint_spans.dispatching_kernel_functions(
                                root / "src" / "repro_torch" / "kernels"))
    v.visit(tree)
    where = {(s.func_stack[-1], s.callee) for s in v.sites}
    assert {("_launch_scores", "match_swar"),
            ("_launch_scores", "match_swar_masks"),
            ("_launch_scores", "match_mxu"),
            ("_launch_best", "match_mxu_best"),
            ("_launch_best", "match_swar_best"),
            ("_run_filter", "filter_qgram")} <= where
    assert lint_spans.main(root) == 0


@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_geometry_at_chr1_size_matches_the_reference(n_shards):
    """At chr1 size (620,839 x 500, 100-char reads) the S-shard plan's
    geometry equals the reference's for every batch up to 128 wherever
    the backends agree, and they differ only in the one-shard bands
    (exact Q = 32-39, accept-set Q = 13-15: SWAR here, the matrix unit
    there; ROADMAP Queue 3)."""
    bands = {"exact": range(32, 40), "accept": range(13, 16)}
    for predicate in ("exact", "accept"):
        for Q in range(1, 129):
            kw = dict(n_rows=620_839, fragment_chars=500, pattern_chars=100,
                      n_patterns=Q if Q > 1 else None, predicate=predicate,
                      n_shards=n_shards, reduction="topk", topk_k=10)
            a, b = jm.Planner().plan(**kw), tm.Planner().plan(**kw)
            if Q in bands[predicate]:
                assert (a.backend, b.backend) == ("mxu", "swar"), (Q, kw)
            assert_plan_matches(a, b)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_batch_prices_shards_as_the_reference(n_shards):
    """``plan_batch`` with shards: the per-shard geometry equals the
    reference's, and the merge is priced on top."""
    kw = dict(n_rows=620_839, fragment_chars=500, pattern_chars=100,
              n_queries=8, backend="mxu", n_shards=n_shards)
    a = jm.Planner().plan_batch(**kw)
    b = tm.Planner().plan_batch(**kw)
    assert a.coalesced == b.coalesced
    assert_plan_matches(a.plan, b.plan)
    assert b.plan.n_shards == n_shards
    assert "priced per shard" in b.plan.reason


def rehearse_phase_12(monkeypatch, keep=None):
    """``chip_smoke.py``'s phase 12 (``shard_phase``) at a small size on
    CPU devices, with counting wrappers over the kernels it launches (on
    the CPU a wrapper runs the plain version and counts nothing).
    Returns the script as a module, the rows, the queries and what the
    phase returned."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import filter_qgram as kfq
    from repro_torch.kernels import match_mxu as kmx
    from repro_torch.kernels import match_swar as ksw
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shard", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "TIMED_RUNS", 1)
    counts: dict = {}
    for mod, name in ((ksw, "match_swar"), (ksw, "match_swar_best"),
                      (ksw, "match_swar_masks"), (kmx, "match_mxu"),
                      (kmx, "match_mxu_best"), (kfq, "filter_qgram")):
        def counting(*a, _k=getattr(mod, name), _n=name, **kw):
            counts[_n] = counts.get(_n, 0) + 1
            return _k(*a, **kw)
        monkeypatch.setattr(mod, name, counting)

    frags, pat = corpus(2000, seed=70)
    rng = np.random.default_rng(71)
    reads = np.stack([frags[r, 5:21] for r in rng.choice(2000, 8)])
    pstr = "".join("ACGT"[c] for c in pat)
    subset = np.sort(rng.choice(2000, 300, replace=False))
    queries = {
        "a": tm.MatchQuery.exact(pat, reduction="best", backend="swar",
                                 chunk_rows=256),
        "b": tm.MatchQuery.iupac("N" + pstr[1:8] + "R" + pstr[9:],
                                 reduction="threshold", threshold=13,
                                 backend="swar", chunk_rows=256),
        "c": tm.MatchQuery.exact(reads, mode="batched", reduction="topk",
                                 k=10, backend="mxu", chunk_rows=256),
        "d": tm.MatchQuery.exact(pat, reduction="best", chunk_rows=256),
        "c2": tm.MatchQuery.exact(reads, mode="batched",
                                  reduction="threshold", threshold=13,
                                  backend="mxu", rows=subset, filter=False,
                                  chunk_rows=128),
        "e": tm.MatchQuery.exact(pat, reduction="threshold", threshold=15,
                                 filter=True),
        "f": tm.MatchQuery.exact(pat, reduction="threshold", threshold=15)}
    one = tm.MatchEngine(frags.copy(), device="cpu")
    want = {k: one.compile(q).run() for k, q in queries.items()}
    out = cs.shard_phase(
        frags, queries, want, zero_counts=counts.clear,
        read_counts=lambda: dict(counts), sync=lambda: None, device="cpu",
        n_append=100, keep=keep)
    return cs, frags, queries, out


@pytest.fixture(scope="module")
def phase_12_rehearsal():
    """One rehearsal of phase 12 for the module (it is slow on a loaded
    host), its 4-shard results kept for phase 13; the patches end with
    it."""
    keep: dict = {}
    threads = torch.get_num_threads()
    # One host thread: on a loaded host (the suite's other workers)
    # every thread past that spins against them.
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            cs, frags, queries, out = rehearse_phase_12(mp, keep)
    finally:
        torch.set_num_threads(threads)
    return cs, frags, queries, out, keep


def test_chip_smoke_phase_12_rehearses_on_the_cpu(phase_12_rehearsal):
    out = phase_12_rehearsal[3]
    assert out["queries"]["a"]["launches_per_shard_chunk"] == 1
    assert out["queries"]["c"]["n_chunks"] > 1
    assert out["queries"]["e"]["strategy"] == "filter"
    assert sum(out["shard_live_rows"]) == 2100 - 21


def test_chip_smoke_phase_13_rehearses_on_the_cpu(phase_12_rehearsal,
                                                  monkeypatch, tmp_path):
    """``chip_smoke.py``'s phase 13 (``procs_phase``) on two gloo ranks of
    2 CPU shards each, held to the rehearsed phase 12's 4-shard results
    (the ranks are fresh interpreters: on the CPU nothing counts their
    launches)."""
    cs, frags, queries, sharded, keep = phase_12_rehearsal
    assert set(keep) == set(queries) | {
        f"{k}@{s}" for k in ("a", "c", "e")
        for s in ("tombstoned", "compacted")}
    monkeypatch.setattr(cs, "TIMED_RUNS", 1)
    monkeypatch.setattr(cs, "ROOT", tmp_path)     # its build/phase13
    # One host thread a rank, as in the fixture.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = cs.procs_phase(frags, queries, keep, sharded, device="cpu",
                         n_append=100)
    assert out["backend"] == "gloo"
    assert [r["local_shards"] for r in out["ranks"]] == [[0, 1], [2, 3]]
    for key, info in out["queries"].items():
        assert info["n_collectives"] == info["n_collectives_sharded"], key
        assert (info["collective_bytes"]
                == info["collective_bytes_sharded"]), key
    assert len(out["mutated"]) == 6
    assert all(sum(r["shard_live_rows"]) == 2100 - 21 for r in out["ranks"])


@pytest.mark.gpu
def test_four_shards_on_one_card_equal_one_shard():
    """S = 4 on ``cuda:0`` gives the one-shard engine's results bit for
    bit, through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import filter_qgram as kfq
    from repro_torch.kernels import match_swar as ksw
    frags, pat = corpus(4096, seed=60, chars=128)
    e1 = tm.MatchEngine(frags.copy(), device="cuda")
    es = tm.MatchEngine(frags.copy(), mesh=make_row_mesh(
        4, devices=["cuda:0"] * 4))
    pats = np.stack([pat, frags[7, 3:19], frags[9, 0:16]])
    queries = [tm.MatchQuery.exact(pat, reduction="best", backend="swar"),
               tm.MatchQuery.exact(pats, mode="batched", reduction="topk",
                                   k=5, backend="mxu"),
               tm.MatchQuery.exact(pat, reduction="threshold", threshold=14,
                                   filter=True),
               tm.MatchQuery.exact(pat, reduction="threshold", threshold=12,
                                   backend="mxu", filter=False)]
    for q in queries:
        assert_result_equal(e1.match(q), es.match(q))
    ksw.match_swar_best.n_launches = kfq.filter_qgram.n_launches = 0
    results = [es.match(q) for q in queries]
    assert all(r.n_shards == 4 and r.merge_path == "device"
               for r in results)
    # One launch a shard a chunk on the resident path; one filter launch
    # a shard for the filtered query.
    assert ksw.match_swar_best.n_launches == 4 * results[0].n_chunks
    assert kfq.filter_qgram.n_launches == 4
