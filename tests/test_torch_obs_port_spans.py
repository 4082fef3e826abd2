"""The port's own spans (``repro_torch.obs.PORT_SPANS``) on a traced,
coalesced service tick, on the CPU.

* the tree: ``service.plan`` then ``service.coalesce`` -> [``match.run``,
  ``service.scatter``], ``assemble`` under ``match.run``, ``hits`` after
  each gathered hot block and nowhere else;
* the attributes: ``bytes`` equal to the returned views' and the
  assembled arrays' ``nbytes``, ``n_queries``, ``n_requests``,
  ``n_hits``, the batch plan's verdict, and ``n_strided`` 0: the
  query-major best pair scatters from contiguous columns;
* with the tracer off, nothing allocated by the tracer on that path.
"""

from __future__ import annotations

import tracemalloc

import numpy as np
import pytest

from repro_torch.match import MatchEngine, MatchQuery, MatchService
from repro_torch.obs import PORT_SPANS, STAGES, Observability

ROWS, F, P, CHUNK = 256, 64, 12, 32
SOURCES = (3, 200, 3)         # the third request repeats the first query


def corpus() -> np.ndarray:
    return np.random.default_rng(21).integers(0, 4, (ROWS, F), np.uint8)


def queries(rows: np.ndarray, reduction: str):
    kw = dict(reduction=reduction, chunk_rows=CHUNK)
    if reduction == "threshold":
        kw.update(threshold=float(P), filter=False)
    return [MatchQuery.exact(rows[r, 5:5 + P].copy(), **kw) for r in SOURCES]


def service(reduction: str, spans: bool = True):
    """A service over a fresh engine, its three requests (two distinct
    queries), and the list the fused launch's result is kept in as the
    engine returned it."""
    rows = corpus()
    obs = Observability(spans=spans)
    eng = MatchEngine(rows, obs=obs, device="cpu")
    fused = []
    engine_match = eng.match

    def match(query):
        fused.append(engine_match(query))
        return fused[-1]
    eng.match = match
    return MatchService(eng), queries(rows, reduction), fused, obs


def tick(svc, qs):
    """Submit the requests and run the one tick that coalesces them."""
    tickets = [svc.submit(q) for q in qs]
    svc.tick()
    assert all(t.done and t.error is None for t in tickets)
    assert svc.stats.n_coalesced_launches == 1
    return tickets


def traced_tick(reduction: str):
    svc, qs, fused, obs = service(reduction)
    return svc, tick(svc, qs), fused, obs


def nbytes(*arrays) -> int:
    return sum(a.nbytes for a in arrays if a is not None)


CASES = pytest.mark.parametrize("reduction", ["best", "threshold"])


@CASES
def test_port_span_tree(reduction):
    svc, _, fused, obs = traced_tick(reduction)
    assert len(fused) == 1
    (tick,) = obs.tracer.roots[-1:]
    assert [c.name for c in tick.children] == ["service.plan",
                                               "service.coalesce"]
    coalesce = tick.children[1]
    assert [c.name for c in coalesce.children] == ["match.run",
                                                   "service.scatter"]
    run = coalesce.children[0]
    assert [c.name for c in run.children].count("assemble") == 1
    assert run.children[-1].name == "assemble"
    names = [s.name for s in run.walk()]
    n_launch = names.count("launch")
    assert n_launch == fused[0].n_chunks > 1
    # A hits span follows each gathered block (a chunk with hot rows).
    gathered = [i for i, c in enumerate(run.children)
                if c.name == "pull" and c.attrs["kind"] == "block"]
    hits = [i for i, c in enumerate(run.children) if c.name == "hits"]
    assert hits == [i + 1 for i in gathered]
    if reduction == "threshold":
        assert 1 <= len(hits) < n_launch
    else:
        assert not hits
    # The port's spans are leaves and never stages: the stage breakdown
    # keeps its keys.
    for s in obs.tracer.iter_spans():
        if s.name in PORT_SPANS:
            assert s.name not in STAGES and not s.children
    assert set(fused[0].timings) == set(STAGES)
    assert set(svc.stats.snapshot()["timings"]) == set(STAGES)


@CASES
def test_port_span_attributes(reduction):
    svc, tickets, fused, obs = traced_tick(reduction)
    spans = {}
    for s in obs.tracer.iter_spans():
        spans.setdefault(s.name, []).append(s)
    (plan,) = spans["service.plan"]
    assert plan.attrs["n_queries"] == 2 and plan.attrs["coalesced"] is True
    assert 0 < plan.attrs["est_coalesced_s"] <= \
        plan.attrs["est_sequential_s"]
    assert plan.attrs["reason"].startswith("coalesce 2 queries")

    (scatter,) = spans["service.scatter"]
    views = {id(t.result): t.result for t in tickets}
    assert len(views) == 2
    assert scatter.attrs == {
        "n_queries": 2, "n_requests": len(tickets), "n_strided": 0,
        "bytes": sum(nbytes(v.best_locs, v.best_scores, v.scores,
                            v.topk_rows, v.topk_scores, v.hits)
                     for v in views.values())}

    res = fused[0]
    (assemble,) = spans["assemble"]
    assert assemble.attrs == {"bytes": nbytes(res.best_locs,
                                              res.best_scores, res.hits)}
    if reduction == "threshold":
        n_hits = sum(s.attrs["n_hits"] for s in spans["hits"])
        assert n_hits == res.hits.shape[0] == \
            sum(v.hits.shape[0] for v in views.values())
        # Each source row's read is found where it was taken from.
        assert {(r, 5) for r in SOURCES} <= \
            {(h[0], h[1]) for h in res.hits.tolist()}
    else:
        assert "hits" not in spans


@CASES
def test_port_spans_allocate_nothing_when_off(reduction):
    """With the tracer off the coalesced tick makes no ``Span``: nothing
    is allocated in ``obs/trace.py``."""
    tick(*service(reduction, spans=False)[:2])
    svc, qs, _, obs = service(reduction, spans=False)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        tick(svc, qs)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert obs.tracer.n_spans == 0 and obs.tracer.roots == []
    grew = [st for st in after.compare_to(before, "lineno")
            if st.size_diff > 0 and any(
                f.filename.replace("\\", "/").endswith("obs/trace.py")
                for f in st.traceback)]
    assert not grew, f"disabled tracer allocated: {grew[:3]}"
