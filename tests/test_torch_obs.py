"""Observability parity: ``repro_torch.obs`` against ``repro.obs``.

The counterpart of ``tests/test_obs.py``: the same samples (made with
numpy from a seed) and the same span programs go through both packages.

* ``LogHistogram`` quantiles and snapshots equal to the reference's;
* span nesting, attributes and disjoint self-time equal in structure;
* the Chrome / Perfetto trace-event schema;
* the disabled fast path allocating nothing (tracemalloc);
* plan-vs-actual records equal, bit for bit, to what
  ``FeedbackStore.observe`` receives on a feedback-enabled engine;
* the reference's traced service driven through both packages, with the
  reference's span names, the port's own (``PORT_SPANS``) beside them,
  and the same ``corpus.*`` counters;
* ``python -m repro_torch.obs.lint_spans`` passing on the tree and
  catching a planted uncovered kernel dispatch.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs

REPO = pathlib.Path(__file__).resolve().parent.parent
BOTH = pytest.mark.parametrize("obs", [jobs, tobs], ids=["jax", "torch"])


# -- LogHistogram -------------------------------------------------------------

def samples(dist: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if dist == "lognormal":
        return rng.lognormal(-5, 2, 5000)
    if dist == "uniform":
        return rng.uniform(1e-4, 1e-1, 5000)
    if dist == "exponential":
        return rng.exponential(0.01, 5000)
    xs = np.concatenate([rng.normal(1e-3, 1e-4, 2500),
                         rng.normal(1e-1, 1e-2, 2500)])
    return np.abs(xs) + 1e-9


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential",
                                  "bimodal"])
def test_histogram_quantiles_equal_the_reference(dist):
    hj, ht = jobs.LogHistogram(), tobs.LogHistogram()
    for x in samples(dist):
        hj.record(float(x))
        ht.record(float(x))
    for q in (0.0, 0.01, 0.25, 0.50, 0.90, 0.95, 0.99, 1.0):
        assert ht.quantile(q) == hj.quantile(q), q
    assert ht.snapshot() == hj.snapshot()
    assert (ht.count, ht.sum, ht.mean) == (hj.count, hj.sum, hj.mean)


def test_histogram_edge_cases_equal_the_reference():
    hj, ht = jobs.LogHistogram(), tobs.LogHistogram()
    assert ht.quantile(0.5) == hj.quantile(0.5) == 0.0
    for v in (0.0, -1.0, 4.0, 0.125, 0.125):
        hj.record(v)
        ht.record(v)
    assert ht.n_under == hj.n_under == 2
    for q in (0.0, 0.3, 0.5, 1.0):
        assert ht.quantile(q) == hj.quantile(q)
    with pytest.raises(ValueError):
        ht.quantile(1.5)
    with pytest.raises(ValueError):
        tobs.LogHistogram(base=1.0)


# -- spans --------------------------------------------------------------------

def span_program(obs):
    tr = obs.Tracer(enabled=True)
    with tr.span("service.tick", {"tick": 0}):
        with tr.span("match.run"):
            with tr.span("plan", {"kernel": "swar"}) as p:
                p.set("est_seconds", np.float64(0.5))
            with tr.span("filter"):
                with tr.span("pull"):
                    pass
            with tr.span("launch", {"c0": 0}):
                pass
    return tr


def test_span_trees_equal_the_reference():
    tj, tt = span_program(jobs), span_program(tobs)
    sj, st = list(tj.iter_spans()), list(tt.iter_spans())
    assert [s.name for s in st] == [s.name for s in sj] == [
        "service.tick", "match.run", "plan", "filter", "pull", "launch"]
    for a, b in zip(sj, st):
        assert b.attrs == a.attrs
        assert (b.parent_id is None) == (a.parent_id is None)
    assert isinstance(st[2].attrs["est_seconds"], float)
    ids = {s.span_id for s in st}
    assert len(ids) == len(st)
    assert all(s.parent_id in ids for s in st if s.parent_id is not None)
    assert tobs.STAGES == jobs.STAGES
    assert tt.current() is None and len(tt.roots) == 1


def test_stage_seconds_are_disjoint_self_times():
    tr = span_program(tobs)
    run = tr.roots[0].children[0]
    stages = run.stage_seconds()
    assert set(stages) == set(tobs.STAGES)
    fil = next(s for s in run.children if s.name == "filter")
    pull = fil.children[0]
    assert stages["pull"] == pytest.approx(pull.duration_s)
    assert stages["filter"] == pytest.approx(
        fil.duration_s - pull.duration_s)
    assert sum(stages.values()) <= run.duration_s + 1e-9


@BOTH
def test_span_exception_unwind_and_bounds(obs):
    tr = obs.Tracer(enabled=True, max_spans=2)
    with pytest.raises(RuntimeError):
        with tr.span("a"):
            with tr.span("b"):
                raise RuntimeError("boom")
    assert tr.current() is None
    for _ in range(4):
        with tr.span("r"):
            pass
    assert (len(tr.roots), tr.n_dropped, tr.n_spans) == (2, 3, 6)


# -- export -------------------------------------------------------------------

@BOTH
def test_chrome_trace_schema(obs, tmp_path):
    tr = obs.Tracer(enabled=True)
    with tr.span("match.run", {"reduction": "best"}):
        with tr.span("launch"):
            pass
    path = tmp_path / "trace.json"
    assert tr.write_chrome(path) == 2
    trace = json.loads(path.read_text())
    assert trace["otherData"]["n_spans"] == 2
    for ev in trace["traceEvents"]:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                "args"} <= set(ev)
        assert ev["ph"] == "X" and ev["ts"] >= 0.0 and ev["dur"] >= 0.0
    parent, child = trace["traceEvents"]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1.0


def test_export_keys_equal_the_reference(tmp_path):
    docs = {}
    for name, obs in (("jax", jobs), ("torch", tobs)):
        tr = span_program(obs)
        docs[name] = (tr.chrome_trace(),
                      [json.loads(line) for line in
                       tr.to_jsonl().splitlines()])
    (cj, lj), (ct, lt) = docs["jax"], docs["torch"]
    assert set(ct) == set(cj) and set(ct["otherData"]) == set(cj["otherData"])
    for a, b in zip(cj["traceEvents"], ct["traceEvents"]):
        assert set(b) == set(a) and b["name"] == a["name"]
        assert b["args"] == a["args"]
    assert [set(r) for r in lt] == [set(r) for r in lj]


# -- disabled fast path -------------------------------------------------------

def test_disabled_span_is_a_singleton_noop():
    tr = tobs.Tracer(enabled=False)
    s = tr.span("anything", None)
    assert s is tobs.NOOP_SPAN and tr.span("other") is s
    with s as inner:
        inner.set("k", "v")
    assert tr.n_spans == 0 and tr.roots == []


def test_disabled_span_zero_allocations():
    tr = tobs.Tracer(enabled=False)

    def hot():
        for _ in range(100):
            with tr.span("launch"):
                pass

    hot()
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    hot()
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grew = [st for st in after.compare_to(before, "lineno")
            if st.size_diff > 0
            and any("repro_torch" in str(f) and "obs" in str(f)
                    for f in st.traceback)]
    assert not grew, f"disabled span path allocated: {grew[:3]}"


# -- plan-vs-actual -----------------------------------------------------------

@BOTH
def test_plan_actual_mispredict_accounting(obs):
    m = obs.MetricsRegistry(drift_bound=2.0)
    key = ("swar", 5, 3, 0)
    m.record_plan_actual(key, 1.0, 1.5)
    m.record_plan_actual(key, 1.0, 8.0)
    m.record_plan_actual(key, 0.0, 1.0)
    assert m.mispredict_rate() == pytest.approx(2 / 3)
    assert m.mispredict_rate("mxu") == 0.0
    summary = m.plan_actual_summary()
    assert summary["swar/5/3/0"]["n"] == 3
    json.dumps(m.snapshot())


def recorded(engine, queries):
    """Run ``queries`` and return (feedback observations, registry
    records) for the run."""
    observed = []
    orig = engine.planner.feedback.observe
    engine.planner.feedback.observe = (
        lambda key, est, obs: (observed.append((key, est, obs)),
                               orig(key, est, obs))[-1])
    for q in queries:
        engine.match(**q) if isinstance(q, dict) else engine.match(q)
    return observed, engine.obs.metrics.plan_actual_records


def test_plan_actual_matches_feedback_bit_for_bit():
    """In both packages, every (key, est, obs) the engine hands
    ``FeedbackStore.observe`` is the identical record in the registry
    (tuple identity and float equality, not approx), under the
    reference's kernel names."""
    import repro.match as jm
    import repro_torch.match as tm

    rng = np.random.default_rng(5)
    rows = rng.integers(0, 4, (48, 64), np.uint8)
    queries = [rows[i, :12].copy() for i in range(4)] + [
        dict(patterns=rows[0, :12].copy(), reduction="threshold",
             threshold=12.0)]
    for name, eng in (
            ("jax", jm.MatchEngine(rows, record_runtimes=True)),
            ("torch", tm.MatchEngine(rows, record_runtimes=True,
                                     device="cpu"))):
        observed, records = recorded(eng, queries)
        assert observed, f"{name}: feedback-enabled engine recorded nothing"
        reg = {(k, e, o) for k, e, o in records}
        assert all(rec in reg for rec in observed)
        assert {k[0] for k, _, _ in records} <= {"swar", "mxu", "ref",
                                                  "filter"}


def test_plan_actual_always_on_without_feedback():
    from repro_torch.match import MatchEngine

    rng = np.random.default_rng(6)
    rows = rng.integers(0, 4, (32, 64), np.uint8)
    eng = MatchEngine(rows, record_runtimes=False, device="cpu")
    eng.match(rows[0, :8].copy())
    eng.match(rows[1, :8].copy())
    assert eng.planner.feedback.n_observations == 0
    assert eng.obs.metrics.plan_actual
    assert eng.obs.metrics.mispredict_rate() >= 0.0


# -- the traced service, through both packages --------------------------------

def traced_service(match, obs_mod, **kw):
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 4, (48, 64), np.uint8)
    obs = obs_mod.Observability(spans=True)
    eng = match.MatchEngine(rows, obs=obs, **kw)
    svc = match.MatchService(eng)
    tickets = [svc.submit(rows[i, :10].copy()) for i in range(6)]
    svc.ingest(rng.integers(0, 4, (4, 64), np.uint8))
    svc.flush()
    return svc, tickets, obs


@pytest.fixture(scope="module")
def services():
    import repro.match as jm
    import repro_torch.match as tm
    return {"jax": traced_service(jm, jobs),
            "torch": traced_service(tm, tobs, device="cpu")}


def test_service_spans_equal_the_reference(services):
    """The port records every span the reference does and, beside them,
    only the spans it declares in ``PORT_SPANS``; this run coalesces its
    best queries, so it reaches each of those but ``hits``."""
    names = {k: {s.name for s in obs.tracer.iter_spans()}
             for k, (_, _, obs) in services.items()}
    extra = names["torch"] - names["jax"]
    assert names["jax"] <= names["torch"]
    assert not names["jax"] & set(tobs.PORT_SPANS)
    assert extra == set(tobs.PORT_SPANS) & names["torch"]
    assert extra == {"service.plan", "service.scatter", "assemble"}
    assert {"service.enqueue", "service.tick", "match.run", "plan",
            "launch", "merge", "pull", "pack"} <= names["torch"]
    svc, _, obs = services["torch"]
    spans = list(obs.tracer.iter_spans())
    assert sum(s.name == "service.enqueue" for s in spans) == \
        svc.stats.n_submitted
    for run in (s for s in spans if s.name == "match.run"):
        assert {"plan", "launch", "pull"} <= {c.name for c in run.walk()}


def test_corpus_counters_equal_the_reference(services):
    counters = {k: {n: c.value for n, c in obs.metrics.counters.items()
                    if n.startswith("corpus.")}
                for k, (_, _, obs) in services.items()}
    assert counters["torch"] == counters["jax"]
    assert counters["torch"]["corpus.packs"] >= 1
    assert counters["torch"]["corpus.splice_rows"] >= 4


def test_result_timings_and_stats_views(services):
    svc, tickets, _ = services["torch"]
    res = tickets[0].result
    assert set(res.timings) == set(tobs.STAGES)
    assert res.timings["launch"] > 0.0 and "timings" not in repr(res)
    s = svc.stats
    assert s.latency_hist.count == s.n_completed
    snap = s.snapshot()
    assert set(snap["timings"]) == set(tobs.STAGES)
    assert snap["plan_actual"] and snap["plan_mispredict_rate"] >= 0.0
    json.dumps(snap)


# -- the lint -----------------------------------------------------------------

def lint(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.obs.lint_spans",
                           *map(str, args)], capture_output=True, text=True,
                          env=env, timeout=120)


def test_lint_passes_on_tree():
    proc = lint()
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


def test_lint_catches_uncovered_dispatch(tmp_path):
    k = tmp_path / "src" / "repro_torch" / "kernels"
    m = tmp_path / "src" / "repro_torch" / "match"
    k.mkdir(parents=True)
    m.mkdir(parents=True)
    (k / "foo.py").write_text(
        "from . import _build\n"
        "def _launch(x):\n"
        "    return _build.load('foo').foo_launch(x)\n"
        "def kern(x):\n"
        "    return _launch(x)\n")
    (m / "eng.py").write_text(
        "from repro_torch.kernels import foo as _f\n"
        "def run(x):\n"
        "    return _f.kern(x)\n")
    bad = lint(tmp_path)
    assert bad.returncode == 1
    assert "eng.py:3" in bad.stderr
    # A kernel bound to a name and called later is a dispatch too.
    (m / "eng.py").write_text(
        "from repro_torch.kernels import foo as _f\n"
        "def run(x, tr):\n"
        "    kern = _f.kern\n"
        "    with tr.span('launch'):\n"
        "        return kern(x)\n")
    bad = lint(tmp_path)
    assert bad.returncode == 1 and "eng.py:3" in bad.stderr
    (m / "eng.py").write_text(
        "from repro_torch.kernels import foo as _f\n"
        "def run(x, tr):\n"
        "    with tr.span('launch'):\n"
        "        return _f.kern(x)\n")
    good = lint(tmp_path)
    assert good.returncode == 0, good.stderr
