"""Calibration parity: ``repro_torch.match.calibrate`` against
``repro.match.calibrate``.

No microbenchmark of the card runs here.  Fitting and persistence are
pure functions of the samples, so the same samples (made with numpy from
a seed) and the same synthetic tables go through both packages, and the
results must be bit-identical: fitted curves, quantized parameters,
digests and JSON.  The planner's calibrated branch is held to the JAX
planner's three-way choice; the measured path runs once per kernel at a
tiny shape through the plain versions (``device="cpu"``); an engine over
a calibrated source records runtimes, re-plans a drifted query and keeps
its results equal to a static engine's.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.match.calibrate as jcal
import repro_torch.match.calibrate as tcal
from repro.core import tech as jtech
from repro.match import Planner as JPlanner
from repro_torch.core import tech as ttech
from repro_torch.match import MatchEngine, MatchQuery
from repro_torch.match.feedback import kernel_key
from repro_torch.match.planner import FilterContext, Planner

ALPHAS = {"swar": 256.0, "swar_masks": 181.0, "mxu": 4096.0, "ref": 2.83,
          "filter": 16.0, "bank_prefilter": 16.0}


def curves(mod, alphas=ALPHAS, beta=1e-5, **betas):
    """KernelCurves of one package's ``tech`` module: ``alphas`` slopes,
    ``beta`` intercept unless ``betas`` names a kernel's own."""
    return {k: mod.KernelCurve(alpha=a, beta=betas.get(k, beta),
                               n_samples=4, rel_err=0.1)
            for k, a in alphas.items()}


def make_table(alphas=ALPHAS, cal=tcal, tech=ttech, **kw):
    return cal.CalibrationTable(device_kind="cpu", backend="cpu",
                                interpret=True,
                                curves=curves(tech, alphas, **kw))


def as_dict(curve):
    return dataclasses.asdict(curve)


# -- fitting, bit for bit -----------------------------------------------------

def _noisy():
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(1e-6, 1e-2, 6))
    return x, 50.0 * x * rng.uniform(0.5, 2.0, 6)


SAMPLE_SETS = {
    "linear": (np.array([1e-6, 1e-5, 1e-4, 1e-3]),
               37.0 * np.array([1e-6, 1e-5, 1e-4, 1e-3]) + 2e-5),
    "negative_intercept": (np.array([1e-4, 1e-3, 1e-2]),
                           10.0 * np.array([1e-4, 1e-3, 1e-2]) - 5e-5),
    "noisy": _noisy(),
    "single": (np.array([1e-4]), np.array([3e-3])),
    "flat": (np.array([1e-8, 1e-7, 1e-6]), np.array([2e-5, 2e-5, 2e-5])),
    # A card-like kernel: ~20 us of wrapper and launch, slope 0.5.
    "intercept_bound": (np.array([2e-6, 1.6e-5, 1.3e-4, 3.1e-4]),
                        0.5 * np.array([2e-6, 1.6e-5, 1.3e-4, 3.1e-4])
                        + 2.1e-5),
    "seeded": (np.random.default_rng(7).uniform(1e-7, 1e-3, 5),
               np.random.default_rng(8).uniform(1e-5, 1e-2, 5)),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
def test_fit_curve_bit_identical(name):
    x, y = SAMPLE_SETS[name]
    assert as_dict(tcal.fit_curve(x, y)) == as_dict(jcal.fit_curve(x, y))


@pytest.mark.parametrize("v", [0.0, -1.0, 3e-5, 1.0, 37.0, 100.0, 103.0,
                               4096.0, 0.4142, 2.5e-3])
def test_quantize_q2_bit_identical(v):
    assert tcal.quantize_q2(v) == jcal.quantize_q2(v)


def test_fit_recovers_linear_data_within_quantization():
    x, y = SAMPLE_SETS["linear"]
    c = tcal.fit_curve(x, y)
    assert c.alpha == pytest.approx(37.0, rel=0.10)
    assert c.beta == pytest.approx(2e-5, rel=0.10)
    assert c.n_samples == 4


def test_fit_positivity_and_monotone():
    c = tcal.fit_curve(*SAMPLE_SETS["negative_intercept"])
    assert c.beta == 0.0 and c.alpha > 0.0
    c = tcal.fit_curve(*SAMPLE_SETS["noisy"])
    priced = [c.seconds(a) for a in np.linspace(1e-7, 1e-1, 32)]
    assert all(b >= a for a, b in zip(priced, priced[1:]))


def test_fit_zero_samples_raises():
    with pytest.raises(ValueError):
        tcal.fit_curve([], [])


# -- cost sources -------------------------------------------------------------

def test_calibrated_source_matches_the_reference():
    src_t = ttech.CalibratedCostSource(
        {"swar": ttech.KernelCurve(10.0, 1e-6)}, digest="ab" * 16)
    src_j = jtech.CalibratedCostSource(
        {"swar": jtech.KernelCurve(10.0, 1e-6)}, digest="ab" * 16)
    assert src_t.tag == src_j.tag == "calibrated:abababab"
    assert src_t.price("swar", 1e-4, 3) == src_j.price("swar", 1e-4, 3)
    # An unknown kernel falls back to the port's static source.
    assert src_t.price("mxu", 1e-4) == \
        ttech.StaticCostSource().price("mxu", 1e-4)
    assert ttech.StaticCostSource().price("ref", 1e-4) == pytest.approx(
        1e-4 + ttech.REF_CALL_OVERHEAD_S)


# -- persistence --------------------------------------------------------------

@pytest.mark.parametrize("alphas", [ALPHAS, {k: v for k, v in ALPHAS.items()
                                            if k != "bank_prefilter"}],
                         ids=["port_keys", "jax_keys"])
def test_equal_tables_equal_digests_and_json(alphas):
    t = make_table(alphas)
    j = make_table(alphas, cal=jcal, tech=jtech)
    assert t.digest == j.digest
    assert json.dumps(t.to_json(), sort_keys=True) == \
        json.dumps(j.to_json(), sort_keys=True)
    assert t.cost_source().tag == j.cost_source().tag


def test_table_filename_scheme_is_the_reference_one():
    for kind, backend, interp in (("cpu", "cpu", True),
                                  ("NVIDIA H100 80GB HBM3", "cuda", False)):
        assert tcal.table_filename(kind, backend, interp) == \
            jcal.table_filename(kind, backend, interp)
    assert tcal.table_filename("NVIDIA H100 80GB HBM3", "cuda", False) == \
        "nvidia-h100-80gb-hbm3--cuda--compiled.json"


def test_a_reference_table_file_loads_in_the_port(tmp_path):
    path = make_table(cal=jcal, tech=jtech).save(tmp_path)
    loaded = tcal.CalibrationTable.load("cpu", "cpu", True, tmp_path)
    assert loaded.digest == make_table().digest
    assert path.name == tcal.table_filename("cpu", "cpu", True)


def test_roundtrip_keeps_golden_decisions(tmp_path):
    table = make_table()
    table.save(tmp_path)
    loaded = tcal.CalibrationTable.load("cpu", "cpu", True, tmp_path)
    assert loaded.digest == table.digest
    assert tcal.golden_decisions(loaded.cost_source()) == \
        tcal.golden_decisions(table.cost_source())
    src = tcal.load_cost_source("cpu", "cpu", True, tmp_path)
    assert src is not None and src.digest == table.digest


def test_load_cost_source_missing_corrupt_or_wrong_device(tmp_path):
    assert tcal.load_cost_source("cpu", "cpu", True, tmp_path) is None
    p = tmp_path / tcal.table_filename("cpu", "cpu", True)
    p.write_text("{not json")
    assert tcal.load_cost_source("cpu", "cpu", True, tmp_path) is None
    p.unlink()
    card = dataclasses.replace(make_table(),
                               device_kind="NVIDIA H100 80GB HBM3",
                               backend="cuda", interpret=False)
    card.save(tmp_path)
    assert tcal.load_cost_source("cpu", "cpu", True, tmp_path) is None
    assert tcal.load_cost_source("NVIDIA A100-SXM4-80GB", "cuda", False,
                                 tmp_path) is None
    assert tcal.load_cost_source("NVIDIA H100 80GB HBM3", "cuda", False,
                                 tmp_path).digest == card.digest


def test_edited_table_refused(tmp_path):
    p = make_table().save(tmp_path)
    doc = json.loads(p.read_text())
    doc["curves"]["swar"]["alpha"] *= 2      # edited without re-digesting
    p.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="digest"):
        tcal.CalibrationTable.load("cpu", "cpu", True, tmp_path)
    assert tcal.load_cost_source("cpu", "cpu", True, tmp_path) is None
    doc = make_table().to_json()
    doc["version"] = tcal.TABLE_VERSION + 1
    with pytest.raises(ValueError, match="version"):
        tcal.CalibrationTable.from_json(doc)


def test_digest_tracks_decision_relevant_fields_only():
    a, b = make_table(), make_table()
    b.samples = {"swar": [{"R": 1}]}
    b.meta = {"grid": "different"}
    assert a.digest == b.digest
    assert make_table({**ALPHAS, "swar": 999.0}).digest != a.digest


def test_bench_provenance_on_the_cpu():
    prov = tcal.bench_provenance(device="cpu")
    assert set(prov) == {"device_kind", "backend", "calibration",
                         "n_processes", "n_hosts", "power_limit_w"}
    assert set(prov) - {"power_limit_w"} == set(
        jcal.bench_provenance())
    assert prov["device_kind"] == "cpu" and prov["backend"] == "cpu"
    assert prov["calibration"] == "static"
    assert prov["power_limit_w"] is None
    assert prov["n_processes"] == prov["n_hosts"] == 1
    tagged = tcal.bench_provenance(make_table().cost_source(), device="cpu")
    assert tagged["calibration"] == make_table().cost_source().tag


@pytest.mark.parametrize("uuid", ["GPU-5e2a41c3-0000-1111-2222-333344445555",
                                  "5e2a41c3-0000-1111-2222-333344445555"])
def test_power_limit_asks_for_this_card_by_uuid(monkeypatch, uuid):
    """Under a ``CUDA_VISIBLE_DEVICES`` remap torch's index 0 need not be
    nvidia-smi's first card: the limit is asked for by the card's UUID,
    and only that card's line is read."""
    import subprocess
    import types
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        assert cmd[:3] == ["nvidia-smi", "-i",
                           "GPU-5e2a41c3-0000-1111-2222-333344445555"]
        return types.SimpleNamespace(stdout="350.00 W\n")

    monkeypatch.setattr(tcal.torch.cuda, "get_device_properties",
                        lambda idx: types.SimpleNamespace(uuid=uuid))
    monkeypatch.setattr(tcal.subprocess, "run", fake_run)
    assert tcal._power_limit_w(tcal.torch.device("cuda", 3)) == 350.0
    assert len(calls) == 1

    def no_tool(cmd, **kw):
        raise subprocess.CalledProcessError(9, cmd)

    monkeypatch.setattr(tcal.subprocess, "run", no_tool)
    assert tcal._power_limit_w(tcal.torch.device("cuda", 3)) is None
    assert tcal._power_limit_w(tcal.torch.device("cpu")) is None


# -- the planner's calibrated branch ------------------------------------------

def ref_cheap(mod):
    """The reference backend nearly free, both kernels a 1 s intercept."""
    return curves(mod, {**ALPHAS, "ref": 1e-6}, beta=1.0, ref=1e-9)


@pytest.mark.parametrize(
    "shape", jcal.GOLDEN_SHAPES, ids=lambda s: ",".join(f"{k}={v}" for k, v
                                                 in sorted(s.items())))
def test_calibrated_planner_weighs_ref_as_the_reference(shape):
    src_t = ttech.CalibratedCostSource(ref_cheap(ttech), digest="0" * 32)
    src_j = jtech.CalibratedCostSource(ref_cheap(jtech), digest="0" * 32)
    pt = Planner(cost_source=src_t).plan(**shape)
    pj = JPlanner(cost_source=src_j).plan(**shape)
    assert pt.backend == pj.backend == "ref"
    assert pt.reason.startswith("measured: ref")
    assert pj.reason.startswith("measured: ref")


def test_tiny_escape_is_static_only():
    shape = dict(n_rows=2, fragment_chars=20, pattern_chars=8)
    assert Planner().plan(**shape).backend == "ref"
    src_t = make_table().cost_source()
    src_j = make_table(cal=jcal, tech=jtech).cost_source()
    assert Planner(cost_source=src_t).plan(**shape).backend == \
        JPlanner(cost_source=src_j).plan(**shape).backend == "swar"


def test_plans_carry_the_cost_source_tag():
    plan = Planner().plan(n_rows=1024, fragment_chars=256, pattern_chars=32)
    assert plan.cost_source == "static" and "[cost=static]" in plan.reason
    src = make_table().cost_source()
    plan_c = Planner(cost_source=src).plan(n_rows=1024, fragment_chars=256,
                                           pattern_chars=32)
    assert plan_c.cost_source == src.tag
    assert plan_c.reason.startswith("measured:")
    assert plan_c.reason.endswith(f"[cost={src.tag}]")


def test_priced_keys_are_the_calibrated_kernels():
    priced = set()

    class Recording(Planner):
        def _price(self, kernel, *args):
            priced.add(kernel)
            return super()._price(kernel, *args)

    p = Recording(cost_source=make_table().cost_source())
    ctx = FilterContext(sig_words=8, n_queries=1, prunable=True,
                        survivor_frac=0.01)
    for pred in ("exact", "accept"):
        for q in (None, 128):
            p.plan(n_rows=4096, fragment_chars=256, pattern_chars=32,
                   n_patterns=q, predicate=pred, filter_ctx=ctx)
        p.plan_batch(n_rows=4096, fragment_chars=256, pattern_chars=32,
                     n_queries=8, predicate=pred)
    p.plan_bank(n_docs=256, fragment_chars=500, pattern_chars=100,
                n_patterns=4096, sig_words=8, survivor_frac=0.3)
    assert priced == set(tcal.KERNELS)


N_GOLDEN = (len(tcal.GOLDEN_SHAPES) + len(tcal.GOLDEN_FILTER_SHAPES)
            + len(tcal.GOLDEN_BANK_SHAPES))


def test_golden_matrix_covers_the_reference_and_the_card():
    assert tcal.GOLDEN_SHAPES[:len(jcal.GOLDEN_SHAPES)] == \
        jcal.GOLDEN_SHAPES
    dec = tcal.golden_decisions(ttech.StaticCostSource())
    assert len(tcal.GOLDEN_SHAPES) == 13
    assert len(dec) == N_GOLDEN == 18
    n = len(tcal.GOLDEN_SHAPES)
    assert all(b in ("swar", "mxu", "ref") for _, b in dec[:n])
    # The filter and bank shapes: the static planner filters (e) at its
    # survivor estimate and prefilters the bank, as the card runs them.
    assert all(k.startswith("filter:") and c.split("/")[0] in ("swar", "mxu")
               and c.split("/")[1] in ("scan", "filter")
               for k, c in dec[n:n + len(tcal.GOLDEN_FILTER_SHAPES)])
    assert dict(dec)["filter:" + tcal._shape_key(
        tcal.GOLDEN_FILTER_SHAPES[0])] == "swar/filter"
    assert [c for k, c in dec if k.startswith("bank:")][0] == "filter"


def test_grid_top_points_are_the_main_path_launches():
    plan = Planner().plan(n_rows=620839, fragment_chars=500,
                          pattern_chars=100)
    assert tcal.FULL_GRID["swar"][-1] == dict(R=plan.chunk_rows, F=500,
                                              P=100)
    mxu = Planner().plan(n_rows=620839, fragment_chars=500,
                         pattern_chars=100, n_patterns=128, backend="mxu")
    assert tcal.FULL_GRID["mxu"][-1] == dict(R=mxu.chunk_rows, F=500, P=100,
                                             Q=128)
    # The filter kernels' main-path launches sit under the wrapper's
    # intercept; their grids hold them and go on past them.
    for key, launch in (("filter", dict(R=620928, sig_words=8)),
                        ("bank_prefilter", dict(Q=4096, D=256, sig_words=8))):
        assert launch in tcal.FULL_GRID[key] and launch in tcal.FAST_GRID[key]
    for key, grid in tcal.FULL_GRID.items():
        assert tcal.FAST_GRID[key][-1] == grid[-1]
        assert 2 <= len(tcal.FAST_GRID[key]) <= 3 <= len(grid)


def test_filter_grids_reach_past_the_intercept():
    """Each filter kernel's top point prices at least 100 us on the
    roofline, several times the ~25 us a wrapper call costs on the card,
    so the slope is identifiable; each grid spans two decades."""
    from repro_torch.core.tech import H100
    from repro_torch.match import planner as tpl
    for key, grid in (("filter", tcal.FULL_GRID["filter"]),
                      ("bank_prefilter", tcal.FULL_GRID["bank_prefilter"])):
        if key == "filter":
            xs = [tpl.analytic_filter_seconds(H100, g["R"], g["sig_words"])
                  for g in grid]
        else:
            xs = [tpl.analytic_bank_prefilter_seconds(
                H100, g["Q"], g["sig_words"], g["D"]) for g in grid]
        assert xs == sorted(xs)
        assert xs[-1] >= 1e-4 and xs[-1] / xs[0] >= 100.0


def flat_source(swar, mxu, digest):
    """Prices independent of shape: each kernel its intercept only."""
    return ttech.CalibratedCostSource(
        curves(ttech, dict.fromkeys(ALPHAS, 1e-12), beta=1e3,
               swar=swar, swar_masks=swar, mxu=mxu), digest=digest)


def test_decisions_stable_tolerates_neutral_and_flags_real_flips():
    a = flat_source(1.0, 1.05, "a" * 32)
    # Scan backends flip; the bank keeps its scan (the prefilter costs
    # 1e3 s under both).
    scans = [r for r in tcal.decisions_stable(a, a)[1]
             if not r["shape"].startswith("bank:")]
    assert len(scans) == N_GOLDEN - len(tcal.GOLDEN_BANK_SHAPES)
    ok, rows = tcal.decisions_stable(a, flat_source(1.1, 1.05, "b" * 32))
    assert ok and len(rows) == N_GOLDEN
    assert all(r["stable"] == r["shape"].startswith("bank:") for r in rows)
    assert all(r["cost_neutral"] for r in rows if not r["stable"])
    ok, rows = tcal.decisions_stable(a, flat_source(10.0, 1.05, "c" * 32))
    assert not ok and not any(r["cost_neutral"] for r in rows)
    ok, rows = tcal.decisions_stable(a, a)
    assert ok and all(r["stable"] for r in rows)


def test_decisions_stable_reads_the_filter_and_bank_curves():
    """Two tables that differ only in the ``filter`` and
    ``bank_prefilter`` curves flip every filter-then-verify and bank
    decision, and the check fails; the scan matrix does not move."""
    cheap = ttech.CalibratedCostSource(curves(ttech), digest="e" * 32)
    dear = ttech.CalibratedCostSource(
        curves(ttech, filter=10.0, bank_prefilter=10.0), digest="f" * 32)
    ok, rows = tcal.decisions_stable(cheap, dear)
    assert not ok
    n = len(tcal.GOLDEN_SHAPES)
    assert all(r["stable"] for r in rows[:n])
    for r in rows[n:]:
        assert not r["stable"] and not r["cost_neutral"], r
        assert r["choice_a"].endswith("filter")
        assert r["choice_b"].endswith("scan")


# -- the measured path on the CPU ---------------------------------------------

TINY = {"swar": dict(R=16, F=40, P=10), "swar_masks": dict(R=8, F=40, P=20),
        "mxu": dict(R=3, F=40, P=10, Q=5), "ref": dict(R=4, F=24, P=8),
        "filter": dict(R=128, sig_words=2),
        "bank_prefilter": dict(Q=128, D=4, sig_words=2)}


@pytest.mark.parametrize("kernel", tcal.KERNELS + tuple(tcal.FUSED))
def test_measure_runs_the_plain_versions(kernel):
    shape = TINY[tcal.FUSED.get(kernel, kernel)]
    analytic, measured = tcal.measure(kernel, shape, device="cpu",
                                      repeats=2)
    assert analytic > 0.0 and measured > 0.0
    if kernel in tcal.FUSED:
        assert analytic == tcal.measure(tcal.FUSED[kernel], shape,
                                        device="cpu", repeats=1)[0]


def test_autotune_on_the_cpu_fits_every_kernel(monkeypatch):
    monkeypatch.setattr(tcal, "FAST_GRID",
                        {k: [v, v] for k, v in TINY.items()})
    table = tcal.autotune(fast=True, device="cpu", repeats=1)
    assert set(table.curves) == set(tcal.KERNELS)
    assert (table.device_kind, table.backend, table.interpret) == \
        ("cpu", "cpu", True)
    assert all(len(table.samples[k]) == 2 for k in tcal.KERNELS)


def test_autotune_takes_its_readings_in_rounds_over_the_grid(monkeypatch):
    """Each point is called once to warm up and then once a round, every
    point in every round; its sample is the least of its readings."""
    monkeypatch.setattr(tcal, "FAST_GRID",
                        {k: [v, v] for k, v in TINY.items()})
    points = [(k, i) for k in tcal.KERNELS for i in range(2)]
    made, calls, now = [], [], [0.0]

    def fake_call(kernel, shape, dev):
        key = points[len(made)]
        made.append(key)

        def fn():
            # Round r's reading of point j lasts 1 + (j + r) % 3 seconds,
            # so only the least of three rounds is 1 for every point.
            r = calls.count(key) - 1
            calls.append(key)
            now[0] += 1.0 + (points.index(key) + r) % 3
        return fn, 1e-6

    monkeypatch.setattr(tcal, "_build_call", fake_call)
    monkeypatch.setattr(tcal.time, "perf_counter", lambda: now[0])
    table = tcal.autotune(fast=True, device="cpu", repeats=3)
    assert calls == points * 4          # the warm-up, then three rounds
    for k in tcal.KERNELS:
        assert [s["measured_s"] for s in table.samples[k]] == [1.0, 1.0]


def test_engine_records_feedback_and_replans():
    """A calibrated engine records runtimes; a bucket priced far below
    what the CPU takes is re-priced, and the compiled query re-plans onto
    the other kernel with results equal to the static engine's."""
    rng = np.random.default_rng(0)
    frags = rng.integers(0, 4, (64, 96), np.uint8)
    # swar priced 10 us, mxu 20 us, ref 1 s: swar first.
    src = ttech.CalibratedCostSource(
        curves(ttech, dict.fromkeys(ALPHAS, 1e-12), beta=1.0,
               swar=1e-5, mxu=2e-5), digest="d" * 32)
    eng = MatchEngine(frags, cost_source=src, device="cpu")
    static = MatchEngine(frags, device="cpu")
    assert eng.record_runtimes and not static.record_runtimes
    assert f"cost={src.tag}" in repr(eng)
    q = MatchQuery.exact(frags[0, :16].copy(), reduction="best")
    cm = eng.compile(q)
    assert cm.plan.backend == "swar"
    want = static.compile(q).run()
    backends = []
    for _ in range(8):
        res = cm.run()
        backends.append(res.plan.backend)
        np.testing.assert_array_equal(res.best_locs, want.best_locs)
        np.testing.assert_array_equal(res.best_scores, want.best_scores)
    fb = eng.planner.feedback
    assert fb.n_observations >= 4                # the warm-up discarded
    assert kernel_key("swar", 64, 16, 1) in fb.repriced()
    # Frozen store, one more run: the plan revalidates to its version.
    eng.record_runtimes = False
    cm.run()
    assert cm._fb_version == fb.version
    assert backends[0] == "swar" and backends[-1] == "mxu"
    assert static.planner.feedback.snapshot()["n_buckets"] == 0


def test_committed_card_table_loads_with_its_digest():
    """The table measured on the card is committed unedited: it loads
    through the digest check and fits every key the planner prices."""
    path = tcal.calibration_dir() / tcal.table_filename(
        "NVIDIA H100 80GB HBM3", "cuda", False)
    doc = json.loads(path.read_text())
    table = tcal.CalibrationTable.from_json(doc)
    assert doc["digest"] == table.digest
    assert set(table.curves) == set(tcal.KERNELS)
    src = tcal.load_cost_source("NVIDIA H100 80GB HBM3", "cuda", False)
    assert src is not None and src.tag == f"calibrated:{table.digest[:8]}"
    assert len(tcal.golden_decisions(src)) == N_GOLDEN
