"""Matcher, device, cost and schedule model parity for the PyTorch port.

Every case of ``tests/test_matcher.py::TestMatcher`` and
``tests/test_paper_geometry.py::test_full_row_alignment_program`` runs
through ``repro.core.matcher`` (JAX) and ``repro_torch.core.matcher``
(``device="cpu"``) on the same seeded numpy inputs: scores and
``mem_stats`` must be identical.  The NumPy oracles, the encodings, the
MTJ tables, the analog gate model, the schedules and the cost model
(Figs. 5-11) must give equal results, floats exactly (the same
arithmetic, tolerance 0); the paper checks of ``tests/test_costmodel.py``
hold for the port.
"""

import dataclasses
import itertools
import math
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.core import costmodel as tcost
from repro_torch.core import encoding as tenc
from repro_torch.core import gates as tgates
from repro_torch.core import matcher as tmatcher
from repro_torch.core import scheduler as tsched
from repro_torch.core import tech as ttech

PORT = SimpleNamespace(matcher=tmatcher, encoding=tenc, gates=tgates,
                       scheduler=tsched, costmodel=tcost, tech=ttech,
                       kw={"device": "cpu"})


@pytest.fixture(scope="module")
def jx():
    from repro.core import (costmodel, encoding, gates, matcher, scheduler,
                            tech)
    return SimpleNamespace(matcher=matcher, encoding=encoding, gates=gates,
                           scheduler=scheduler, costmodel=costmodel,
                           tech=tech, kw={})


def techs(pkg):
    return (pkg.tech.NEAR_TERM, pkg.tech.LONG_TERM)


def as_plain(x):
    """Dataclasses, dicts and sequences as nested builtins, arrays as
    lists, so two packages' results compare with ``==`` (floats
    exactly)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: as_plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    return x


# -- Matcher (Algorithm 1) --------------------------------------------------

def matcher_scores_match_oracle(pkg):
    rng = np.random.default_rng(0)
    frags = rng.integers(0, 4, (16, 32), np.uint8)
    pat = rng.integers(0, 4, 8, np.uint8)
    m = pkg.matcher.Matcher(frags, pattern_chars=8, **pkg.kw)
    m.load_pattern(pat)
    got = m.run()
    np.testing.assert_array_equal(got, pkg.matcher.sliding_scores(frags, pat))
    return got, m.array.mem_stats


def matcher_opt_schedule(pkg):
    rng = np.random.default_rng(4)
    frags = rng.integers(0, 4, (8, 20), np.uint8)
    pat = rng.integers(0, 4, 5, np.uint8)
    out = []
    for opt in (False, True):
        m = pkg.matcher.Matcher(frags, pattern_chars=5, opt=opt, **pkg.kw)
        m.load_pattern(pat)
        out += [m.run(), m.array.mem_stats]
    np.testing.assert_array_equal(out[0], out[2])
    return out


def matcher_per_row_patterns(pkg):
    rng = np.random.default_rng(1)
    frags = rng.integers(0, 4, (6, 24), np.uint8)
    pats = rng.integers(0, 4, (6, 6), np.uint8)
    m = pkg.matcher.Matcher(frags, pattern_chars=6, **pkg.kw)
    m.load_patterns_per_row(pats)
    got = m.run()
    np.testing.assert_array_equal(got,
                                  pkg.matcher.sliding_scores(frags, pats))
    return got, m.array.mem_stats


def matcher_planted_exact_match_wins(pkg):
    rng = np.random.default_rng(2)
    frags = rng.integers(0, 4, (4, 40), np.uint8)
    pat = rng.integers(0, 4, 10, np.uint8)
    frags[2, 7:17] = pat
    m = pkg.matcher.Matcher(frags, pattern_chars=10, **pkg.kw)
    m.load_pattern(pat)
    got = m.run()
    locs, scores = pkg.matcher.best_alignment(got)
    assert scores[2] == 10 and locs[2] == 7
    return got, locs, scores, m.array.mem_stats


def matcher_partial_run_locs(pkg):
    rng = np.random.default_rng(3)
    frags = rng.integers(0, 4, (4, 20), np.uint8)
    pat = rng.integers(0, 4, 5, np.uint8)
    m = pkg.matcher.Matcher(frags, pattern_chars=5, **pkg.kw)
    m.load_pattern(pat)
    sub = m.run(range(3, 7))
    np.testing.assert_array_equal(
        sub, pkg.matcher.sliding_scores(frags, pat)[:, 3:7])
    return sub, m.array.mem_stats


def matcher_layout_fits_2k_row(pkg):
    layout = pkg.matcher.plan_layout(2400, 100, scratch_budget=128)
    assert 900 <= layout.fragment_chars <= 1050
    assert layout.score_bits == 7
    return as_plain(layout), [layout.pat_lo, layout.match_lo,
                              layout.scratch_lo, layout.n_alignments,
                              layout.frag_bit_cols(3), layout.pat_bit_cols(5)]


def matcher_census_against_paper(pkg):
    c = pkg.matcher.count_alignment_ops(100)
    assert c["NOR"] == 300 and c["TH"] == 200
    assert 180 <= c["FA_COUNT"] <= 200
    assert c["SCORE_BITS"] == 7
    return c


def matcher_compile_alignment_bounds(pkg):
    layout = pkg.matcher.plan_layout(512, 10)
    with pytest.raises(ValueError):
        pkg.matcher.compile_alignment(layout, layout.n_alignments)
    with pytest.raises(ValueError):
        pkg.matcher.plan_layout(100, 40)
    return as_plain(layout)


def full_row_alignment_program(pkg):
    """tests/test_paper_geometry.py: one Algorithm-1 window at the paper's
    row geometry, 2400 columns, 100-char pattern, ~1000-char fragment."""
    layout = pkg.matcher.plan_layout(2400, 100, scratch_budget=128)
    rng = np.random.default_rng(0)
    frags = rng.integers(0, 4, (4, layout.fragment_chars), np.uint8)
    pat = rng.integers(0, 4, 100, np.uint8)
    frags[2, 37:137] = pat
    m = pkg.matcher.Matcher(frags, pattern_chars=100, n_cols=2400, **pkg.kw)
    m.load_pattern(pat)
    scores = m.run(range(30, 45))
    np.testing.assert_array_equal(
        scores, pkg.matcher.sliding_scores(frags, pat)[:, 30:45])
    assert scores[2, 7] == 100
    return scores, m.array.mem_stats


MATCHER_CASES = {f.__name__: f for f in (
    matcher_scores_match_oracle, matcher_opt_schedule,
    matcher_per_row_patterns, matcher_planted_exact_match_wins,
    matcher_partial_run_locs, matcher_layout_fits_2k_row,
    matcher_census_against_paper, matcher_compile_alignment_bounds,
    full_row_alignment_program)}


def assert_same(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert as_plain(a) == as_plain(b)


@pytest.mark.parametrize("name", sorted(MATCHER_CASES))
def test_matcher_case_matches_jax(jx, name):
    assert_same(MATCHER_CASES[name](PORT), MATCHER_CASES[name](jx))


def test_matcher_caches_one_packed_program_a_location():
    rng = np.random.default_rng(9)
    frags = rng.integers(0, 4, (3, 12), np.uint8)
    m = tmatcher.Matcher(frags, pattern_chars=4, device="cpu")
    m.load_pattern(frags[1, 2:6])
    first = m.run()
    packed = dict(m._programs)
    assert sorted(packed) == list(range(9))
    np.testing.assert_array_equal(m.run(), first)
    assert all(m._programs[k][0] is packed[k][0] for k in packed)
    assert first.dtype == np.uint16 and first[1, 2] == 4


@pytest.mark.parametrize("seed,R,F,P", [(0, 5, 30, 6), (1, 1, 16, 16),
                                        (2, 8, 40, 1)])
def test_oracles_match_jax(jx, seed, R, F, P):
    rng = np.random.default_rng(seed)
    frags = rng.integers(0, 4, (R, F), np.uint8)
    for pats in (rng.integers(0, 4, P, np.uint8),
                 rng.integers(0, 4, (R, P), np.uint8)):
        assert_same(tmatcher.sliding_scores(frags, pats),
                    jx.matcher.sliding_scores(frags, pats))
    for masks in (rng.integers(1, 16, P, np.uint8),
                  rng.integers(0, 16, (R, P), np.uint8)):
        assert_same(tmatcher.sliding_scores_masks(frags, masks),
                    jx.matcher.sliding_scores_masks(frags, masks))
    sc = tmatcher.sliding_scores(frags, frags[0, :P])
    assert_same(list(tmatcher.best_alignment(sc)),
                list(jx.matcher.best_alignment(sc)))


# -- encodings ----------------------------------------------------------------

def test_encodings_match_jax(jx):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (3, 17), np.uint8)
    bits = tenc.codes_to_bits(codes)
    assert bits.shape == (3, 34)
    assert_same(bits, jx.encoding.codes_to_bits(codes))
    assert_same(tenc.bits_to_codes(bits), jx.encoding.bits_to_codes(bits))
    np.testing.assert_array_equal(tenc.bits_to_codes(bits), codes)
    wide = rng.integers(0, 256, (2, 5), np.uint8)
    assert_same(tenc.codes_to_bits(wide, 8), jx.encoding.codes_to_bits(wide, 8))
    assert_same(tenc.bits_to_codes(tenc.codes_to_bits(wide, 8), 8), wide)
    text = b"CRAM-PM \x00\xff"
    assert_same(tenc.encode_bytes(text), jx.encoding.encode_bytes(text))


# -- technology tables ------------------------------------------------------

def test_mtj_tables_match_jax(jx):
    for name in ("NEAR_TERM", "LONG_TERM"):
        a, b = getattr(ttech, name), getattr(jx.tech, name)
        assert as_plain(a) == as_plain(b)
        assert (a.i_crit_eff_ua, a.r_p_ohm, a.r_ap_ohm) == (
            b.i_crit_eff_ua, b.r_p_ohm, b.r_ap_ohm)
    assert sorted(ttech.TECHS) == sorted(jx.tech.TECHS)
    assert ttech.PAPER_VGATE_V == jx.tech.PAPER_VGATE_V
    assert ttech.R_SERIES_OHM == jx.tech.R_SERIES_OHM
    assert as_plain(ttech.ArrayGeometry()) == as_plain(jx.tech.ArrayGeometry())
    assert as_plain(ttech.Periphery()) == as_plain(jx.tech.Periphery())
    assert not hasattr(ttech, "TPURoofline")


# -- analog gate model ------------------------------------------------------

@pytest.mark.parametrize("which", [0, 1], ids=["near", "long"])
def test_gate_model_matches_jax(jx, which):
    tp, tj = techs(PORT)[which], techs(jx)[which]
    for gate, spec in tgates.GATES.items():
        sj = jx.gates.GATES[gate]
        assert (spec.name, spec.arity, spec.preset) == (
            sj.name, sj.arity, sj.preset)
        assert tgates.vgate_window(gate, tp) == jx.gates.vgate_window(gate, tj)
        assert tgates.vgate_center(gate, tp) == jx.gates.vgate_center(gate, tj)
        assert tgates.gate_energy_pj(gate, tp) == jx.gates.gate_energy_pj(
            gate, tj)
        assert tgates.icrit_tolerance(gate, tp) == jx.gates.icrit_tolerance(
            gate, tj)
        for scale in (0.9, 1.0, 1.1):
            for r in (1000.0, tgates.R_SERIES_OHM):
                kw = dict(r_series=r, i_crit_scale=scale)
                try:
                    want = jx.gates.vgate_window(gate, tj, **kw)
                except ValueError:
                    with pytest.raises(ValueError):
                        tgates.vgate_window(gate, tp, **kw)
                    continue
                assert tgates.vgate_window(gate, tp, **kw) == want
        for bits in itertools.product((0, 1), repeat=spec.arity):
            assert spec.truth(bits) == sj.truth(bits)
            for p in (0, 1):
                assert tgates.output_current_slope(bits, p, tp) == \
                    jx.gates.output_current_slope(bits, p, tj)
                assert tgates.output_current(bits, p, 0.7, tp) == \
                    jx.gates.output_current(bits, p, 0.7, tj)
            assert tgates.analog_gate_output(gate, bits, tp) == \
                jx.gates.analog_gate_output(gate, bits, tj)
            assert tgates.analog_gate_output(gate, bits, tp, v_gate=0.66) == \
                jx.gates.analog_gate_output(gate, bits, tj, v_gate=0.66)
            arr = [np.array(b, np.uint8) for b in bits]
            assert int(tgates.GATE_FNS[gate](*arr)) == int(
                jx.gates.GATE_FNS[gate](*arr))
    assert as_plain(tgates.variation_study(tp)) == as_plain(
        jx.gates.variation_study(tj))
    assert tgates.PM_GATE_SET == jx.gates.PM_GATE_SET


# -- schedules --------------------------------------------------------------

def test_schedules_match_jax(jx):
    rng = np.random.default_rng(0)
    frags = rng.integers(0, 4, (32, 64), np.uint8)
    pats = np.stack([frags[i % 32, 5:25] for i in range(40)]
                    + [rng.integers(0, 4, 20, np.uint8) for _ in range(8)])
    for k in (4, 8):
        a = tsched.schedule_oracular(frags, pats, k=k)
        b = jx.scheduler.schedule_oracular(frags, pats, k=k)
        assert as_plain(a) == as_plain(b)
        assert (a.n_passes, a.replication) == (b.n_passes, b.replication)
        ia, ib = tsched.KmerIndex(frags, k), jx.scheduler.KmerIndex(frags, k)
        for p in pats[::7]:
            assert_same(np.sort(ia.candidate_rows(p)),
                        np.sort(ib.candidate_rows(p)))
        assert_same(tsched.kmer_codes(frags[0], k),
                    jx.scheduler.kmer_codes(frags[0], k))
    a, b = tsched.schedule_naive(8, 5), jx.scheduler.schedule_naive(8, 5)
    assert as_plain(a) == as_plain(b) and a.n_passes == 5
    for args in ((3e9, 100, 15), (3e9, 300, 15), (1e6, 50, 8), (10, 20, 12)):
        assert tsched.expected_candidates(*args) == \
            jx.scheduler.expected_candidates(*args)
    for args in ((3_000_000, 3_000_000, 3e9, 100), (10, 1e6, 3e9, 100, 12)):
        assert tsched.oracular_passes_analytic(*args) == \
            jx.scheduler.oracular_passes_analytic(*args)
    assert tsched.SEED_BUDGET == jx.scheduler.SEED_BUDGET


# -- cost model (Figs. 5-11) --------------------------------------------------

def designs(pkg):
    return {(opt, t.name, plen): pkg.costmodel.Design(
        tech=t, opt=opt, pattern_chars=plen)
        for opt in (False, True) for t in techs(pkg) for plen in (100, 200)}


def test_pass_costs_and_workloads_match_jax(jx):
    dp, dj = designs(PORT), designs(jx)
    for key in dp:
        a, b = dp[key], dj[key]
        assert a.t_op_ns == b.t_op_ns
        assert tcost.alignment_census(a) == jx.costmodel.alignment_census(b)
        pa, pb = tcost.pass_cost(a), jx.costmodel.pass_cost(b)
        assert as_plain(pa) == as_plain(pb)
        assert (pa.latency_s, pa.energy_j) == (pb.latency_s, pb.energy_j)
        for stage in pa.stages:
            for what in ("latency", "energy"):
                assert pa.share(stage, what) == pb.share(stage, what)
        for n, sched in ((3_000_000, "naive"), (3_000_000, "oracular"),
                         (1000, "oracular")):
            assert as_plain(tcost.run_workload(a, n, sched)) == as_plain(
                jx.costmodel.run_workload(b, n, sched))
        assert as_plain(tcost.dna_nmp_run(a, 1000)) == as_plain(
            jx.costmodel.dna_nmp_run(b, 1000))
        assert as_plain(tcost.dna_nmp_run(a, 1000, hyp=True)) == as_plain(
            jx.costmodel.dna_nmp_run(b, 1000, hyp=True))
        assert tcost.peak_array_current_a(a) == \
            jx.costmodel.peak_array_current_a(b)


def test_apps_and_bulk_ops_match_jax(jx):
    ap, aj = tcost.table4_apps(), jx.costmodel.table4_apps()
    assert as_plain(ap) == as_plain(aj)
    for name in ap:
        for tp, tj in zip(techs(PORT), techs(jx)):
            for opt in (False, True):
                assert as_plain(tcost.app_cram_run(ap[name], tp, opt)) == \
                    as_plain(jx.costmodel.app_cram_run(aj[name], tj, opt))
        for hyp in (False, True):
            assert as_plain(tcost.app_nmp_run(ap[name], hyp)) == as_plain(
                jx.costmodel.app_nmp_run(aj[name], hyp))
    for op in tcost.BULK_OP_STEPS:
        for tp, tj in zip(techs(PORT), techs(jx)):
            for mb in (32, 128):
                assert tcost.bulk_gops(op, tp, mb) == \
                    jx.costmodel.bulk_gops(op, tj, mb)
    assert tcost.AMBIT_GOPS == jx.costmodel.AMBIT_GOPS
    assert tcost.PINATUBO_OR_GOPS == jx.costmodel.PINATUBO_OR_GOPS
    assert as_plain(tcost.GPUBaseline()) == as_plain(
        jx.costmodel.GPUBaseline())
    assert as_plain(tcost.NMPBaseline()) == as_plain(
        jx.costmodel.NMPBaseline())


# The paper checks of tests/test_costmodel.py, on the port.

def run(design, sched="oracular", n=3_000_000):
    return tcost.run_workload(design, n, sched)


NEAR, LONG = ttech.NEAR_TERM, ttech.LONG_TERM
PAPER_CHECKS = {
    "fig5_naive_hours": lambda: run(tcost.Design(), "naive").total_time_s
    / 3600 == pytest.approx(23215.3, rel=0.02),
    "fig5_oracular_hours": lambda: run(tcost.Design()).total_time_s / 3600
    == pytest.approx(2.32, rel=0.15),
    "fig5_naive_to_oracular": lambda: run(tcost.Design(), "naive")
    .total_time_s / run(tcost.Design()).total_time_s
    == pytest.approx(1e4, rel=0.15),
    "fig5_opt_energy_unchanged": lambda: tcost.pass_cost(
        tcost.Design(opt=True)).energy_j == pytest.approx(
        tcost.pass_cost(tcost.Design()).energy_j, rel=1e-6),
    "fig5_opt_throughput": lambda: tcost.pass_cost(tcost.Design()).latency_s
    / tcost.pass_cost(tcost.Design(opt=True)).latency_s > 100,
    "fig6_preset_latency": lambda: tcost.pass_cost(tcost.Design()).share(
        "2_5_presets", "latency") > 0.9,
    "fig6_preset_energy": lambda: tcost.pass_cost(tcost.Design()).share(
        "2_5_presets", "energy") == pytest.approx(0.4386, abs=0.06),
    "fig6_write_below_1pct": lambda: max(
        tcost.pass_cost(tcost.Design()).share("1_write_pattern", w)
        for w in ("latency", "energy")) < 0.01,
    "fig6_bl_energy_below_1pct": lambda: tcost.pass_cost(
        tcost.Design()).share("3_6_bl_drive", "energy") < 0.01,
    "fig6_score_vs_match_energy": lambda: 0.7 < tcost.pass_cost(
        tcost.Design()).stages["7_score"].energy_j / tcost.pass_cost(
        tcost.Design()).stages["4_match"].energy_j < 2.5,
    "fig7_throughput_close": lambda: all(
        run(tcost.Design(opt=True, pattern_chars=p)).match_rate
        > 0.2 * run(tcost.Design(opt=True)).match_rate for p in (200, 300)),
    "fig7_efficiency_decreases": lambda: all(
        run(tcost.Design(opt=True, pattern_chars=p)).efficiency
        < run(tcost.Design(opt=True)).efficiency for p in (200, 300)),
    "fig8_long_term_boost": lambda: run(tcost.Design(tech=LONG, opt=True))
    .match_rate / run(tcost.Design(opt=True)).match_rate
    == pytest.approx(2.15, abs=0.15),
    "fig9_cram_beats_nmp_dna": lambda: run(tcost.Design()).match_rate
    / tcost.dna_nmp_run(tcost.Design(), 3_000_000).match_rate > 1e3,
    "fig9_apps_favor_cram": lambda: all(
        tcost.app_cram_run(a, NEAR).match_rate
        > tcost.app_nmp_run(a).match_rate
        for a in tcost.table4_apps().values()),
    "fig10_bc_least_benefit": lambda: min(
        (tcost.app_cram_run(a, NEAR).efficiency
         / tcost.app_nmp_run(a, hyp=True).efficiency, n)
        for n, a in tcost.table4_apps().items())[1] == "BC",
    "fig11_not_vs_ambit": lambda: tcost.bulk_gops("NOT", NEAR)
    / tcost.AMBIT_GOPS["NOT"] == pytest.approx(178, rel=0.05),
    "fig11_xor_vs_ambit": lambda: tcost.bulk_gops("XOR", NEAR)
    / tcost.AMBIT_GOPS["XOR"] == pytest.approx(1.34, rel=0.05),
    "fig11_pinatubo_or": lambda: (
        tcost.bulk_gops("OR", NEAR) / tcost.PINATUBO_OR_GOPS
        == pytest.approx(6, rel=0.1)
        and tcost.bulk_gops("OR", LONG) / tcost.PINATUBO_OR_GOPS
        == pytest.approx(12, rel=0.15)),
    "fig11_xor_third_of_basic": lambda: tcost.bulk_gops("NOT", NEAR)
    / tcost.bulk_gops("XOR", NEAR) == pytest.approx(3.0, rel=0.05),
    "peak_current_below_ddr3": lambda: tcost.peak_array_current_a(
        tcost.Design(tech=LONG)) < 1.0,
    "t_op_tech_ratio": lambda: tcost.Design().t_op_ns / tcost.Design(
        tech=LONG).t_op_ns == pytest.approx(2.146, abs=0.02),
}


@pytest.mark.parametrize("name", sorted(PAPER_CHECKS))
def test_paper_checks_hold_for_the_port(name):
    assert PAPER_CHECKS[name]()


def test_design_pass_latency_is_finite():
    """What chip_smoke phase 9 prints beside a Matcher pass (context)."""
    lat = tcost.pass_cost(tcost.Design()).latency_s
    assert math.isfinite(lat) and lat > 0
