"""Parity for the surface the port shares with the JAX package: the
legacy ``MatchEngine.match(filter=)``, ``calibrate.measure``/``autotune``
with ``roofline=`` and ``kernels=``, the deprecated ``method=``
spellings, and the public constants.

The same seeded inputs go through ``repro`` on the CPU (Pallas in
interpret mode) and ``repro_torch`` with ``device="cpu"`` (the kernels'
plain versions); integer results must be bit-identical.
"""

import typing

import numpy as np
import pytest
import torch

import repro.core.encoding as jenc
import repro.data.dedup as jdd
import repro.kernels.ops as jops
import repro.match as jm
import repro.match.calibrate as jcal
import repro.models.config as jconfig
import repro_torch.core.encoding as tenc
import repro_torch.data.dedup as tdd
import repro_torch.kernels.ops as tops
import repro_torch.match as tm
import repro_torch.match.calibrate as tcal
import repro_torch.models.config as tconfig
from repro_torch.core.tech import H100, GPURoofline
from repro_torch.match import planner as tpl

R, F, P = 160, 96, 24
PLANTED = (4, 63, 120)
THRESHOLD = P - 2


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(31)
    frags = rng.integers(0, 4, (R, F), np.uint8)
    pat = rng.integers(0, 4, P, np.uint8)
    for row in PLANTED:
        off = int(rng.integers(0, F - P + 1))
        frags[row, off:off + P] = pat
    frags[PLANTED[1], 3] ^= 1 if frags[PLANTED[1], 3] < 2 else 3
    return jm.MatchEngine(frags), tm.MatchEngine(frags, device="cpu"), pat


# -- MatchEngine.match(filter=) ----------------------------------------------

@pytest.mark.parametrize("filt", [True, False, None])
def test_match_forwards_filter_as_the_reference(engines, filt):
    je, te, pat = engines
    kw = dict(reduction="threshold", threshold=THRESHOLD, filter=filt)
    rj, rt = je.match(pat, **kw), te.match(pat, **kw)
    assert rt.plan.strategy == rj.plan.strategy
    if filt is not None:
        assert rt.plan.strategy == ("filter" if filt else "scan")
    np.testing.assert_array_equal(rt.hits, np.asarray(rj.hits))
    assert rt.hits.dtype == np.asarray(rj.hits).dtype
    if rj.plan.strategy == "filter":
        np.testing.assert_array_equal(rt.survivor_rows,
                                      np.asarray(rj.survivor_rows))
        assert set(PLANTED) <= set(rt.survivor_rows.tolist())
    assert set(rt.hits[:, 0].tolist()) >= {PLANTED[0], PLANTED[2]}


def test_match_filter_rejected_where_the_reference_rejects(engines):
    je, te, pat = engines
    for eng in (je, te):
        with pytest.raises(ValueError, match="filter=True needs"):
            eng.match(pat, reduction="best", filter=True)
    for eng, mod in ((je, jm), (te, tm)):
        query = mod.MatchQuery.exact(pat, reduction="threshold",
                                     threshold=THRESHOLD)
        with pytest.raises(ValueError, match="keyword overrides"):
            eng.match(query, filter=False)


# -- the deprecated method= spellings -----------------------------------------

def test_match_scores_method_spellings_warn_and_match_the_reference():
    rng = np.random.default_rng(32)
    frags = rng.integers(0, 4, (24, 40), np.uint8)
    pat = rng.integers(0, 4, 12, np.uint8)
    for call in (lambda ops, **kw: ops.match_scores(frags, pat, "swar", **kw),
                 lambda ops, **kw: ops.match_scores(frags, pat, method="mxu",
                                                    **kw)):
        with pytest.warns(DeprecationWarning, match="match_scores"):
            want = call(jops)
        with pytest.warns(DeprecationWarning, match="match_scores"):
            got = call(tops, device="cpu")
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got.dtype == np.int32


def test_method_yields_to_an_explicit_backend():
    rng = np.random.default_rng(33)
    frags = rng.integers(0, 4, (16, 32), np.uint8)
    pat = rng.integers(0, 4, 8, np.uint8)
    with pytest.warns(DeprecationWarning):
        got = tops.match_scores(frags, pat, "mxu", backend="ref",
                                device="cpu")
    np.testing.assert_array_equal(got, tops.match_scores(
        frags, pat, backend="ref", device="cpu"))
    with pytest.warns(DeprecationWarning, match="CRAMDedup"):
        d = tdd.CRAMDedup(backend="ref", method="mxu", device="cpu")
    assert d.backend == "ref"


def test_dedup_method_warns_and_keeps_what_the_reference_keeps():
    rng = np.random.default_rng(34)
    base = [rng.bytes(40) for _ in range(5)]
    docs = base + [bytes([base[1][0] ^ 2]) + base[1][1:], base[3][1:],
                   base[0]] + [rng.bytes(40) for _ in range(2)]
    with pytest.warns(DeprecationWarning, match="CRAMDedup"):
        ref = jdd.CRAMDedup(method="swar")
    with pytest.warns(DeprecationWarning, match="CRAMDedup"):
        port = tdd.CRAMDedup(method="swar", device="cpu")
    assert port.backend == ref.backend == "swar"
    kept = port.filter(docs)
    assert kept == ref.filter(docs)
    assert len(kept) == 7


def test_dedup_keeps_device_keyword_only():
    with pytest.raises(TypeError):
        tdd.CRAMDedup(128, 96, 0.9, None, None, "cpu")


# -- calibrate: roofline= and kernels= ---------------------------------------

OTHER = GPURoofline(name="other", peak_bf16_flops=400e12,
                    peak_int32_ops=9e12, hbm_bw=2.0e12, nvlink_bw=300e9)


def planner_seconds(roofline, kernel, shape):
    """The planner's analytic seconds for one calibration point."""
    if kernel == "bank_prefilter":
        return tpl.analytic_bank_prefilter_seconds(
            roofline, shape["Q"], shape["sig_words"], shape["D"])
    if kernel == "filter":
        return tpl.analytic_filter_seconds(roofline, shape["R"],
                                           shape["sig_words"], 1)
    R, P = shape["R"], shape["P"]
    L = shape["F"] - P + 1
    if kernel == "mxu":
        return tpl.analytic_mxu_seconds(roofline, R, L, P,
                                        shape.get("Q", 128))
    if kernel == "ref":
        return tpl.analytic_ref_seconds(roofline, R, L, P, 1)
    return tpl.analytic_swar_seconds(
        roofline, R, L, P, 1, "accept" if kernel == "swar_masks" else "exact")


TINY = {"swar": dict(R=16, F=40, P=10), "swar_masks": dict(R=8, F=40, P=20),
        "mxu": dict(R=3, F=40, P=10, Q=5), "ref": dict(R=4, F=24, P=8),
        "filter": dict(R=128, sig_words=2),
        "bank_prefilter": dict(Q=128, D=4, sig_words=2)}


@pytest.mark.parametrize("kernel", tcal.KERNELS)
def test_measure_prices_on_the_given_roofline(kernel):
    shape = TINY[kernel]
    analytic, measured = tcal.measure(kernel, shape, device="cpu",
                                      repeats=1, roofline=OTHER)
    assert measured > 0.0
    assert analytic == planner_seconds(OTHER, kernel, shape)
    default, _ = tcal.measure(kernel, shape, device="cpu", repeats=1)
    assert default == planner_seconds(H100, kernel, shape)
    if kernel != "ref":                     # ref's price is the rate only
        assert analytic != default


def test_default_analytic_seconds_are_the_h100_planners():
    """Without ``roofline``, every grid point prices as before: the
    planner's analytic seconds on the H100."""
    cpu = torch.device("cpu")
    for grid in (tcal.FAST_GRID, tcal.FULL_GRID):
        assert set(grid) == set(tcal.KERNELS)
        for kernel, shapes in grid.items():
            for shape in shapes:
                fn, analytic = tcal._build_call(kernel, shape, cpu)
                del fn
                assert analytic == planner_seconds(H100, kernel, shape), \
                    (kernel, shape)


def test_autotune_fits_the_kernels_asked_for(monkeypatch):
    shapes = jcal.FAST_GRID["filter"]
    monkeypatch.setattr(tcal, "FAST_GRID",
                        {**tcal.FAST_GRID, "filter": shapes})
    want = jcal.autotune(fast=True, kernels=("filter",), repeats=1)
    table = tcal.autotune(fast=True, kernels=("filter",), repeats=1,
                          device="cpu", roofline=OTHER)
    assert set(table.curves) == set(table.samples) == set(want.curves) \
        == {"filter"}
    assert [{k: s[k] for k in ("R", "sig_words")}
            for s in table.samples["filter"]] == shapes
    assert [s["analytic_s"] for s in table.samples["filter"]] == \
        [planner_seconds(OTHER, "filter", s) for s in shapes]
    assert table.meta["roofline"] == "other"
    for cal, kw in ((jcal, {}), (tcal, {"device": "cpu"})):
        with pytest.raises(KeyError):
            cal.autotune(fast=True, kernels=("filter", "nope"), repeats=1,
                         **kw)


def test_autotune_subset_launches_only_its_calls(monkeypatch):
    """``_time_rounds`` gets the subset's calls only, each point once."""
    monkeypatch.setattr(tcal, "FAST_GRID",
                        {k: [v, v] for k, v in TINY.items()})
    seen = []
    real = tcal._build_call

    def spy(kernel, shape, dev, roofline):
        seen.append(kernel)
        return real(kernel, shape, dev, roofline)

    monkeypatch.setattr(tcal, "_build_call", spy)
    table = tcal.autotune(fast=True, kernels=("mxu", "filter"), repeats=1,
                          device="cpu")
    assert seen == ["mxu", "mxu", "filter", "filter"]
    assert set(table.curves) == {"mxu", "filter"}
    assert table.meta["roofline"] == H100.name


# -- constants ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["DNA_BITS", "CHARS_PER_WORD_DNA",
                                  "BYTE_BITS", "CHARS_PER_WORD_BYTE",
                                  "LOW_BIT_MASK_2", "LOW_BIT_MASK_8"])
def test_encoding_constants_equal_the_references(name):
    want, got = getattr(jenc, name), getattr(tenc, name)
    assert type(got) is type(want)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    assert got == want


def test_block_kind_equals_the_references():
    assert typing.get_origin(tconfig.BlockKind) is typing.Literal
    assert typing.get_args(tconfig.BlockKind) == \
        typing.get_args(jconfig.BlockKind)
