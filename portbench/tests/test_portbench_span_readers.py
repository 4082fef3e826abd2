"""The readers of the program's host-work spans (``service.scatter``,
``assemble``) on hand-made runs: their value from the spans' own seconds,
and nothing where no such span was recorded or no read completed."""

from __future__ import annotations

from types import SimpleNamespace as NS

import pytest

from portbench import harness

SPANS = [
    # (name, seconds, own seconds, attributes)
    ("service.coalesce", 3.0, 0.5, {"n_queries": 128}),
    ("service.scatter", 2.0, 1.5, {"n_queries": 128, "n_requests": 128,
                                   "bytes": 600_000_000}),
    ("service.scatter", 1.0, 0.5, {"n_queries": 64, "n_requests": 64,
                                   "bytes": 400_000_000}),
    ("assemble", 0.5, 0.25, {"bytes": 300_000_000}),
    ("assemble", 0.25, 0.05, {"bytes": 100_000_000}),
    ("match.run", 1.0, 0.2, {}),
]


def run_of(spans=SPANS, done=200):
    return NS(spans=spans, done=done, window_s=10.0, latencies_s=[],
              stats={}, kernels={}, device_trace=None, setup_s=1.0, ticks=2)


@pytest.mark.parametrize("name,value", [
    # own seconds 2.0 and 0.3 (not the spans' 3.0 and 0.75) a read
    ("scatter_ms_per_read", 1e3 * 2.0 / 200),
    ("assemble_ms_per_read", 1e3 * 0.3 / 200),
    # 1e9 bytes over 2.0 own seconds
    ("scatter_gb_per_s", 0.5),
])
def test_span_reader_value(name, value):
    assert harness.reader(name)(run_of()) == pytest.approx(value)


@pytest.mark.parametrize("name", ["scatter_ms_per_read",
                                  "assemble_ms_per_read",
                                  "scatter_gb_per_s"])
@pytest.mark.parametrize("case", ["no_span", "no_read"])
def test_span_reader_reads_nothing(name, case):
    """A program that records no such span reads as absent, not as 0;
    so does a window that completed no read."""
    if case == "no_span":
        run = run_of([s for s in SPANS if s[0] not in
                      ("service.scatter", "assemble")])
    else:
        run = run_of(done=0)
    assert harness.reader(name)(run) is None


def test_scatter_rate_needs_own_time_and_bytes():
    no_time = [(n, t, 0.0, a) for n, t, _, a in SPANS]
    no_bytes = [(n, t, o, {}) for n, t, o, _ in SPANS]
    read = harness.reader("scatter_gb_per_s")
    assert read(run_of(no_time)) is None
    assert read(run_of(no_bytes)) is None
