"""The readers' arithmetic, and every metric's reader on a run that holds
nothing to read."""

from __future__ import annotations

import json
from types import SimpleNamespace as NS

import pytest

from portbench import harness, readers
from portbench.tests.tiny import ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]


def empty_run(**kw):
    run = dict(done=0, window_s=0.0, latencies_s=[], spans=[], stats={},
               kernels={}, device_trace=None, setup_s=12.5, ticks=0)
    run.update(kw)
    return NS(**run)


def test_rate_and_tail():
    run = empty_run(done=300, window_s=12.0,
                    latencies_s=[i / 1000 for i in range(1, 101)])
    assert readers.rate(run) == 25.0
    assert readers.p95_ms(run) == pytest.approx(95.05)


def test_span_own_time():
    run = empty_run(spans=[("pull", 0.5, 0.25, {}), ("pull", 0.2, 0.2, {}),
                           ("launch", 1.0, 0.1, {})])
    assert readers.span_s(run, "pull") == pytest.approx(0.45)
    assert readers.span_s(run, "merge") is None
    assert readers.ms_per(readers.span_s(run, "pull"), 9) == \
        pytest.approx(50.0)
    assert readers.ms_per(None, 9) is None and readers.ms_per(1.0, 0) is None


def test_idle_share_and_roofline():
    run = empty_run(device_trace={"window_s": 10.0, "busy_s": 1.5},
                    kernels={"match_mxu": {"share": 9.4}})
    assert readers.idle_share(run) == pytest.approx(85.0)
    assert readers.roofline(run, "match_mxu") == 9.4
    assert readers.roofline(run, "match_mxu_best") is None


@pytest.mark.parametrize("name", METRICS)
def test_reader_reads_nothing_from_an_empty_run(name):
    got = harness.reader(name)(empty_run())
    # Only the set-up time is always there; a share is never 0.
    assert got == (12.5 if name == "setup_s" else None)
