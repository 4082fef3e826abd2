"""Launcher parity: ``repro_torch.launch.serve`` against
``repro.launch.serve`` on the same arguments.

Each workload runs at the reference's default sizes, the port's with
``--device cpu`` (the kernels' plain versions), the reference's in
process with its Pallas kernels in interpret mode.  The reference prints
its counters and returns nothing, so its report lines are parsed; the
port's returned ``ServiceStats.snapshot()`` must hold the same counters,
and its report lines must carry the same numbers (exact: all counters are
integers).  ``--workload lm`` with an arch the port has not brought up
is refused; its parity is in ``tests/test_torch_lm_serving.py``.
"""

import re

import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

# Report lines: the counters each prints, as (pattern, snapshot key).
MATCH_COUNTERS = [
    (r"launches=(\d+) ", "n_launches"),
    (r"coalesced=(\d+) ", "n_coalesced_launches"),
    (r"\(fused (\d+) queries\)", "n_coalesced_queries"),
    (r"cache_hits=(\d+) ", "n_cache_hits"),
    (r"ticks=(\d+) ", "n_ticks"),
    (r"filtered_launches=(\d+) ", "n_filtered_launches"),
    (r"ingested (\d+) rows", "n_ingested_rows"),
    (r"in (\d+) batched appends", "n_ingest_batches"),
]
STREAM_COUNTERS = [
    (r"\(total (\d+), prefilter", "n_bank_launches"),
    (r"prefilter (\d+)\)", "n_bank_prefilter_launches"),
    (r"\(evicted (\d+),", "n_evicted_rows"),
    (r"compactions (\d+)\)", "n_compactions"),
]
# Counts printed by both that the snapshot does not hold.
STREAM_PRINTED = [r"planted hits detected (\d+/\d+)",
                  r"corpus (\d+) live / (\d+) physical rows",
                  r"against (\d+) standing patterns"]


def run_both(capsys, argv, counters, printed=()):
    args = tserve.build_parser().parse_args(argv + ["--device", "cpu"])
    snap = tserve.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    args.jax_profiler = False
    run = (jserve.run_match_service if args.workload == "match"
           else jserve.run_stream)
    assert run(args) is None
    ref_out = capsys.readouterr().out
    for pattern, key in counters:
        want = re.search(pattern, ref_out)
        if want is None:
            assert re.search(pattern, port_out) is None, pattern
            continue
        assert int(want.group(1)) == snap[key], key
        assert re.search(pattern, port_out).groups() == want.groups(), key
    for pattern in printed:
        assert re.search(pattern, port_out).groups() == \
            re.search(pattern, ref_out).groups(), pattern
    return snap


@pytest.mark.parametrize("argv", [
    ["--selective", "4", "--predicate", "wildcard"],
    ["--selective", "2", "--tick-every", "2", "--requests", "12"],
], ids=["wildcard", "exact-ticks"])
def test_match_workload_matches_jax(capsys, argv):
    snap = run_both(capsys, ["--workload", "match"] + argv, MATCH_COUNTERS)
    assert snap["n_completed"] == snap["n_submitted"]
    assert snap["n_failed"] == 0


@pytest.mark.parametrize("argv", [
    [], ["--window-rows", "100", "--bank-filter", "on"],
], ids=["defaults", "window"])
def test_stream_workload_matches_jax(capsys, argv):
    snap = run_both(capsys, ["--workload", "stream"] + argv,
                    STREAM_COUNTERS, STREAM_PRINTED)
    assert snap["n_bank_launches"] == snap["n_ticks"] == 8


def test_lm_workload_is_refused(capsys):
    """The lm workload runs (``tests/test_torch_lm_serving.py`` holds it to
    the reference); an arch of a block family the port has not brought up
    is refused, naming the ROADMAP item."""
    with pytest.raises(SystemExit):
        tserve.main(["--workload", "lm", "--arch", "mamba2-130m",
                     "--device", "cpu"])
    assert "item 16b" in capsys.readouterr().err


def test_failed_queries_fail_the_run(monkeypatch):
    """A group that raises in the tick (a kernel that fails to build or
    launch lands there too) completes its tickets with ``error``; the
    launcher must not report such a run as served."""
    from repro_torch.match import service

    def broken(self, grp):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(service.MatchService, "_run_group", broken)
    with pytest.raises(AssertionError, match="queries failed"):
        tserve.main(["--workload", "match", "--device", "cpu"])
