"""Launcher parity: ``repro_torch.launch.serve`` against
``repro.launch.serve`` on the same arguments.

Each workload runs at the reference's default sizes, the port's with
``--device cpu`` (the kernels' plain versions), the reference's in
process with its Pallas kernels in interpret mode.  The reference prints
its counters and returns nothing, so its report lines are parsed; the
port's returned ``ServiceStats.snapshot()`` must hold the same counters,
and its report lines must carry the same numbers (exact: all counters are
integers).  ``--workload lm`` runs every arch; the SSD, encoder-decoder
and embeddings-input archs are held here to the reference launcher's
counts, the others in ``tests/test_torch_lm_{serving,moe,hybrid}.py``.
"""

import re
from types import SimpleNamespace

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


@pytest.mark.parametrize("arch", ["mamba2-130m", "whisper-tiny",
                                  "pixtral-12b"])
def test_lm_workload_matches_jax(capsys, monkeypatch, arch):
    """``--workload lm`` for the SSD, encoder-decoder (tokens only, as the
    reference launcher serves it) and embeddings-input archs: the seeded
    launcher runs (no arch is refused), and on the reference's
    PRNGKey(0) weights it prints the reference launcher's counts, its
    streams equal under the margin rule of
    ``tests/test_torch_lm_serving.py`` (mamba2's margin is read off the
    reference engine's own logits: its engine steps every slot's state,
    so a forward over the context is another function)."""
    import sys

    import jax
    import numpy as np
    from test_torch_lm_model import to_np
    from test_torch_lm_serving import same_stream
    from test_torch_lm_ssm import recorded_engine, same_under_margin

    from repro.configs import get_config
    from repro.models import model
    from repro.serving import engine
    from repro_torch import convert
    from repro_torch.configs import get_config as tget

    got = tserve.main(["--workload", "lm", "--arch", arch, "--device", "cpu",
                       "--requests", "2", "--max-new", "6"])
    assert got["n_tokens"] == 12
    assert "served 2 requests, 12 tokens" in capsys.readouterr().out

    streams = []

    class Recording(engine.Engine):
        def run(self, requests, max_steps=10_000):
            super().run(requests, max_steps)
            streams.extend(list(r.out) for r in requests)

    monkeypatch.setattr(jserve, "Engine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve", "--workload", "lm",
                                      "--arch", arch])
    assert jserve.main() is None
    ref_out = capsys.readouterr().out
    cfg = get_config(arch, smoke=True)
    params = model.init_params(cfg, jax.random.PRNGKey(0))
    lm = convert.params_from_numpy(tget(arch, smoke=True), to_np(params),
                                   device="cpu")
    args = tserve.build_parser().parse_args(["--workload", "lm", "--arch",
                                             arch, "--device", "cpu"])
    got = tserve.run_lm(args, params=lm)
    port_out = capsys.readouterr().out
    served = r"served (\d+) requests, (\d+) tokens"
    assert re.search(served, port_out).groups() == re.search(
        served, ref_out).groups()
    assert (got["n_requests"], got["n_tokens"]) == (6, 96)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 8, dtype=np.int32)
               for _ in range(6)]
    if cfg.family == "ssm":
        _, _, top2 = recorded_engine(engine.Engine, engine.Request, cfg,
                                     params, prompts, 16, 4, max_seq=64)
        equal = [same_under_margin(w, g, steps.__getitem__, "launcher")
                 for w, g, steps in zip(streams, got["streams"], top2)]
    else:
        ref = SimpleNamespace(jnp=jax.numpy, model=model, cfg=cfg,
                              params=params)
        equal = [same_stream(ref, p, w, g, "launcher")
                 for p, w, g in zip(prompts, streams, got["streams"])]
    if all(equal):
        acc = r"acceptance: (\d+/\d+)"
        assert re.search(acc, port_out).groups() == re.search(
            acc, ref_out).groups()


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
