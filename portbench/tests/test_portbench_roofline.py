"""The kernels' bytes and operations on hand-worked shapes, and the
reduction of a profile to busy time, kernel time and idle gaps."""

from __future__ import annotations

from types import SimpleNamespace as NS

import pytest
import torch

from portbench import peaks, tracing
from portbench.roofline import match_mxu, match_mxu_best

GEOM = {"fragment_chars": 500, "read_chars": 100}


def test_mxu_best_chunk():
    # (c)'s chunk: 1,004 rows of 640 one-hot chars, 32 of 128 columns used.
    pat = torch.zeros(512, 128, dtype=torch.bfloat16)
    pat[:400, :32] = 1
    d = match_mxu_best.describe((torch.empty(1004, 2560), pat),
                                {"n_locs": 401, "n_k": 400})
    w = match_mxu_best.work(d, GEOM)
    assert w["bf16_flop"] == 2 * 1004 * 401 * 32 * 400 == 10_306_662_400
    assert w["bytes"] == 2 * (1004 * 2560 + 400 * 32) + 8 * 1004 * 32 \
        == 5_423_104
    least, by = peaks.least_seconds(w)
    assert by == "bf16_flop" and least == pytest.approx(1.04213e-5, 1e-4)


def test_mxu_store_counts_real_alignments():
    pat = torch.zeros(512, 128, dtype=torch.bfloat16)
    pat[:400, :32] = 1
    w = match_mxu.work(match_mxu.describe((torch.empty(1004, 2560), pat),
                                          {"l_pad": 512}), GEOM)
    assert w["bf16_flop"] == 2 * 1004 * 401 * 32 * 400
    assert w["bytes"] == 2 * (1004 * 2560 + 400 * 32) + 4 * 1004 * 401 * 32


def chunk(rows=1004, cols=32):
    """A match_mxu_best call at (c)'s chunk shape: ``rows`` rows of 640
    one-hot chars, ``cols`` of 128 pattern columns used."""
    pat = torch.zeros(512, 128, dtype=torch.bfloat16)
    pat[:400, :cols] = 1
    return ("match_mxu_best", match_mxu_best.describe(
        (torch.empty(rows, 2560), pat), {"n_locs": 401, "n_k": 400}))


def test_roofline_sums_every_call():
    calls = [chunk(), chunk(), chunk(rows=500, cols=128)]
    got = tracing.roofline(calls, {"match_mxu_best": (1e-3, 3)},
                           GEOM)["match_mxu_best"]
    least = sum(peaks.least_seconds(match_mxu_best.work(d, GEOM))[0]
                for _, d in calls)
    assert got["calls"] == 3 and got["least_s"] == pytest.approx(least)
    assert got["bound_by"] == "bf16_flop"
    assert got["share"] == pytest.approx(100 * least / 1e-3)


def ev(name, a, b, dev="cpu", id=0):
    t = (torch.autograd.DeviceType.CUDA if dev == "cuda"
         else torch.autograd.DeviceType.CPU)
    return NS(name=name, device_type=t, time_range=NS(start=a, end=b), id=id)


def test_reduce_profile():
    prof = NS(events=lambda: [
        ev(tracing.WINDOW, 0, 1000),
        ev(tracing.KERNEL + "match_mxu_best", 100, 150),
        ev("cudaLaunchKernel", 120, 125, id=77),
        ev("void mxu_kernel<128, false>(float const*)", 200, 260, "cuda",
           77),
        ev("Memcpy DtoH (Device -> Pageable)", 300, 340, "cuda", 78),
        ev("cudaMemcpyAsync", 255, 262, id=78),
        ev("pull", 250, 600),
    ])
    r = tracing.reduce(prof, {"pull"})
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(1e-4)
    assert r["kernel_device"] == {"match_mxu_best": (pytest.approx(6e-5),
                                                     1)}
    idle = dict(r["breakdown"]["idle_gaps"])
    assert idle == {"harness (2 gaps)": pytest.approx(8.6e-4),
                    "pull (1 gaps)": pytest.approx(4e-5)}
    assert r["breakdown"]["device_ops"][0] == ["mxu_kernel<128, false>",
                                               pytest.approx(6e-5)]


def test_share_needs_every_launch():
    calls = [chunk(), chunk()]
    got = tracing.roofline(calls, {"match_mxu_best": (1e-5, 1)}, GEOM)
    assert got["match_mxu_best"]["share"] is None
    got = tracing.roofline(calls, {}, GEOM)
    assert got["match_mxu_best"]["share"] is None


def test_recorder_wraps_and_restores():
    """Every roofline file names a wrapper of the port, and the recorder
    puts each back as it found it."""
    import importlib
    mods = tracing.roofline_modules()
    assert {"match_mxu", "match_mxu_best"} <= set(mods)
    before = {n: getattr(importlib.import_module(m.WRAPPER[0]), m.WRAPPER[1])
              for n, m in mods.items()}
    with tracing.KernelRecorder():
        for n, m in mods.items():
            assert getattr(importlib.import_module(m.WRAPPER[0]),
                           m.WRAPPER[1]) is not before[n]
    for n, m in mods.items():
        assert getattr(importlib.import_module(m.WRAPPER[0]),
                       m.WRAPPER[1]) is before[n]
