"""``repro_torch.obs.device_time.device_ms``: a profiler reading counts
only when every flush's and a whole multiple of the calls' device events
were recorded; any other reading is retaken, and ``tries`` bad readings
raise.  The profiler is replaced by scripted event lists, so this runs on
the CPU."""

from types import SimpleNamespace

import pytest
import torch

from repro_torch.obs import device_time

FLUSH = "fill_kernel"
KERN = "my_kernel"
REPS = 20


def ev(key, count, us):
    return SimpleNamespace(key=key, count=count, self_device_time_total=us)


def scripted(monkeypatch, readings):
    """device_events returns the flush's events (4 calls and a stray
    record of earlier work), then each reading."""
    seq = iter([[ev(FLUSH, 4, 160.0), ev("earlier", 1, 9.0)]] + readings)
    monkeypatch.setattr(device_time, "device_events", lambda fn: next(seq))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


GOOD = [ev(FLUSH, REPS, 800.0), ev(KERN, REPS, 5000.0)]


@pytest.mark.parametrize("first, why", [
    ([ev(FLUSH, REPS, 800.0), ev(KERN, REPS - 7, 3000.0)], "kernel lost"),
    ([ev(KERN, 2 * REPS - 2, 6000.0)], "flush records lost"),
    ([ev(FLUSH, REPS - 1, 760.0), ev(KERN, 2 * REPS, 9000.0)],
     "a flush lost, stray kernels"),
], ids=["kernel_lost", "flush_lost", "stray_kernels"])
def test_bad_reading_is_retaken(monkeypatch, first, why):
    scripted(monkeypatch, [first, GOOD])
    logged = []
    ms = device_time.device_ms(lambda: None, REPS, lambda: None,
                               log=logged.append)
    assert ms == pytest.approx(5000.0 / REPS / 1e3), why
    assert len(logged) == 1


def test_good_reading_counts_every_kernel_of_the_call(monkeypatch):
    scripted(monkeypatch, [[ev(FLUSH, REPS, 800.0), ev(KERN, REPS, 5000.0),
                            ev("epilogue", REPS, 1000.0)]])
    ms = device_time.device_ms(lambda: None, REPS, lambda: None,
                               log=pytest.fail)
    assert ms == pytest.approx(6000.0 / REPS / 1e3)


def test_raises_after_tries_bad_readings(monkeypatch):
    bad = [ev(FLUSH, REPS, 800.0), ev(KERN, REPS - 1, 4000.0)]
    scripted(monkeypatch, [bad, bad, bad])
    with pytest.raises(RuntimeError, match="no reading"):
        device_time.device_ms(lambda: None, REPS, lambda: None, tries=3,
                              log=lambda s: None)


def test_flush_events_retaken_until_whole(monkeypatch):
    seq = iter([[ev(FLUSH, 3, 120.0)], [ev(FLUSH, 4, 160.0)], GOOD])
    monkeypatch.setattr(device_time, "device_events", lambda fn: next(seq))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ms = device_time.device_ms(lambda: None, REPS, lambda: None,
                               log=pytest.fail)
    assert ms == pytest.approx(5000.0 / REPS / 1e3)


def test_flush_without_events_raises(monkeypatch):
    monkeypatch.setattr(device_time, "device_events", lambda fn: [])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    with pytest.raises(RuntimeError, match="flush"):
        device_time.device_ms(lambda: None, REPS, lambda: None)
