"""Device time of a function's kernels, from ``torch.profiler``.

``device_ms(fn, reps, flush)`` is the mean device time per call of the
kernels ``fn()`` launches, each call after ``flush()`` (a write larger
than the L2, so every call reads its inputs from HBM).  A kernel of a
few microseconds ends before the next call is issued, so CUDA events
around back-to-back calls would time the host's issue rate instead.

The profiler can lose device records or hand them to a later profile.
A lost record reads as a faster kernel (below its bound, even) and a
lost flush record counts the flush's kernel as the function's.  So a
reading counts only when the profiler saw every flush's events and a
whole multiple of ``reps`` other device events; else it is logged
and taken again, after a pause, and after ``tries`` bad readings
``device_ms`` raises.  Now and then a profile session on an H100 sees no
device event at all, and such sessions come in short runs when sessions
follow each other back to back; a pause between tries (``pause``) breaks
the runs up.  Nothing here runs at import time.
"""

from __future__ import annotations

import time
from typing import Callable, List


def device_events(fn: Callable[[], object]) -> list:
    """The device-side rows of ``key_averages()`` for one ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def device_us(ev) -> float:
    """Self device microseconds of one ``key_averages()`` row."""
    us = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if us is None else us


def _flush_events(flush, tries: int, pause: float, calls: int = 4):
    """(keys, device events per call) of ``flush()``: the keys seen a
    whole multiple of ``calls`` times over ``calls`` calls (a stray record
    of earlier work is not)."""
    def run():
        for _ in range(calls):
            flush()
    for i in range(tries):
        if i:
            time.sleep(pause)
        evs = [ev for ev in device_events(run)
               if ev.count >= calls and ev.count % calls == 0]
        if evs:
            return ({ev.key for ev in evs},
                    sum(ev.count for ev in evs) // calls)
    raise RuntimeError(f"the profiler saw no device event of the flush in "
                       f"{tries} tries")


def device_ms(fn: Callable[[], object], reps: int, flush: Callable[[], object],
              tries: int = 8, log: Callable[[str], None] = print,
              pause: float = 0.2) -> float:
    """Mean device ms per call of ``fn()``'s kernels over ``reps`` calls,
    each after ``flush()``; a bad reading is retaken ``pause`` s later."""
    import torch
    flush_keys, per_flush = _flush_events(flush, tries, pause)
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            flush()
            fn()
    bad: List[str] = []
    for i in range(tries):
        if i:
            time.sleep(pause)
        evs = device_events(run)
        n_flush = sum(ev.count for ev in evs if ev.key in flush_keys)
        mine = [ev for ev in evs if ev.key not in flush_keys]
        seen = sum(ev.count for ev in mine)
        if n_flush == reps * per_flush and seen >= reps and seen % reps == 0:
            return sum(device_us(ev) for ev in mine) / reps / 1e3
        bad.append(f"{n_flush} flush and {seen} other device events over "
                   f"{reps} calls: " + "; ".join(
                       f"{ev.key[:60]} x{ev.count}" for ev in evs))
        log(f"  device_ms: {bad[-1]}; timing again")
    raise RuntimeError("device_ms: no reading with every device event "
                       "recorded: " + " | ".join(bad))
