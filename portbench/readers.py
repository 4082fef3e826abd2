"""Arithmetic the metric readers share.  A reader (``metrics/<name>.py``)
defines ``read(run)``: a number, or None where the run holds nothing to
read (the metric is then left out of the line; a share of a roofline is
never reported as 0)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def rate(run) -> Optional[float]:
    """Completed units per second over the whole window."""
    return run.done / run.window_s if run.window_s > 0 and run.done else None


def p95_ms(run) -> Optional[float]:
    """95th percentile of every request's latency in the window, ms."""
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3


def span_s(run, name: str) -> Optional[float]:
    """Own seconds (less their children's) in spans called ``name``; None
    when the run recorded none."""
    got = [s[2] for s in run.spans if s[0] == name]
    return sum(got) if got else None


def ms_per(total_s: Optional[float], n: int) -> Optional[float]:
    return None if total_s is None or not n else 1e3 * total_s / n


def roofline(run, kernel: str) -> Optional[float]:
    k = run.kernels.get(kernel)
    return None if k is None else k["share"]


def idle_share(run) -> Optional[float]:
    t = run.device_trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
