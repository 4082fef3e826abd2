"""The traced run: the window under ``torch.profiler``, reduced.

* ``KernelRecorder`` wraps the port's kernel wrappers named by the files
  under ``roofline/`` while the window runs: each call's shapes are kept
  (``describe``) and the call runs inside a profiler range named
  ``portbench.kernel.<name>``.
* ``profile_window`` runs the window (at most ``SECONDS`` long) under the
  profiler and takes it again
  (up to ``TRIES`` times, ``PAUSE`` s apart) when the profile holds no
  device event: a profile session on an H100 now and then sees none, and
  such a profile must never read as an idle device.
* ``reduce`` turns the profile into what the readers use: the seconds in
  which the device ran anything (``busy_s``) over the window
  (``window_s``), each kernel's device seconds (a device kernel belongs to
  the wrapper call whose range holds the runtime call that launched it,
  matched by the launch's correlation id), the device operations that
  took most time, and the idle time between device operations named by
  the innermost span open on the host meanwhile.
"""

from __future__ import annotations

import bisect
import importlib
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

HERE = Path(__file__).resolve().parent
KERNEL = "portbench.kernel."
WINDOW = "portbench.window"
TRIES = 4
PAUSE = 0.2
TOP = 10
# The traced run's window: a profile of longer windows takes minutes to
# read back, and the whole traced run must end within the run's limit.
SECONDS = 10.0


def roofline_modules() -> Dict[str, object]:
    """Kernel name -> its ``roofline/<kernel>.py`` module."""
    out = {}
    for path in sorted((HERE / "roofline").glob("*.py")):
        if not path.stem.startswith("_"):
            out[path.stem] = importlib.import_module(
                f"portbench.roofline.{path.stem}")
    return out


class KernelRecorder:
    """Records every call of the port's kernel wrappers while entered."""

    def __init__(self):
        self.calls: List[Tuple[str, dict]] = []
        self._undo: List[Tuple[object, str, Callable, Callable]] = []

    def __enter__(self) -> "KernelRecorder":
        from torch.profiler import record_function
        for name, rmod in roofline_modules().items():
            mod = importlib.import_module(rmod.WRAPPER[0])
            orig = getattr(mod, rmod.WRAPPER[1])

            def wrapped(*args, _orig=orig, _name=name, _r=rmod, **kw):
                self.calls.append((_name, _r.describe(args, kw)))
                with record_function(KERNEL + _name):
                    return _orig(*args, **kw)
            # The wrappers count their launches on the module attribute,
            # which is this function while it is patched in.
            wrapped.n_launches = getattr(orig, "n_launches", 0)
            setattr(mod, rmod.WRAPPER[1], wrapped)
            self._undo.append((mod, rmod.WRAPPER[1], orig, wrapped))
        return self

    def __exit__(self, *exc) -> bool:
        for mod, attr, orig, wrapped in reversed(self._undo):
            setattr(mod, attr, orig)
            if hasattr(orig, "n_launches"):
                orig.n_launches = wrapped.n_launches
        self._undo = []
        return False


def profile_window(window: Callable[[], None], before: Callable[[], None],
                   log=print):
    """Run ``window`` under the profiler; ``before`` resets what one try
    recorded.  Returns the profile that saw device events."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for i in range(TRIES):
        if i:
            time.sleep(PAUSE)
        before()
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                window()
            torch.cuda.synchronize()
        t = time.perf_counter()
        evs = prof.events()
        log(f"profile: {len(evs)} events, parsed in "
            f"{time.perf_counter() - t:.1f} s")
        if any(e.device_type == torch.autograd.DeviceType.CUDA for e in evs):
            return prof
        log(f"profile: try {i + 1} saw no device event; taking it again")
    raise RuntimeError(f"the profiler saw no device event in {TRIES} tries")


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def reduce(prof, span_names: set) -> dict:
    """What the readers use, from one profile (times in seconds)."""
    dev_t = torch.autograd.DeviceType
    evs = prof.events()
    win = [e for e in evs if e.name == WINDOW]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    device, hosts, launches, kernels = [], [], {}, []
    for e in evs:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == dev_t.CUDA:
            # The profiler mirrors host ranges onto the device's timeline
            # (gpu_user_annotation): those are not device work.
            if (b > w0 and a < w1
                    and not getattr(e, "is_user_annotation", False)
                    and e.name not in span_names
                    and not e.name.startswith("portbench.")):
                device.append(e)
        elif e.name.startswith(KERNEL):
            kernels.append((a, b, e.name[len(KERNEL):]))
        elif e.name.startswith("cu"):
            launches[e.id] = a
        elif e.name in span_names and b > w0 and a < w1:
            hosts.append((a, b, e.name))
    busy = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in device])
    busy_us = sum(b - a for a, b in busy)
    by_op: Dict[str, float] = {}
    for e in device:
        by_op[_short(e.name)] = by_op.get(_short(e.name), 0.0) + (
            e.time_range.end - e.time_range.start)
    # Kernel device time: the launch's host time inside a wrapper's range.
    kernels.sort()
    starts = [k[0] for k in kernels]
    per_kernel: Dict[str, List[float]] = {}
    for e in device:
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        t = launches.get(e.id)
        if t is None:
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and kernels[j][0] <= t <= kernels[j][1]:
            acc = per_kernel.setdefault(kernels[j][2], [0.0, 0])
            acc[0] += e.time_range.end - e.time_range.start
            acc[1] += 1
    # Idle time between device operations, by the innermost open span.
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle: Dict[str, List[float]] = {}
    hosts.sort(key=lambda h: (h[0], -h[1]))
    stack: List[Tuple[float, float, str]] = []
    hi = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while hi < len(hosts) and hosts[hi][0] <= mid:
            h = hosts[hi]
            while stack and stack[-1][1] < h[0]:
                stack.pop()
            stack.append(h)
            hi += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "harness"
        acc = idle.setdefault(name, [0.0, 0])
        acc[0] += b - a
        acc[1] += 1
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "n_device_events": len(device),
        "kernel_device": {k: (v[0] / 1e6, v[1])
                          for k, v in per_kernel.items()},
        "breakdown": {
            "device_ops": [[k, v / 1e6] for k, v in top_ops],
            "idle_gaps": [[f"{k} ({v[1]} gaps)", v[0] / 1e6]
                          for k, v in top_idle]},
    }


def roofline(calls: List[Tuple[str, dict]], kernel_device: dict,
             geom: dict) -> Dict[str, dict]:
    """Per kernel: least seconds over its calls, its device seconds, the
    share and what bounds it most."""
    from portbench import peaks
    from portbench import roofline as rl
    mods = roofline_modules()
    out: Dict[str, dict] = {}
    for name, desc in calls:
        least, by = peaks.least_seconds(mods[name].work(desc, geom))
        acc = out.setdefault(name, {"calls": 0, "least_s": 0.0, "by": {}})
        acc["calls"] += 1
        acc["least_s"] += least
        acc["by"][by] = acc["by"].get(by, 0.0) + least
    rl.forget()
    for name, acc in out.items():
        dev = kernel_device.get(name)
        acc["device_s"], acc["launches_seen"] = dev if dev else (0.0, 0)
        acc["bound_by"] = max(acc["by"], key=acc["by"].get)
        # A share needs every call's kernel seen on the device.
        acc["share"] = (100.0 * acc["least_s"] / acc["device_s"]
                        if dev and acc["launches_seen"] == acc["calls"]
                        and acc["device_s"] > 0 else None)
        if acc["share"] is None:
            print(f"roofline: {name}: {acc['calls']} calls, "
                  f"{acc['launches_seen']} device kernels attributed; no "
                  "share", file=sys.stderr)
    return out
