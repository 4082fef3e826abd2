"""One run of one cell: set-up, the measured window, the check, the line.

A closed loop drives the port: ``clients`` callers, each with one
request in flight, through ``MatchService.submit`` and ``tick`` over one
``MatchEngine`` on the default planner.  Each completed request is
replaced at once by the caller's next; a request's latency runs from its
``submit`` to the end of the tick that answered it.

Set-up makes every input from the seed, warms the shapes the window uses
(``warm_ticks`` of the cell's own traffic), and ends when the first timed
request is sent.  The window closes at the end of the first tick that
ends ``--seconds`` after it opened; rates are taken over all the work
and all the time of the window.  With ``--trace 1`` the same window, cut
to ``tracing.SECONDS``, runs with the program's spans on, its kernels
recorded, under the profiler.
After the window the peak device memory is read, the program's state is
freed, and the answers are held to the plain reference (``judge.py``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import generator, judge, manifest, tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LATE_S = 60.0


@dataclass
class Run:
    """Everything one run measured; the metric readers read this."""

    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    done: int = 0
    ticks: int = 0
    latencies_s: List[float] = field(default_factory=list)
    stats: Dict[str, float] = field(default_factory=dict)
    spans: List[Tuple[str, float, float, dict]] = field(default_factory=list)
    device_trace: Optional[dict] = None
    kernels: Dict[str, dict] = field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    memory_peak_bytes: int = 0


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_memory(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def counters(stats) -> Dict[str, float]:
    """The numeric counters of a ``ServiceStats``."""
    return {k: v for k, v in vars(stats).items() if not k.startswith("_")
            and isinstance(v, (int, float)) and not isinstance(v, bool)}


def stat_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if k in before}


def collect_spans(tracer) -> List[Tuple[str, float, float, dict]]:
    """(name, seconds, self seconds, attributes) of every span recorded."""
    out = []
    for sp in tracer.iter_spans():
        kids = sum(ch.duration_s for ch in sp.children)
        out.append((sp.name, sp.duration_s, max(0.0, sp.duration_s - kids),
                    dict(sp.attrs or {})))
    return out


def timed_window(run: Run, obs, body: Callable[[], None],
                 reset: Callable[[], None]) -> None:
    """Run ``body`` once, plainly or traced (spans, kernels, profiler).

    What set-up made stays alive through the window: it is collected once
    and frozen out of the collector's later passes."""
    gc.collect()
    gc.freeze()
    try:
        if run.trace:
            traced_window(run, obs, body, reset)
        else:
            reset()
            body()
    finally:
        gc.unfreeze()


def traced_window(run: Run, obs, body: Callable[[], None],
                  reset: Callable[[], None]) -> None:
    """The window with the program's spans on and its kernel calls
    recorded, under the profiler on a card."""
    rec = tracing.KernelRecorder()

    def before():
        reset()
        obs.tracer.clear()
        rec.calls.clear()

    obs.tracer.enabled = True
    with rec:
        if run.device.type == "cuda":
            prof = tracing.profile_window(body, before, log=log)
        else:
            # No device to profile: the spans and kernel calls alone.
            before()
            body()
    obs.tracer.enabled = False
    run.spans = collect_spans(obs.tracer)
    if run.device.type != "cuda":
        obs.tracer.clear()
        return
    names = {s[0] for s in run.spans}
    t = time.perf_counter()
    run.device_trace = tracing.reduce(prof, names)
    run.kernels = tracing.roofline(rec.calls,
                                   run.device_trace["kernel_device"],
                                   run.cell.config)
    log(f"trace reduced in {time.perf_counter() - t:.1f} s: "
        f"{run.device_trace['n_device_events']} device events, "
        f"{len(run.spans)} spans, kernels "
        + json.dumps({k: {kk: v[kk] for kk in ("calls", "launches_seen",
                                                "share", "bound_by")}
                      for k, v in run.kernels.items()}))
    obs.tracer.clear()
    del prof


def make_corpus(run: Run) -> np.ndarray:
    """The seeded reference, drawn on the device in one call, folded into
    its rows (host uint8)."""
    cfg = run.cell.config
    codes = generator.reference_codes(cfg, run.seed, run.device)
    rows = generator.fold(codes, cfg["fragment_chars"], cfg["read_chars"])
    return rows.cpu().numpy()


# -- closed loop of queries ---------------------------------------------------

def query_kwargs(traffic: dict) -> dict:
    kw = {"reduction": traffic["reduction"]}
    if traffic["reduction"] == "threshold":
        kw["threshold"] = float(traffic["threshold"])
    elif traffic["reduction"] != "best":
        raise ValueError(f"no check for reduction {traffic['reduction']!r}")
    return kw


def closed_queries(run: Run) -> dict:
    from repro_torch.match import MatchEngine, MatchQuery, MatchService
    from repro_torch.obs import Observability
    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    frags = make_corpus(run)
    obs = Observability(spans=False, profiler=run.trace)
    engine = MatchEngine(frags, obs=obs, device=dev)
    svc = MatchService(engine)
    kw = query_kwargs(tr)
    clients = int(tr["clients"])

    def submit(req):
        if req["masks"] is None:
            return svc.submit(req["codes"], **kw)
        return svc.submit(MatchQuery.from_masks(req["masks"], **kw))

    warm = generator.Requests(tr, cfg, frags, run.seed, stream=1)
    n_warm = 0
    for _ in range(int(tr["warm_ticks"])):
        tickets = [submit(warm.get(n_warm + c)) for c in range(clients)]
        n_warm += clients
        svc.tick()
        for t in tickets:
            if not t.done or t.error is not None:
                raise RuntimeError(f"warm-up request failed: {t.error!r}")
    sync(dev)
    reqs = generator.Requests(tr, cfg, frags, run.seed, stream=0)
    state: Dict[str, object] = {"next": 0}

    def reset():
        # A retaken profile sends fresh requests: numbering goes on.
        state.update(kept={}, lat=[], failed=0, ticks=0,
                     first=state["next"])

    def body():
        kept, lat = state["kept"], state["lat"]
        inflight: Dict[int, Tuple[object, int, float]] = {}

        def send(c):
            i = state["next"]
            state["next"] = i + 1
            t_s = time.perf_counter()
            inflight[c] = (submit(reqs.get(i)), i, t_s)

        t_begin = time.perf_counter()
        state["t_begin"] = t_begin
        for c in range(clients):
            send(c)
        while True:
            svc.tick()
            state["ticks"] += 1
            t = time.perf_counter()
            for c, (tk, i, t_s) in list(inflight.items()):
                if not tk.done:
                    continue
                del inflight[c]
                lat.append(t - t_s)
                if tk.error is not None:
                    state["failed"] += 1
                    log(f"request {i} failed: {tk.error!r}")
                elif i == state["first"] or reqs.sampled(i):
                    kept[i] = tk.result
            if t - t_begin >= run.seconds and not inflight:
                break
            if inflight and t - t_begin >= run.seconds + LATE_S:
                # Never answered: counted as failed, not waited for.
                state["failed"] += len(inflight)
                log(f"{len(inflight)} requests unanswered "
                    f"{LATE_S} s after the window closed")
                break
            if t - t_begin < run.seconds:
                for c in range(clients):
                    if c not in inflight:
                        send(c)
        sync(dev)
        state["t_end"] = time.perf_counter()

    before = counters(svc.stats)
    run.setup_s = time.perf_counter() - run.t0
    timed_window(run, obs, body, reset)
    after = counters(svc.stats)
    run.memory_peak_bytes = peak_memory(dev)
    run.window_s = state["t_end"] - state["t_begin"]
    run.attempted = state["next"] - state["first"]
    run.failed = state["failed"]
    run.done = run.attempted - run.failed
    run.ticks = state["ticks"]
    run.latencies_s = state["lat"]
    run.stats = stat_delta(before, after)
    kept = state["kept"]
    answers = {i: judge.Answer.of(res) for i, res in kept.items()}
    del svc, engine, kept, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"frags": frags, "reqs": reqs, "answers": answers}


# -- the result ---------------------------------------------------------------

def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(run: Run) -> dict:
    if run.device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(run.device),
                "count": run.cell.chips,
                "memory_peak_bytes": run.memory_peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if run.trace and run.device_trace is not None:
        info["busy_s"] = run.device_trace["busy_s"]
        info["window_s"] = run.device_trace["window_s"]
    return info


def is_correct(run: Run) -> bool:
    return run.failed == 0 and all(v <= lim for v, lim in
                                   run.checks.values())


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the benchmark) or cpu (the harness's own "
                         "tests, at a tiny size)")
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None,
         root: Optional[Path] = None,
         control: Optional[Callable[[Run, dict], None]] = None) -> int:
    """Run one cell once; print the result line.  ``control`` (the
    control's and the fault tests' hook) may replace the program's
    answers before they are judged."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    root = Path.cwd() if root is None else root
    cell = manifest.cell(root, args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < cell.chips):
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    seconds = (min(args.seconds, tracing.SECONDS) if args.trace
               else args.seconds)
    run = Run(cell=cell, seed=args.seed, seconds=seconds,
              trace=bool(args.trace), device=dev, t0=t0)
    out = closed_queries(run)
    if control is not None:
        control(run, out)
    lat = np.asarray(run.latencies_s) * 1e3
    log(f"window {run.window_s:.3f} s, {run.ticks} ticks, {run.done} done; "
        f"latency ms p50 {np.percentile(lat, 50):.2f} p95 "
        f"{np.percentile(lat, 95):.2f} max {lat.max():.2f}; counters "
        + json.dumps({k: v for k, v in run.stats.items() if v}))
    t = time.perf_counter()
    run.checks = judge.check(run, out)
    log(f"check took {time.perf_counter() - t:.1f} s")
    metrics = {}
    for m in (cell.per_layer if run.trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 3
    correct = is_correct(run)
    for name, (v, lim) in run.checks.items():
        log(f"check {name} {v} limit {lim}")
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics,
            "device": device_info(run)}
    if run.trace and run.device_trace is not None:
        line["breakdown"] = run.device_trace["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in run.checks.items()}
    print(json.dumps(line), flush=True)
    return 0
