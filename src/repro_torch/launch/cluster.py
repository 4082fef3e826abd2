"""Multi-process bootstrap, one process a card (port of
``repro.launch.cluster``).

Every process of a job runs the same entry point; this module derives
(coordinator, process_id, process_count) from the scheduler environment
(explicit REPRO_* variables, then SLURM, then a single host), calls
``torch.distributed.init_process_group`` and returns the process's role.
The match stack then reads the group: ``launch.mesh.make_row_mesh``
spans its ranks, each rank packs and scans only its own row shards, and
the ``ShardMerger`` joins cross-shard results with collectives over the
group, so every rank returns the same ``MatchResult`` (the SPMD
contract).

The backend is named, never guessed:

* ``"gloo"`` on the CPU (the reference's CPU collectives), or wherever
  the caller names it -- two ranks on one card must ask for it;
* ``"nccl"`` when each rank has a card of its own: NCCL refuses two
  ranks on one card (a duplicate GPU), so ``initialize`` raises before
  calling it when the ranks on a host outnumber its visible cards.

``backend=None`` takes the rule from ``device`` (``None``: the card).
Every process group gets a finite timeout: a rank that raises otherwise
leaves the others blocked in a collective forever.

Typical use::

    from repro_torch.launch import cluster
    info = cluster.initialize(device="cuda")    # no-op on one process
    mesh = make_row_mesh(S, devices=[f"cuda:{cluster.local_rank(info)}"]
                         * (S // info.process_count))

The module doubles as a runnable multi-process proof:
``python -m repro_torch.launch.cluster --demo`` spawns a 2-process gloo
job (4 CPU shards each -> the same 8-shard row mesh a single process
gets) plus a 1-process 8-shard baseline, runs the match workload --
threshold / forced-filter / IUPAC wildcard / top-k / best, then
``append_rows`` growth, tombstoning and ``compact()`` -- in every
process, and asserts the results are bit-identical across the two
layouts with flat per-process pack counters.  ``run_demo(...,
device="cuda")`` runs it on the card.  Workers are fresh interpreters
(``subprocess``), never forked: a parent may hold a CUDA context.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

DEFAULT_TIMEOUT_S = 300.0
BACKENDS = ("gloo", "nccl")
# Every rank's host name, gathered by ``initialize`` (empty without a group).
_HOSTS: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class HostInfo:
    coordinator: Optional[str]
    process_id: int
    process_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def detect_environment(env=None) -> HostInfo:
    """Resolve the process's role from the environment (no side effects).

    Priority: explicit REPRO_* vars > SLURM > single host.
    """
    env = env if env is not None else os.environ
    if "REPRO_COORDINATOR" in env:
        return HostInfo(
            coordinator=env["REPRO_COORDINATOR"],
            process_id=int(env.get("REPRO_PROCESS_ID", "0")),
            process_count=int(env.get("REPRO_NUM_PROCESSES", "1")),
        )
    if "SLURM_JOB_NUM_NODES" in env and int(env["SLURM_JOB_NUM_NODES"]) > 1:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        first = _first_slurm_node(nodelist)
        port = env.get("REPRO_PORT", "8476")
        return HostInfo(
            coordinator=f"{first}:{port}" if first else None,
            process_id=int(env.get("SLURM_PROCID", "0")),
            process_count=int(env["SLURM_JOB_NUM_NODES"]),
        )
    return HostInfo(coordinator=None, process_id=0, process_count=1)


def _first_slurm_node(nodelist: str) -> Optional[str]:
    """First hostname of a SLURM nodelist ('a[001-004],b02' -> 'a001')."""
    if not nodelist:
        return None
    head = nodelist.split(",")[0]
    if "[" not in head:
        return head
    prefix, rng = head.split("[", 1)
    rng = rng.rstrip("]")
    first = rng.split(",")[0].split("-")[0]
    return prefix + first


def process_count() -> int:
    """Processes in the group (1 without an initialised group)."""
    if not torch.distributed.is_initialized():
        return 1
    return torch.distributed.get_world_size()


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    if not torch.distributed.is_initialized():
        return 0
    return torch.distributed.get_rank()


def host_count() -> Optional[int]:
    """Distinct hosts of the group: 1 without one, the count ``initialize``
    gathered with one, ``None`` for a group ``initialize`` did not make."""
    if not torch.distributed.is_initialized():
        return 1
    return len(set(_HOSTS)) if _HOSTS else None


def local_rank(info: HostInfo, env=None) -> int:
    """This process's index among the processes of its host: SLURM's
    local id where SLURM placed it (one process a node), else its rank
    (the REPRO_* launcher starts every process on one host)."""
    env = env if env is not None else os.environ
    if "REPRO_COORDINATOR" not in env and "SLURM_LOCALID" in env:
        return int(env["SLURM_LOCALID"])
    return info.process_id


def pick_backend(info: HostInfo, backend: Optional[str] = None,
                 device: DeviceLike = None, env=None) -> str:
    """The backend rule: ``backend`` as named, else ``gloo`` for a CPU
    ``device`` and ``nccl`` for a card (``device=None`` means the card
    and raises without one).  NCCL raises when the ranks on this host
    outnumber its visible cards; two ranks share a card only under a
    ``gloo`` named by the caller."""
    if backend is None:
        backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        env = env if env is not None else os.environ
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        slurm = "REPRO_COORDINATOR" not in env and "SLURM_LOCALID" in env
        ranks = local_rank(info, env) + 1 if slurm else info.process_count
        if ranks > cards:
            raise RuntimeError(
                f"NCCL needs a card a rank: {ranks} ranks on this host, "
                f"{cards} visible CUDA cards.  NCCL refuses two ranks on "
                "one card (duplicate GPU); pass backend='gloo' by name to "
                "share a card")
    return backend


def initialize(info: Optional[HostInfo] = None, *,
               backend: Optional[str] = None, device: DeviceLike = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> HostInfo:
    """Join the process group when running multi-process; a no-op with
    one process.  Under NCCL the rank's card (its ``local_rank``) becomes
    the current device.  The ranks exchange their host names once here,
    so ``host_count`` needs no collective later."""
    global _HOSTS
    info = info or detect_environment()
    if info.process_count > 1 and info.coordinator:
        backend = pick_backend(info, backend, device)
        if backend == "nccl":
            torch.cuda.set_device(local_rank(info))
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{info.coordinator}",
            rank=info.process_id, world_size=info.process_count,
            timeout=datetime.timedelta(seconds=float(timeout_s)))
        hosts: List[Optional[str]] = [None] * info.process_count
        torch.distributed.all_gather_object(hosts, socket.gethostname())
        _HOSTS = tuple(hosts)
    return info


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _HOSTS
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _HOSTS = ()


# -- workers -------------------------------------------------------------------

def process_env(process_id: int, num_processes: int, coordinator: str,
                devices: Sequence[str], backend: str) -> Dict[str, str]:
    """Environment overrides for one process of a local job: its role
    through the REPRO_* variables ``detect_environment`` reads, its shard
    devices and its backend."""
    return {
        "REPRO_COORDINATOR": coordinator,
        "REPRO_PROCESS_ID": str(int(process_id)),
        "REPRO_NUM_PROCESSES": str(int(num_processes)),
        "REPRO_SHARD_DEVICES": ",".join(devices),
        "REPRO_BACKEND": backend,
    }


def cpu_process_env(process_id: int, num_processes: int, coordinator: str,
                    local_devices: int = 4) -> Dict[str, str]:
    """Environment overrides for one CPU process of a local gloo job
    with ``local_devices`` CPU shards."""
    return process_env(process_id, num_processes, coordinator,
                       ["cpu"] * int(local_devices), "gloo")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_worker(argv: Sequence[str], env_over: Dict[str, str],
                  log_dir: str, tag: str, threads: int):
    """A fresh interpreter running ``argv`` with ``env_over`` on top of
    this environment (the port's ``src`` first on ``PYTHONPATH``, and,
    unless the environment sets it, ``threads`` host threads for torch:
    workers that share a host would otherwise each take every core); its
    output goes to files, so a chatty worker cannot block on a pipe."""
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", str(threads))
    for k in ("REPRO_COORDINATOR", "REPRO_PROCESS_ID", "REPRO_NUM_PROCESSES",
              "REPRO_DEMO_OUT", "REPRO_SHARD_DEVICES", "REPRO_BACKEND"):
        env.pop(k, None)
    src = str(Path(__file__).resolve().parents[2])
    pp = env.get("PYTHONPATH")
    env["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
    env.update(env_over)
    out = open(os.path.join(log_dir, f"{tag}.out"), "w")
    err = open(os.path.join(log_dir, f"{tag}.err"), "w")
    try:
        return subprocess.Popen(list(argv), env=env, stdout=out, stderr=err,
                                text=True)
    finally:
        out.close()
        err.close()


def communicate(procs: Sequence[subprocess.Popen], tags: Sequence[str],
                log_dir: str, timeout: float) -> None:
    """Wait for every worker (its output is in ``log_dir/<tag>.out`` and
    ``.err``).

    When one exits non-zero, or the timeout passes, every worker is
    killed and ``RuntimeError`` names the failures with the end of their
    standard error: a rank left blocked in a collective never hangs the
    caller.
    """
    deadline = time.monotonic() + float(timeout)
    timed_out = False
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            break
        if time.monotonic() > deadline:
            timed_out = True
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    failures = []
    for p, tag in zip(procs, tags):
        if p.returncode != 0:
            with open(os.path.join(log_dir, f"{tag}.err")) as fh:
                failures.append(f"[{tag}] exit {p.returncode}\n"
                                f"{fh.read()[-4000:]}")
    if failures:
        raise RuntimeError(
            (f"workers timed out after {timeout} s" if timed_out
             else "workers failed") + ":\n" + "\n".join(failures))


def run_workers(argv: Sequence[str], envs: Sequence[Dict[str, str]],
                tags: Sequence[str], timeout: float, log_dir: str) -> None:
    """Spawn one fresh interpreter running ``argv`` an environment of
    ``envs``, all at once, the host's cores shared among them, and
    ``communicate`` with them."""
    threads = max(1, (os.cpu_count() or 1) // len(envs))
    procs = []
    try:
        for env, tag in zip(envs, tags):
            procs.append(_spawn_worker(argv, env, log_dir, tag, threads))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return communicate(procs, tags, log_dir, timeout)


# -- the demo (bit identity across layouts) -------------------------------------

DEMO_PLANTED = (3, 500, 1021)


def demo_inputs() -> dict:
    """The demo's seeded data, as numpy: the (1024, 64) fragments with a
    32-char needle planted, the rows appended later, a 6-char pattern
    whose top-k ties across ranks, three 32-char reads for the tensor
    cores (the needle first) and a row subset on rank 0's shards (every
    row ``r % 8 < 4``) holding two planted rows."""
    import numpy as np
    rng = np.random.default_rng(7)
    frags = rng.integers(0, 4, size=(1024, 64)).astype(np.uint8)
    pattern = np.array(frags[11, 10:42])          # 32-char planted needle
    for r in DEMO_PLANTED:
        frags[r, 5:37] = pattern
    extra = np.random.default_rng(11).integers(
        0, 4, size=(96, 64)).astype(np.uint8)
    extra[40, 20:52] = pattern
    iupac = "".join("ACGT"[c] for c in pattern)
    iupac = iupac[:2] + "N" + iupac[3:17] + "N" + iupac[18:]
    rows = np.arange(1024)
    subset = rows[rows % 8 < 4][::3]
    return {"frags": frags, "pattern": pattern, "extra": extra,
            "iupac": iupac, "short": np.array(frags[600, 20:26]),
            "batch": np.stack([pattern, frags[600, 20:52], frags[97, 0:32]]),
            "subset": np.union1d(subset, [3, 11])}


def demo_queries(match, data: dict) -> dict:
    """The demo's queries, built with ``match.MatchQuery`` (the port's,
    or the JAX package's for the tests' reference run)."""
    pattern = data["pattern"]
    thr = float(pattern.size)
    Q = match.MatchQuery
    return {
        "threshold_scan": Q.exact(pattern, reduction="threshold",
                                  threshold=thr, filter=False),
        "threshold_filtered": Q.exact(pattern, reduction="threshold",
                                      threshold=thr, filter=True),
        "iupac_wildcard": Q.iupac(data["iupac"], reduction="threshold",
                                  threshold=thr),
        "topk": Q.exact(pattern, reduction="topk", k=9),
        "best": Q.exact(pattern),
        "threshold_subset": Q.exact(data["batch"][:2], mode="batched",
                                    reduction="threshold",
                                    threshold=thr - 2, rows=data["subset"],
                                    backend="mxu"),
        "topk_ties": Q.exact(data["short"], reduction="topk", k=48,
                             backend="swar"),
        "topk_batched_mxu": Q.exact(data["batch"], mode="batched",
                                    reduction="topk", k=5, backend="mxu"),
    }


def snap(res) -> dict:
    """One result as JSON-ready lists (what crosses the merge layer)."""
    import numpy as np
    out = {
        "merge_path": res.merge_path,
        "collective_bytes": int(res.collective_bytes),
        "n_shards": int(res.n_shards),
        "backend": res.plan.backend,
        "strategy": res.plan.strategy,
        "best_locs": np.asarray(res.best_locs).tolist(),
        "best_scores": np.asarray(res.best_scores).tolist(),
    }
    if res.hits is not None:
        out["hits"] = np.asarray(res.hits).tolist()
    if res.topk_rows is not None:
        out["topk_rows"] = np.asarray(res.topk_rows).tolist()
        out["topk_scores"] = np.asarray(res.topk_scores).tolist()
    if res.survivor_rows is not None:
        out["n_survivors"] = int(np.asarray(res.survivor_rows).size)
    return out


def demo_stages(engine, compiled: dict, data: dict) -> dict:
    """Run the demo's stages on ``engine`` (either package's) over
    ``demo_inputs()``: every compiled query, then growth, tombstones and
    a compaction, each followed by its queries.  Raises if a planted
    needle goes missing."""
    corpus = engine.corpus
    results = {name: snap(c.run()) for name, c in compiled.items()}
    base_expect = {(3, 5), (500, 5), (1021, 5), (11, 10)}
    for stage in ("threshold_scan", "threshold_filtered"):
        got0 = {(int(r), int(l)) for r, l, _ in results[stage]["hits"]}
        if base_expect - got0:
            raise AssertionError(
                f"{stage}: planted rows missing: "
                f"{sorted(base_expect - got0)} (got {sorted(got0)})")

    # Growth: 96 appended rows with the needle planted in one of them
    # (logical row 1024 + 40); the splice must land it on the right
    # shard under the cyclic layout in every process.
    corpus.append_rows(data["extra"])
    results["threshold_after_append"] = snap(compiled["threshold_scan"].run())
    results["topk_after_append"] = snap(compiled["topk"].run())

    # Eviction: tombstone two planted rows (their hits must vanish),
    # then compact (ids above the dead rows shift down by two).
    corpus.tombstone([3, 500])
    results["threshold_after_tombstone"] = snap(
        compiled["threshold_scan"].run())
    corpus.compact()
    results["threshold_after_compact"] = snap(
        compiled["threshold_scan"].run())
    results["best_after_compact"] = snap(compiled["best"].run())

    expect = {(11 - 1, 10), (1021 - 2, 5), (1024 + 40 - 2, 20)}
    got = {(int(r), int(l)) for r, l, _ in
           results["threshold_after_compact"]["hits"]}
    if expect - got:
        raise AssertionError(
            f"planted rows missing from threshold hits: "
            f"{sorted(expect - got)} (got {sorted(got)})")
    return results


def _demo_workload(devices: Sequence[str]) -> dict:
    """The deterministic match workload every demo process runs.

    Same seed, same queries, same mutation sequence in every process --
    the SPMD contract.  ``devices`` are this process's shard devices.
    Returns a JSON-serializable dict of results plus the corpus pack
    counters, so layouts can be compared bit for bit.  Past one process
    it also records the refusals of per-row and batched SWAR queries and
    of a mesh the processes do not divide.
    """
    import numpy as np

    from repro_torch import match
    from repro_torch.launch.mesh import make_row_mesh
    from repro_torch.match.calibrate import bench_provenance

    world = process_count()
    n_shards = len(devices) * world
    mesh = make_row_mesh(n_shards, devices=devices) if n_shards > 1 else None
    data = demo_inputs()
    corpus = match.PackedCorpus(data["frags"], capacity=2048,
                                device=devices[0])
    # record_runtimes off even in one process: feedback re-pricing could
    # flip a later plan in the baseline but not in the (always-off)
    # multi-process run, breaking the like-for-like comparison.
    engine = match.MatchEngine(corpus, mesh=mesh, record_runtimes=False)
    refusals = {}
    if world > 1:
        per_row = np.array(data["frags"][:, 10:42])
        for mode, pats in (("per_row", per_row),
                           ("batched", per_row[:3])):
            q = match.MatchQuery.exact(pats, mode=mode, backend="swar")
            try:
                engine.compile(q).run()
            except NotImplementedError as e:
                refusals[mode] = str(e)
        try:
            make_row_mesh(n_shards + 1, devices=devices)
        except ValueError as e:
            refusals["indivisible_mesh"] = str(e)
    compiled = {name: engine.compile(q)
                for name, q in demo_queries(match, data).items()}
    results = demo_stages(engine, compiled, data)
    return {
        "process_count": world,
        "process_id": process_index(),
        "n_devices": len(devices),
        "n_shards": engine.n_shards,
        "local_shards": (list(mesh.local_shards) if mesh is not None
                         else [0]),
        "owners": ([mesh.owner(s) for s in range(mesh.size)]
                   if mesh is not None else [0]),
        "merge_path": engine.merger.merge_path,
        "collective_bytes": int(engine.merger.collective_bytes),
        "n_collectives": int(engine.merger.n_collectives),
        "pack_counts": {
            "swar": corpus.swar_pack_count,
            "onehot": corpus.onehot_pack_count,
            "host_total": corpus.host_pack_count,
            "row_updates": corpus.row_update_count,
            "signatures": engine.index.sig_pack_count,
        },
        "refusals": refusals,
        "provenance": {k: v for k, v in bench_provenance(
            device=devices[0]).items() if k in ("n_processes", "n_hosts")},
        "results": results,
    }


def _worker_main() -> None:
    """Entry point for one demo process (spawned by ``run_demo``)."""
    devices = os.environ["REPRO_SHARD_DEVICES"].split(",")
    info = initialize(backend=os.environ.get("REPRO_BACKEND"),
                      device=devices[0])
    try:
        summary = _demo_workload(devices)
    finally:
        shutdown()
    out = os.environ.get("REPRO_DEMO_OUT")
    if out:
        with open(out, "w") as fh:
            json.dump(summary, fh, indent=2, sort_keys=True)
    if info.is_coordinator:
        print(json.dumps({k: summary[k] for k in
                          ("process_count", "n_shards", "merge_path",
                           "collective_bytes", "pack_counts")}))


def demo_layout(n_processes: int, local_devices: int, device: DeviceLike,
                backend: Optional[str]):
    """(backend, each rank's shard devices, the baseline's) for a demo:
    the CPU under gloo; on the card by the backend rule -- rank ``r`` on
    ``cuda:r`` under NCCL, every rank on ``cuda:0`` under a named gloo."""
    info = HostInfo("localhost:0", 0, n_processes)
    backend = pick_backend(info, backend, device)
    if resolve_device(device).type == "cpu":
        ranks = [["cpu"] * local_devices for _ in range(n_processes)]
    elif backend == "nccl":
        ranks = [[f"cuda:{r}"] * local_devices for r in range(n_processes)]
    else:
        ranks = [["cuda:0"] * local_devices for _ in range(n_processes)]
    return backend, ranks, [d for r in ranks for d in r]


def run_demo(n_processes: int = 2, local_devices: int = 4, *,
             device: DeviceLike = None, backend: Optional[str] = None,
             timeout: float = 600.0) -> dict:
    """Run the bit-identity gate: ``n_processes`` ranks (``local_devices``
    shards each) against a single process with the same shard count and
    devices, spawned together.  ``device=None`` is the card (raising
    without one); ``run_cpu_demo`` names the CPU.

    Returns a summary dict with per-layout results and the list of
    mismatching stages (empty == gate passed).  Raises RuntimeError if
    any worker exits non-zero.
    """
    backend, ranks, single_devs = demo_layout(n_processes, local_devices,
                                              device, backend)
    coord = f"127.0.0.1:{free_port()}"
    tags = [f"proc{i}" for i in range(n_processes)] + ["baseline"]
    with tempfile.TemporaryDirectory(prefix="repro_torch_demo_") as tmp:
        outs = [os.path.join(tmp, f"{t}.json") for t in tags]
        envs = [process_env(i, n_processes, coord, ranks[i], backend)
                for i in range(n_processes)]
        # Single-process baseline: same shard count, no process group
        # (REPRO_COORDINATOR unset -> process_count == 1).
        envs.append({"REPRO_SHARD_DEVICES": ",".join(single_devs)})
        for env, out in zip(envs, outs):
            env["REPRO_DEMO_OUT"] = out
        run_workers([sys.executable, "-m", "repro_torch.launch.cluster",
                     "--worker"], envs, tags, timeout, log_dir=tmp)
        runs = []
        for out in outs:
            with open(out) as fh:
                runs.append(json.load(fh))
    multi, single = runs[:-1], runs[-1]

    mismatches: List[str] = []
    for i in range(1, n_processes):
        if multi[i]["results"] != multi[0]["results"]:
            mismatches.append(f"proc{i} diverged from proc0 (SPMD break)")
    for stage in single["results"]:
        if multi[0]["results"].get(stage) != single["results"][stage]:
            mismatches.append(stage)
    if single["pack_counts"] != multi[0]["pack_counts"]:
        mismatches.append(
            f"pack_counts: single={single['pack_counts']} "
            f"multi={multi[0]['pack_counts']}")
    return {
        "identical": not mismatches,
        "mismatches": mismatches,
        "backend": backend,
        "n_processes": n_processes,
        "local_devices": local_devices,
        "n_shards": multi[0]["n_shards"],
        "multiprocess": multi,
        "single": single,
    }


def run_cpu_demo(n_processes: int = 2, local_devices: int = 4,
                 timeout: float = 600.0) -> dict:
    """``run_demo`` on the CPU: gloo ranks of ``local_devices`` CPU
    shards each."""
    return run_demo(n_processes, local_devices, device="cpu",
                    timeout=timeout)


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true",
                    help="run one demo process (internal; spawned by "
                         "--demo)")
    ap.add_argument("--demo", action="store_true",
                    help="run the 2-process bit-identity demo")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--device", default="cpu",
                    help="'cpu' (gloo) or 'cuda' (the backend rule)")
    ap.add_argument("--backend", choices=BACKENDS, default=None)
    args = ap.parse_args(argv)
    if args.worker:
        _worker_main()
        return 0
    if args.demo:
        summary = run_demo(args.processes, args.local_devices,
                           device=args.device, backend=args.backend)
        print(json.dumps(
            {k: summary[k] for k in ("identical", "mismatches", "backend",
                                     "n_processes", "n_shards")},
            indent=2))
        return 0 if summary["identical"] else 1
    ap.print_help()
    return 2


if __name__ == "__main__":
    # Run the package's copy of this module, so the state ``initialize``
    # keeps (``_HOSTS``) is the one ``host_count`` reads from other modules.
    from repro_torch.launch.cluster import _main as _package_main
    raise SystemExit(_package_main())
