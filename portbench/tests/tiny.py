"""A tiny copy of the benchmark's cells, and one in-process run of a cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


def tiny_bench(dst: Path, copy_tree: bool = False) -> Path:
    """A manifest under ``dst`` whose cells are the benchmark's own at a
    tiny size: the same traffic keys, a 12,000-base reference, a few
    clients, every request checked.  ``copy_tree`` copies the harness
    too (for runs of ``run.py`` from ``dst``)."""
    if copy_tree:
        shutil.copytree(BENCH, dst / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic"):
        (dst / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["reference_bp"] = 12000
        c["file"] = c["file"].replace(".json", "-tiny.json")
        (dst / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        tr = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                        .read_text())
        tr.update(clients=4, check_every=1, warm_ticks=1)
        w["traffic"] += "-tiny"
        (dst / "portbench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(tr))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


def run_cell(root: Path, cell: str, *, seed: int = 11, trace: int = 0,
             device: str = "cpu", seconds: float = 0.2, control=None,
             capsys=None) -> dict:
    """One in-process run of ``cell``; returns the result line."""
    from portbench import harness
    # Other test files load JAX into this process; the check that the
    # benchmark's own process holds none is tested apart.
    with mock.patch.object(harness, "FORBIDDEN", ()):
        rc = harness.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace),
                           "--device", device], root=root, control=control)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
